"""Tiered node-feature storage of the port, as ``repro.feats.store``.

Where the ``[N, dim]`` node-feature table lives decides the memory ceiling
of the stack: with the table on the card, feature scale, not graph scale,
is the binding limit. Three tiers, each behind one protocol:

* ``DeviceFeatureStore``: the whole table is one device tensor and a
  batch's input rows are an ``index_select`` on the device. The baseline
  the other tiers match bit for bit.

* ``HostFeatureStore``: the table lives in per-ntype host tables
  (``ntype_ptr`` slices), page-locked on a card. A batch's rows are
  gathered on the host into the next pinned staging buffer of a small
  ring and copied without blocking on the store's own CUDA stream; only
  those rows cross the bus. Called from the loader's producer, the copy
  of batch k+1 overlaps batch k's compute.

* ``CachedFeatureStore``: the host tier fronted by a fixed-budget hot-row
  cache on the device, one slot slab ``[max(S, 1), dim]`` partitioned per
  ntype (``slot_ptr``). Hits, misses and CLOCK eviction are decided on the
  host from the sampled ids (NumPy, the reference's code unchanged, so a
  seed stream gives the reference's cache trajectory bit for bit). Per
  batch with misses, the shipped rows (inserted misses first, then the
  overflow) go to the card padded to a power-of-two bucket, an
  ``index_copy_`` writes the inserted ones into their slots in place
  (unique slots, no atomics; pad and overflow rows are sliced off on the
  host, as the reference's ``mode="drop"`` drops them), and the batch's
  rows are read from the slab and the shipped rows. A fully hot batch
  does no host feature work and ships no row (only its slot indices).

The tiers move bits and never compute them, so all three return the same
rows bit for bit.

Stream discipline on a card: every tier runs its device work on the
store's own stream (the device tier after waiting for the caller's
stream, where its ids were made) and records an event after it. The
returned tensor carries that event; ``ready`` (called by
``feats.gather_input``) makes the consumer's current stream wait on it
and ``record_stream``s the tensor there, so a captured executor's copy
into its static buffers never reads rows that have not landed, and the
allocator never hands the memory out while the consumer still reads it.
A staging buffer is written again only after its event has completed.
On the CPU (``device="cpu"``) there is no pinning, no stream and no
event: an explicit branch on the store's device.

Observability: every gather runs in a ``feature_gather`` span; the
``feature_cache_{hits,misses,evictions,overflows}`` counters,
``feature_bytes_moved`` (gauge, per gather), ``feature_bytes_moved_total``
and ``feature_host_gathers`` (counters, labelled ``store=<kind>``),
``feature_gather_traces`` and the ``feature_cache_hit_rate`` /
``feature_device_bytes`` gauges (set by ``stats``) go through
``repro_torch.obs`` under the reference's names. The integer attributes
stay the source of truth.

``trace_count`` keeps the port's meaning of the executors' counters (keys
seen): it counts each ``(miss bucket, n_idx)`` shape of the cached tier's
device work the first time it is seen, and the hot read's ``n_idx``;
``_prewarm`` marks every bucket a batch of ``n_idx`` rows can produce up
front, so the count stays flat once each batch size has been seen.

Threading: a store is single-writer: one loader producer (or the driver
thread) calls ``gather``; ``stats`` / ``device_bytes`` / ``host_rows``
are safe anywhere.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import HeteroGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.layout import pow2ceil

# pinned staging slots per host-tier store: one per batch the loader holds
# ahead plus the one being consumed
STAGING_RING = 3


def split_budget(graph: HeteroGraph, budget: int,
                 weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Split ``budget`` cache rows across ntypes: proportional to
    ``weights`` (default: ntype populations), capped at each ntype's table
    size, with the remainder redistributed to uncapped types by weight.

    Returns per-ntype slot counts ``[T]`` summing to
    ``min(budget, num_nodes)``; a type can end up with zero slots (all its
    rows then ship uncached)."""
    sizes = np.diff(graph.ntype_ptr).astype(np.int64)
    budget = int(min(max(0, budget), sizes.sum()))
    w = np.asarray(weights if weights is not None else sizes, np.float64)
    if w.shape != sizes.shape:
        raise ValueError(f"need {len(sizes)} weights, got {w.shape}")
    w = np.maximum(w, 0.0)
    slots = np.zeros(len(sizes), dtype=np.int64)
    remaining = budget
    free = w > 0
    # iterate: proportional assignment, cap at table size, redistribute
    while remaining > 0 and free.any() and w[free].sum() > 0:
        share = w * free / w[free].sum() * remaining
        add = np.minimum(np.floor(share).astype(np.int64), sizes - slots)
        if add.sum() == 0:  # round the largest fractional shares upward
            order = np.argsort(-share)
            for t in order:
                if remaining <= 0:
                    break
                if free[t] and slots[t] < sizes[t]:
                    slots[t] += 1
                    remaining -= 1
            break
        slots += add
        remaining -= int(add.sum())
        free = free & (slots < sizes)
    return slots.astype(np.int64)


def ready(feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``feats`` made safe to read on the current stream: each tensor a
    store produced on its own stream is waited for there
    (``wait_event``) and recorded as in use by it (``record_stream``).
    Tensors without an event (the CPU, raw tables) pass unchanged."""
    for t in feats.values():
        ev = getattr(t, "_feature_event", None)
        if ev is not None:
            cur = torch.cuda.current_stream(t.device)
            cur.wait_event(ev)
            t.record_stream(cur)
    return feats


class _Staging:
    """One pinned staging slot: a row buffer, an int64 index buffer and the
    event after the last copy that read them."""

    __slots__ = ("rows", "index", "event")

    def __init__(self):
        self.rows: Optional[torch.Tensor] = None
        self.index: Optional[torch.Tensor] = None
        self.event = None


class FeatureStore:
    """The protocol and the host-side machinery shared by the tiers.

    * ``gather(ids, step=None) -> {"feature": [n, dim]}``: a batch's input
      rows on the store's device (on a card, behind the store's event);
    * ``host_rows(ids) -> np [n, dim]``: the rows read on the host, no
      device work and no state change;
    * ``full_table() -> [N, dim]``: the whole table on the device
      (full-graph paths only; it defeats tiering by design);
    * ``device_bytes()``: the device bytes the store holds.

    ``ids`` may be a NumPy array or a tensor; the host tiers need them on
    the host (a device tensor is copied back, which synchronizes)."""

    kind = "base"

    def __init__(self, feats, graph: HeteroGraph, device=None):
        host = np.asarray(feats)
        if host.ndim != 2 or host.shape[0] != graph.num_nodes:
            raise ValueError(
                f"feature table must be [num_nodes={graph.num_nodes}, dim]; "
                f"got {host.shape}")
        self.graph = graph
        self.dim = int(host.shape[1])
        self.dtype = host.dtype
        self.itemsize = int(host.dtype.itemsize)
        self.num_rows = int(host.shape[0])
        self._host = np.ascontiguousarray(host)
        self.torch_dtype = torch.from_numpy(self._host[:0]).dtype
        self.device = resolve_device(device)
        self.on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card \
            else None
        self._ring = [_Staging() for _ in range(STAGING_RING)]
        self._ring_pos = 0
        self.bytes_moved = 0
        self.rows_moved = 0
        self.host_gathers = 0   # batches that touched the host tables

    # -- protocol -------------------------------------------------------
    def gather(self, ids, step: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def host_rows(self, ids) -> np.ndarray:
        """Host gather of global rows (no device work)."""
        return self._host[_host_ids(ids)]

    def full_table(self) -> torch.Tensor:
        """The entire table on the device: full-graph paths only."""
        return torch.from_numpy(self._host).to(self.device)

    def device_bytes(self) -> int:
        return 0

    @property
    def table_bytes(self) -> int:
        """Footprint of the full table: the bound tiering must beat."""
        return self.num_rows * self.dim * self.itemsize

    def stats(self) -> dict:
        return {"kind": self.kind,
                "rows_moved": self.rows_moved,
                "bytes_moved": self.bytes_moved,
                "host_gathers": self.host_gathers,
                "device_bytes": self.device_bytes(),
                "table_bytes": self.table_bytes}

    # -- shared accounting ---------------------------------------------
    def _account_moved(self, rows: int) -> None:
        nbytes = rows * self.dim * self.itemsize
        self.rows_moved += rows
        self.bytes_moved += nbytes
        m = obs.metrics()
        m.gauge("feature_bytes_moved", store=self.kind).set(nbytes)
        m.counter("feature_bytes_moved_total", store=self.kind).inc(nbytes)

    # -- device transfer -----------------------------------------------
    def _slot(self, rows: int, index: int) -> _Staging:
        """The next staging slot, once the copy that last read it has
        completed, grown (to powers of two) to ``rows`` rows and
        ``index`` indices."""
        slot = self._ring[self._ring_pos]
        self._ring_pos = (self._ring_pos + 1) % len(self._ring)
        if slot.event is not None:
            slot.event.synchronize()
        if slot.rows is None or slot.rows.shape[0] < rows:
            slot.rows = torch.empty(
                (pow2ceil(rows), self.dim),
                dtype=self.torch_dtype, pin_memory=True)
        if slot.index is None or slot.index.shape[0] < index:
            slot.index = torch.empty(pow2ceil(index), dtype=torch.int64,
                                     pin_memory=True)
        return slot

    def _ship(self, m: int, fill, index: Optional[np.ndarray]):
        """``(rows, index)`` on the device: ``m`` rows that ``fill(buf)``
        writes into a ``[m, dim]`` host buffer (none when ``m`` is 0) and
        the int64 ``index`` vector (or ``None``). On a card both go
        through the next pinned staging slot and are copied without
        blocking on the store's stream (call inside
        ``torch.cuda.stream(self.stream)``), and the slot is returned for
        ``_done``; on the CPU the slot is ``None``."""
        if not self.on_card:
            rows = None
            if m:
                buf = np.empty((m, self.dim), dtype=self.dtype)
                fill(buf)
                rows = torch.from_numpy(buf)
            return (rows, None if index is None else
                    torch.from_numpy(np.ascontiguousarray(index, np.int64)),
                    None)
        k = 0 if index is None else int(index.shape[0])
        slot = self._slot(m, k)
        rows = dev_index = None
        if m:
            fill(slot.rows[:m].numpy())
            rows = slot.rows[:m].to(self.device, non_blocking=True)
        if index is not None:
            slot.index[:k].numpy()[:] = index
            dev_index = slot.index[:k].to(self.device, non_blocking=True)
        return rows, dev_index, slot

    def _done(self, out: torch.Tensor, slot: Optional[_Staging] = None
              ) -> torch.Tensor:
        """Record the store's event after the batch's device work and
        attach it to ``out`` (and the staging slot that fed it); the CPU
        needs neither."""
        if not self.on_card:
            return out
        ev = torch.cuda.Event()
        ev.record(self.stream)
        if slot is not None:
            slot.event = ev
        out._feature_event = ev
        return out


def _host_ids(ids) -> np.ndarray:
    """``ids`` as a host array (a device tensor is copied back)."""
    if isinstance(ids, torch.Tensor):
        return ids.cpu().numpy()
    return np.asarray(ids)


class DeviceFeatureStore(FeatureStore):
    """The whole table on the device, gathered there."""

    kind = "device"

    def __init__(self, feats, graph: HeteroGraph, device=None):
        super().__init__(feats, graph, device)
        self.table = torch.from_numpy(self._host).to(self.device)
        # the one-time upload is the whole table
        self._account_moved(self.num_rows)

    def gather(self, ids, step=None) -> Dict[str, torch.Tensor]:
        with obs.span("feature_gather", store=self.kind, step=step):
            if not self.on_card:
                return {"feature": self.table.index_select(
                    0, torch.as_tensor(ids).long())}
            # the ids were made on the caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                if isinstance(ids, torch.Tensor) and ids.is_cuda:
                    ids.record_stream(self.stream)
                    dev_ids = ids
                else:
                    dev_ids = torch.from_numpy(np.ascontiguousarray(
                        _host_ids(ids))).to(self.device)
                out = self.table.index_select(0, dev_ids)
                return {"feature": self._done(out)}

    def full_table(self) -> torch.Tensor:
        return self.table

    def device_bytes(self) -> int:
        return self.table_bytes


class HostFeatureStore(FeatureStore):
    """Host-resident tier: per-ntype host tables, rows shipped per batch.

    ``tables[t]`` holds ntype ``t``'s rows (global rows
    ``ntype_ptr[t]:ntype_ptr[t+1]``) as one contiguous array, page-locked
    once at build on a card (its staging buffers are pinned once and
    reused). The gather translates global ids to (ntype, local row)
    through ``ntype_ptr`` and writes the batch's rows straight into the
    pinned staging slot; one copy ships them."""

    kind = "host"

    def __init__(self, feats, graph: HeteroGraph, device=None):
        super().__init__(feats, graph, device)
        p = graph.ntype_ptr
        self._pinned: List[torch.Tensor] = []
        self.tables: List[np.ndarray] = []
        for t in range(graph.num_ntypes):
            tab = np.ascontiguousarray(self._host[int(p[t]):int(p[t + 1])])
            if self.on_card:
                pinned = torch.from_numpy(tab).pin_memory()
                self._pinned.append(pinned)
                tab = pinned.numpy()
            self.tables.append(tab)

    def _rows_into(self, ids: np.ndarray, out: np.ndarray) -> None:
        ptr = self.graph.ntype_ptr.astype(np.int64)
        t = np.searchsorted(ptr, ids, side="right") - 1
        for tt in np.unique(t):
            m = t == tt
            out[m] = self.tables[int(tt)][ids[m] - ptr[int(tt)]]

    def host_rows(self, ids) -> np.ndarray:
        ids = _host_ids(ids).astype(np.int64)
        out = np.empty((ids.shape[0], self.dim), dtype=self.dtype)
        self._rows_into(ids, out)
        return out

    def gather(self, ids, step=None) -> Dict[str, torch.Tensor]:
        ids = _host_ids(ids).astype(np.int64)
        with obs.span("feature_gather", store=self.kind, step=step):
            n = int(ids.shape[0])
            if self.on_card:
                with torch.cuda.stream(self.stream):
                    rows, _, slot = self._ship(
                        n, lambda buf: self._rows_into(ids, buf), None)
                    out = self._done(rows, slot)
            else:
                out = torch.from_numpy(self.host_rows(ids))
            self.host_gathers += 1
            self._account_moved(n)
            obs.metrics().counter("feature_host_gathers",
                                  store=self.kind).inc()
            return {"feature": out}


class CachedFeatureStore(HostFeatureStore):
    """Host tier fronted by a fixed-budget hot-row cache on the device.

    Device state is the slot slab ``slots [max(S, 1), dim]``, partitioned
    per ntype by ``slot_ptr``; host state is the index translation
    (``_gid2slot``, ``_slot_gid``), the CLOCK reference bits ``_ref`` and
    the per-ntype hands ``_hand``. Per batch:

    1. distinct requested rows split into hits and misses; CLOCK picks a
       victim slot for each miss within its ntype's partition, never a
       slot this batch reads. Misses without a victim overflow: they ship
       for this batch but are not inserted.
    2. the shipped rows (inserted misses, then overflow) go to the card
       padded to a power-of-two bucket; ``index_copy_`` writes the
       inserted ones into their slots in place, and the batch reads each
       row from its slot or, for the overflow, from the shipped rows.
    3. a fully hot batch reads the slab only: no host rows, no row copy,
       no slab write.

    Eviction is decided on the host from the sampled ids, so a fixed seed
    stream gives a reproducible trajectory, the reference's bit for bit.
    """

    kind = "cached"

    def __init__(self, feats, graph: HeteroGraph, budget: int,
                 split: Optional[Sequence[int]] = None,
                 miss_bucket_min: int = 8, device=None):
        super().__init__(feats, graph, device)
        per_ntype = (np.asarray(split, np.int64) if split is not None
                     else split_budget(graph, budget))
        if per_ntype.shape != (graph.num_ntypes,):
            raise ValueError(
                f"split needs {graph.num_ntypes} entries, got {per_ntype}")
        sizes = np.diff(graph.ntype_ptr)
        if (per_ntype > sizes).any():
            raise ValueError("per-ntype slots exceed the ntype's table size")
        self.slot_ptr = np.zeros(graph.num_ntypes + 1, dtype=np.int64)
        np.cumsum(per_ntype, out=self.slot_ptr[1:])
        self.capacity = int(self.slot_ptr[-1])
        self.miss_bucket_min = int(miss_bucket_min)
        # device state: the slab (zeros until rows are inserted)
        self.slots = torch.zeros(
            (max(self.capacity, 1), self.dim),
            dtype=self.torch_dtype, device=self.device)
        # host state: index translation + CLOCK metadata
        self._slot_gid = np.full(max(self.capacity, 1), -1, dtype=np.int64)
        self._ref = np.zeros(max(self.capacity, 1), dtype=bool)
        self._hand = np.zeros(graph.num_ntypes, dtype=np.int64)
        self._gid2slot = np.full(self.num_rows, -1, dtype=np.int32)
        # counters (distinct requested rows per batch)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.overflows = 0
        self.trace_count = 0   # device-work shapes seen
        self._shapes: set = set()
        self._warmed: set = set()   # n_idx whose shapes are marked

    # -- device-work shapes --------------------------------------------
    def _mark(self, key) -> None:
        if key not in self._shapes:
            self._shapes.add(key)
            self.trace_count += 1
            obs.metrics().counter("feature_gather_traces").inc()

    def _prewarm(self, n_idx: int) -> None:
        """Mark every shape a batch of ``n_idx`` input rows can give: the
        hot read plus each pow2 miss bucket up to ``n_idx`` (miss counts
        shrink as the cache warms)."""
        if n_idx in self._warmed:
            return
        self._warmed.add(n_idx)
        self._mark(("hot", n_idx))
        mb = self.miss_bucket_min
        cap = max(pow2ceil(max(n_idx, 1)), self.miss_bucket_min)
        while mb <= cap:
            self._mark((mb, n_idx))
            mb *= 2

    # -- CLOCK eviction (host, one vectorized sweep per ntype) ---------
    def _pick_victims(self, t: int, k: int, pinned: np.ndarray) -> np.ndarray:
        """Up to ``k`` evictable slots in ntype ``t``'s partition, batch-
        CLOCK order: starting at the hand, unpinned-and-unreferenced slots
        first; if those run short the sweep dips into referenced slots
        (their second chance: the sweep clears their bits). Pinned slots
        (resident rows this batch reads) are never victims; fewer than
        ``k`` returned means the remainder overflows."""
        lo, hi = int(self.slot_ptr[t]), int(self.slot_ptr[t + 1])
        n = hi - lo
        if n == 0 or k <= 0:
            return np.empty(0, dtype=np.int64)
        order = lo + (int(self._hand[t]) + np.arange(n)) % n
        free = order[~pinned[order]]
        unref = free[~self._ref[free]]
        if unref.shape[0] >= k:
            victims = unref[:k]
        else:
            refd = free[self._ref[free]]
            self._ref[refd] = False      # swept past: second chance spent
            victims = np.concatenate([unref, refd])[:k]
        self._hand[t] = (int(self._hand[t]) + victims.shape[0]) % n
        return victims

    # -- the batch gather ----------------------------------------------
    def gather(self, ids, step=None) -> Dict[str, torch.Tensor]:
        ids = _host_ids(ids)
        with obs.span("feature_gather", store=self.kind, step=step):
            if not self.on_card:
                return {"feature": self._gather_impl(ids)}
            with torch.cuda.stream(self.stream):
                return {"feature": self._gather_impl(ids)}

    def _gather_impl(self, ids: np.ndarray) -> torch.Tensor:
        ptr = self.graph.ntype_ptr.astype(np.int64)
        uniq, inv = np.unique(ids.astype(np.int64), return_inverse=True)
        m = obs.metrics()
        self._prewarm(int(ids.shape[0]))

        slot_of = self._gid2slot[uniq].astype(np.int64)
        resident = slot_of >= 0
        hit_slots = slot_of[resident]
        miss_gids = uniq[~resident]
        self._ref[hit_slots] = True
        n_hit = int(resident.sum())
        n_miss = int(miss_gids.shape[0])
        self.hits += n_hit
        m.counter("feature_cache_hits").inc(n_hit)
        self.misses += n_miss
        m.counter("feature_cache_misses").inc(n_miss)

        S = int(self.slots.shape[0])
        if n_miss == 0:
            # fully hot: a read of the slab, no host feature work
            self._mark(("hot", int(ids.shape[0])))
            _, idx, slot = self._ship(0, None, slot_of[inv])
            return self._done(self.slots.index_select(0, idx), slot)

        # victim assignment: one batched CLOCK sweep per ntype, in
        # ascending (ntype, gid) order; resident rows this batch reads are
        # pinned
        pinned = np.zeros(S, dtype=bool)
        pinned[hit_slots] = True
        t_of = np.searchsorted(ptr, miss_gids, side="right") - 1
        ins_gids: List[np.ndarray] = []
        ins_slots: List[np.ndarray] = []
        over_gids: List[np.ndarray] = []
        n_evict = 0
        for t in np.unique(t_of):
            gids_t = miss_gids[t_of == t]     # sorted (uniq is sorted)
            victims = self._pick_victims(int(t), gids_t.shape[0], pinned)
            k = victims.shape[0]
            take = gids_t[:k]
            old = self._slot_gid[victims]
            live = old >= 0
            self._gid2slot[old[live]] = -1
            n_evict += int(live.sum())
            self._slot_gid[victims] = take
            self._gid2slot[take] = victims
            self._ref[victims] = True
            pinned[victims] = True            # this batch now reads them
            ins_gids.append(take)
            ins_slots.append(victims)
            if k < gids_t.shape[0]:           # overflow: ship uninserted
                over_gids.append(gids_t[k:])
        self.evictions += n_evict
        m.counter("feature_cache_evictions").inc(n_evict)

        inserted = np.concatenate(ins_gids) if ins_gids else \
            np.empty(0, dtype=np.int64)
        inserted_slots = np.concatenate(ins_slots) if ins_slots else \
            np.empty(0, dtype=np.int64)
        overflow = np.concatenate(over_gids) if over_gids else \
            np.empty(0, dtype=np.int64)
        n_over = int(overflow.shape[0])
        self.overflows += n_over
        if n_over:
            m.counter("feature_cache_overflows").inc(n_over)

        # per-distinct-row read source: the cache slot for hits and freshly
        # inserted misses, S + k for the k-th shipped overflow row
        uniq_read = self._gid2slot[uniq].astype(np.int64)
        if n_over:
            # shipped order: inserted misses first, overflow rows after
            pos = np.searchsorted(uniq, overflow)
            uniq_read[pos] = S + inserted.shape[0] + np.arange(n_over)
        shipped = np.concatenate([inserted, overflow])
        n_ins, n_ship = int(inserted.shape[0]), int(shipped.shape[0])

        mb = max(pow2ceil(n_ship), self.miss_bucket_min)
        self._mark((mb, int(ids.shape[0])))

        def fill(buf):
            self._rows_into(shipped, buf[:n_ship])
            buf[n_ship:] = 0

        # one index vector: the batch's read sources, then the slots
        read = uniq_read[inv]
        rows, index, slot = self._ship(
            mb, fill, np.concatenate([read, inserted_slots]))
        self.host_gathers += 1
        m.counter("feature_host_gathers", store=self.kind).inc()
        self._account_moved(n_ship)

        n = int(read.shape[0])
        idx, ins = index[:n], index[n:]
        # pad and overflow rows are not written (the reference's drop)
        self.slots.index_copy_(0, ins, rows[:n_ins])
        # the read source is concat(slots, shipped)[idx]: two [n, dim]
        # gathers and a select, never a copy of the slab
        from_slab = self.slots.index_select(0, idx.clamp(max=S - 1))
        from_ship = rows.index_select(0, (idx - S).clamp(0, mb - 1))
        out = torch.where((idx < S)[:, None], from_slab, from_ship)
        return self._done(out, slot)

    # -- reporting ------------------------------------------------------
    def device_bytes(self) -> int:
        return int(self.slots.shape[0]) * self.dim * self.itemsize

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        out = super().stats()
        out.update(hits=self.hits, misses=self.misses,
                   evictions=self.evictions, overflows=self.overflows,
                   hit_rate=self.hit_rate, capacity=self.capacity,
                   trace_count=self.trace_count,
                   slot_ptr=self.slot_ptr.tolist())
        obs.metrics().gauge("feature_cache_hit_rate").set(self.hit_rate)
        obs.metrics().gauge("feature_device_bytes").set(self.device_bytes())
        return out


def make_feature_store(feats, graph: HeteroGraph, kind: str = "device",
                       budget: Optional[int] = None,
                       split: Optional[Sequence[int]] = None,
                       device=None) -> FeatureStore:
    """Build a feature store on ``device`` (``None``: the CUDA card).
    ``kind`` in {"device", "host", "cached"}; ``budget`` (cached only) is
    the device hot-row count, default one quarter of the table; ``split``
    overrides the per-ntype slot split (e.g. the measured decision from
    ``tune.feature_budget``)."""
    if kind == "device":
        return DeviceFeatureStore(feats, graph, device)
    if kind == "host":
        return HostFeatureStore(feats, graph, device)
    if kind == "cached":
        if budget is None:
            budget = max(1, graph.num_nodes // 4)
        return CachedFeatureStore(feats, graph, budget=budget, split=split,
                                  device=device)
    raise ValueError(f"feature_store={kind!r}; pick device/host/cached")
