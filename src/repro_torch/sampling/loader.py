"""Prefetching mini-batch loader for sampled RGNN blocks.

The counterpart of ``repro.sampling.loader``. In host mode a background
thread pulls seed batches from a deterministic stream, runs the fanout
sampler, builds every block's ``KernelLayouts`` in NumPy and copies the
tensors to the device without blocking (pinned host buffers), so
sampling, layout build and the host-to-device copies overlap the
consumer's forward passes. The consumer only dequeues device-ready
``MiniBatch`` bundles. In device mode (a sampler with
``sample_minibatch``, i.e. a ``DeviceSampler``) there is no thread: every
build only enqueues device work, so the loader dispatches batch k+1
before handing batch k to the consumer, after the sampler's ``settle``
has checked batch k's counts against its buckets.

Failure contract (as in the reference): an exception anywhere in the
producer is re-raised in the consumer on its next ``__next__``, after the
batches already built, with the worker thread stopped and joined first.

Training streams (``EpochSeedStream``) expose ``epoch_of(step)``: the
loader then passes the epoch to the sampler, so the same seed batch in a
later epoch draws a fresh neighborhood. ``start_step`` starts the stream
mid-way (a resumed run replays the exact remaining batches).

Serving traffic repeats, so the loader layers the reference's two LRU
caches over that pipeline: a **KernelLayouts cache** keyed by block
signature (a content hash of the block graph plus the tile and bucket
config; host mode, where it also skips the layouts' host-to-device copies:
the cached layouts are the device ones) and a **sampled-block cache** keyed
by ``(seeds, fanout, layout config, epoch)``, whose hit hands back the
cached device ``MiniBatch`` (re-stamped with the current step) without
sampling, layout build or copy. ``cache_stats`` / ``build_stats`` report
the hits, misses and rates; every hit, miss and eviction is mirrored into
the obs registry (``loader_cache_{hits,misses,evictions}``, gauge
``loader_cache_hit_rate``, labelled ``cache=<name>``).

Telemetry (``repro_torch.obs``): each host build runs inside a ``sample``
and a ``layout`` span, on the producer thread's own track (the switchboard
is process-global, so the thread sees the scope the driver opened).

The producer thread never runs a model: executors capture CUDA graphs on
the consumer's thread only, and they capture in ``thread_local`` mode, so
the producer's allocations and copies cannot invalidate a capture.

A loader given a ``feature_store`` (``repro_torch.feats``) attaches each
batch's input rows as ``mb.feats``, gathered by the producer (the store
is single-writer: only the producer calls ``gather``), so the rows of
batch k+1 are gathered and copied while the consumer runs batch k. In
device mode the rows are gathered when a batch is handed out, after
``settle``: a batch that outgrew its buckets is rebuilt first, and the
rows gathered are those of the batch the consumer runs. Batches stay in
the block cache without ``feats``: every occurrence gathers again, so the
cached tier's state moves forward with the stream.

``partition=`` names the graph shard a loader samples from (a
``repro_torch.dist.GraphPartition``, a ``(partition, shard)`` pair or any
hashable id), as the reference's: it joins every block and layout cache
key, so shards sharing a process never replay each other's entries.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import queue
import threading
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import codegen
from repro_torch.core.graph import GraphTensors, HeteroGraph, to_device
from repro_torch.kernels.layout import pow2ceil
from repro_torch.sampling.bucketing import pad_block_graph, pad_index
from repro_torch.sampling.sampler import BlockSequence

# batches built ahead of the consumer (by the producer thread, or
# dispatched on the device)
PREFETCH_DEPTH = 2


class _EndOfStream(Exception):
    """A callable seed source returned ``None``: the stream has ended."""


class SourceNotReady(Exception):
    """Raised by a callable seed source, in device mode, while the loader
    holds a batch (``pending``): the next batch's seeds are not there yet,
    so the loader hands out what it holds instead of waiting for them (the
    serving runtime's plan queue)."""


class LRUCache:
    """Minimal LRU map with hit/miss/eviction counters, the port's copy of
    ``repro.sampling.loader.LRUCache`` (single-writer: each loader's
    producer owns its caches, so no locking).

    ``name`` labels the cache in the obs metrics registry: every hit, miss
    and eviction is mirrored to ``loader_cache_{hits,misses,evictions}``
    with a ``cache=<name>`` label, and the ``loader_cache_hit_rate`` gauge
    follows every lookup (the integer attributes stay the source of
    truth)."""

    def __init__(self, maxsize: int = 64, name: str = "lru"):
        if maxsize <= 0:
            raise ValueError("LRUCache needs a positive maxsize")
        self.maxsize = maxsize
        self.name = name
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        try:
            v = self._d.pop(key)
        except KeyError:
            self.misses += 1
            obs.metrics().counter("loader_cache_misses",
                                  cache=self.name).inc()
            self._mirror_rate()
            return None
        self._d[key] = v          # re-insert: most recently used
        self.hits += 1
        obs.metrics().counter("loader_cache_hits", cache=self.name).inc()
        self._mirror_rate()
        return v

    def _mirror_rate(self) -> None:
        obs.metrics().gauge("loader_cache_hit_rate",
                            cache=self.name).set(self.hit_rate)

    def put(self, key, value) -> None:
        self._d.pop(key, None)
        self._d[key] = value
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.evictions += 1
            obs.metrics().counter("loader_cache_evictions",
                                  cache=self.name).inc()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._d),
                "hit_rate": self.hit_rate}


def block_signature(hg: HeteroGraph, tile: int, node_block: int,
                    bucket: bool) -> tuple:
    """Content key for a block graph's kernel layouts: two blocks with equal
    signatures produce identical ``KernelLayouts`` (every layout product is
    a pure function of the edge arrays, node types and tile config)."""
    h = hashlib.blake2b(digest_size=16)
    for arr in (hg.src, hg.dst, hg.etype, hg.node_type):
        h.update(np.ascontiguousarray(arr).tobytes())
    return (hg.num_nodes, hg.num_ntypes, hg.num_etypes,
            tile, node_block, bool(bucket), h.digest())


class SeedStream:
    """Deterministic seed-node request stream: step -> seed ID batch.

    The port's copy of ``repro.sampling.loader.SeedStream``: the same
    seeds for the same arguments (the same numpy generator calls in the
    same order), drawn with replacement. ``batch(step)`` is a pure function
    of ``(seed, step)``.

    ``num_distinct`` models repeating traffic: steps wrap onto ``step %
    num_distinct``, so the stream cycles over a fixed set of seed batches
    (what the block and layout caches and the executors' graphs pay off
    on). ``zipf_alpha`` draws seeds from a Zipf law over the population:
    popularity rank ``r`` (0-based) has probability proportional to ``(r +
    1) ** -alpha``, and a seed-keyed permutation maps ranks onto ids.
    ``ids`` restricts the population to an explicit id set (e.g. a train
    split) instead of ``[0, num_nodes)``.
    """

    def __init__(self, num_nodes: Optional[int] = None,
                 batch_size: int = 32, seed: int = 0,
                 num_distinct: Optional[int] = None,
                 zipf_alpha: Optional[float] = None,
                 ids: Optional[np.ndarray] = None):
        if ids is not None:
            self.ids = np.asarray(ids, dtype=np.int32)
            if self.ids.ndim != 1 or self.ids.size == 0:
                raise ValueError("ids must be a non-empty 1-D int array")
            self.num_nodes = int(self.ids.size)
        else:
            if num_nodes is None:
                raise ValueError("need num_nodes or ids")
            self.ids = None
            self.num_nodes = int(num_nodes)
        self.batch_size = batch_size
        self.seed = seed
        self.num_distinct = num_distinct
        self.zipf_alpha = zipf_alpha
        self._cdf = self._rank2idx = None
        if zipf_alpha is not None:
            if zipf_alpha <= 0:
                raise ValueError("zipf_alpha must be positive")
            p = np.arange(1, self.num_nodes + 1,
                          dtype=np.float64) ** -float(zipf_alpha)
            self._cdf = np.cumsum(p / p.sum())
            # popularity rank -> population index, keyed off the stream
            # seed so the hot rows are not simply the lowest ids
            self._rank2idx = np.random.default_rng(
                (self.seed, 0x5eed)).permutation(
                self.num_nodes).astype(np.int64)

    def batch(self, step: int) -> np.ndarray:
        if self.num_distinct:
            step = step % self.num_distinct
        rng = np.random.default_rng((self.seed, step))
        if self._cdf is None:
            # the uniform stream's draw (the dtype is part of the
            # generator's contract)
            draw = rng.integers(0, self.num_nodes, size=self.batch_size,
                                dtype=np.int32)
        else:
            # inverse-CDF sampling of popularity ranks, mapped to indices
            u = rng.random(self.batch_size)
            ranks = np.searchsorted(self._cdf, u, side="right")
            draw = self._rank2idx[np.minimum(ranks, self.num_nodes - 1)]
        out = draw if self.ids is None else self.ids[draw]
        return out.astype(np.int32)


class EpochSeedStream:
    """Epoch-aware training seed stream: shuffled, without replacement.

    The port's own copy of ``repro.sampling.loader.EpochSeedStream``
    (array-identical batches): each epoch is an independent permutation of
    ``ids`` (rng keyed by ``(seed, epoch)``) cut into fixed-size batches;
    ``drop_last`` keeps the batch shape fixed. ``batch(step)`` is a pure
    function of ``(seed, step)``, so a trainer resumed mid-epoch replays
    the exact remaining batches of that epoch. ``epoch_of(step)`` is the
    loader's epoch hook.
    """

    def __init__(self, ids: np.ndarray, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.ids = np.asarray(ids, dtype=np.int32)
        if self.ids.ndim != 1 or self.ids.size == 0:
            raise ValueError("ids must be a non-empty 1-D int array")
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = min(batch_size, self.ids.size)
        self.seed = seed
        self.drop_last = drop_last
        n = self.ids.size
        self.batches_per_epoch = (n // self.batch_size if drop_last
                                  else -(-n // self.batch_size))
        self._perm_cache = (-1, None)   # (epoch, permutation) memo

    @property
    def num_ids(self) -> int:
        return int(self.ids.size)

    def epoch_of(self, step: int) -> int:
        return step // self.batches_per_epoch

    def steps_for(self, epochs: int) -> int:
        return epochs * self.batches_per_epoch

    def batch(self, step: int) -> np.ndarray:
        epoch, k = divmod(step, self.batches_per_epoch)
        if self._perm_cache[0] != epoch:
            self._perm_cache = (epoch, np.random.default_rng(
                (self.seed, epoch)).permutation(self.ids.size))
        perm = self._perm_cache[1]
        lo = k * self.batch_size
        return self.ids[perm[lo:lo + self.batch_size]]


@dataclasses.dataclass
class MiniBatch:
    """Device-ready bundle for one sampled batch: per-hop graph tensors and
    kernel layouts, plus the gather maps that chain hops and restore the
    requested seed order."""

    step: int
    seq: BlockSequence
    tensors: List[GraphTensors]
    layouts: List[codegen.KernelLayouts]
    input_ids: torch.Tensor          # [n_input] global IDs feeding hop 0
    dst_locals: List[torch.Tensor]   # per hop: local rows of the out frontier
    seed_perm: torch.Tensor          # final-frontier row of each seed
    # ``input_ids`` on the host, where the host pipeline built them (the
    # host feature tiers read rows there without a device round trip)
    host_input_ids: Optional[np.ndarray] = None
    # the batch's input features (``{"feature": [n_input, dim]}``),
    # attached by a loader given a feature store; ``None``: the consumer
    # gathers them (``feats.gather_input``)
    feats: Optional[dict] = None

    @property
    def num_hops(self) -> int:
        return len(self.tensors)


def build_minibatch(seq: BlockSequence, step: int = 0, tile: int = 128,
                    node_block: int = 128, bucket: bool = False,
                    layout_cache: Optional[LRUCache] = None,
                    layout_scope=None, shape_floors=None,
                    device="cpu") -> MiniBatch:
    """Host-side assembly of a ``MiniBatch`` from a sampled ``BlockSequence``,
    its tensors copied to ``device`` without blocking.

    With ``bucket=True`` each block graph, its kernel layouts and every
    gather-index vector are padded to power-of-two buckets (numerically
    inert: pad nodes/edges only feed pad rows, which the hop-chaining
    gathers never read). ``shape_floors`` (a ``bucketing.ShapeFloors``)
    pads each hop up to the largest bucket seen for this seed count.

    ``layout_cache`` (an ``LRUCache``) memoizes each hop's ``KernelLayouts``
    on ``device`` by block signature, skipping the NumPy layout passes and
    their copies for blocks seen before; ``layout_scope`` (any hashable)
    namespaces its entries, as in the reference.
    """
    graphs = raw = [b.graph for b in seq.blocks]
    input_ids = seq.input_node_ids
    dst_locals = [b.dst_local for b in seq.blocks]
    key = int(seq.seed_perm.shape[0])
    if bucket:
        if shape_floors is not None:
            graphs = [shape_floors.pad_graph(key, i, g)
                      for i, g in enumerate(graphs)]
        else:
            graphs = [pad_block_graph(g) for g in graphs]
        input_ids = pad_index(input_ids, graphs[0].num_nodes)
        # hop l's output rows become hop l+1's (padded) node-feature rows;
        # the last hop only needs to cover the seed gather
        dst_locals = [
            pad_index(d, graphs[i + 1].num_nodes if i + 1 < len(graphs)
                      else (shape_floors.pad_tail(key, d.shape[0])
                            if shape_floors is not None
                            else pow2ceil(d.shape[0])))
            for i, d in enumerate(dst_locals)
        ]

    def layouts_for(hop: int, g: HeteroGraph) -> codegen.KernelLayouts:
        # the floors reach into the layout build, so the cache key carries
        # their values: a pre-growth entry never replays stale shapes. A
        # padded graph is a function of its real block and its padded
        # sizes, so the key hashes the real block (a small fraction of a
        # padded one at serving's floors) beside those sizes
        rf = (shape_floors.layout_floors(key, hop)
              if bucket and shape_floors is not None else None)

        def build():
            return codegen.build_kernel_layouts(
                g, tile=tile, node_block=node_block, bucket=bucket,
                row_floors=rf).to(device, non_blocking=True)

        if layout_cache is None:
            return build()
        ck = (layout_scope,
              block_signature(raw[hop], tile, node_block, bucket),
              (g.num_nodes, g.num_edges, g.num_unique),
              None if rf is None else (hop, tuple(sorted(rf.items()))))
        kl = layout_cache.get(ck)
        if kl is None:
            kl = build()
            layout_cache.put(ck, kl)
        return kl

    def dev(a: np.ndarray) -> torch.Tensor:
        return to_device(torch.from_numpy(np.ascontiguousarray(a)), device,
                         non_blocking=True)

    return MiniBatch(
        step=step,
        seq=seq,
        tensors=[g.to_tensors().to(device, non_blocking=True)
                 for g in graphs],
        layouts=[layouts_for(i, g) for i, g in enumerate(graphs)],
        input_ids=dev(input_ids),
        dst_locals=[dev(d) for d in dst_locals],
        seed_perm=dev(seq.seed_perm),
        host_input_ids=np.asarray(input_ids),
    )


def _partition_token(partition):
    """Stable hashable identity of a graph partition (or shard thereof):
    ``None`` (unpartitioned), a ``GraphPartition`` (its shard bounds), a
    ``(GraphPartition, shard_index)`` pair, or any hashable token the
    caller chooses."""
    if partition is None:
        return None
    if isinstance(partition, tuple) and len(partition) == 2:
        return (_partition_token(partition[0]), partition[1])
    bounds = getattr(partition, "bounds", None)
    if bounds is not None:
        return ("part", int(getattr(partition, "num_parts", 0)),
                np.asarray(bounds).tobytes())
    return partition


class MiniBatchLoader:
    """Prefetch of sampled mini-batches: a background thread (host mode) or
    batches dispatched ahead on the device (device mode).

    ``sampler`` is a ``FanoutSampler`` (host mode: sample, then
    ``build_minibatch`` with the layout arguments, copied to ``device``) or
    a ``DeviceSampler`` (anything with ``sample_minibatch`` and ``settle``;
    device mode, ``mode == "device"``: the sampler builds whole
    mini-batches on its own device; ``device_builds`` counts them,
    ``host_builds`` the host mode's).
    ``seed_source`` is a ``SeedStream``, an ``EpochSeedStream`` or any
    ``step -> np.ndarray`` callable; a callable that returns ``None`` ends
    the stream (the serving runtime's drain). Iteration yields
    ``MiniBatch`` in step order from ``start_step``; with ``num_batches``
    set the loader raises ``StopIteration`` after that many. ``depth``
    batches are prefetched. A source with ``epoch_of(step)``
    keys the sampler by epoch. ``close()`` stops and joins the worker.

    ``cache_blocks`` / ``cache_layouts`` give the two LRU capacities (0
    disables either), as in the reference. ``feature_store`` (a
    ``repro_torch.feats`` store) attaches every batch's input rows as
    ``mb.feats``. ``shape_floors`` (a ``bucketing.ShapeFloors``, host mode
    only: the device sampler keeps its own buckets) pads every block up to
    the largest bucket seen for its seed count, as serving's ladder rungs
    need. The sampled-block cache is keyed
    by ``(seeds, fanout, layout config, epoch)``: for serving streams (no
    epoch) a repeated seed batch returns the device ``MiniBatch`` built at
    its first occurrence, re-stamped with the current step; for training
    streams the epoch is part of the key (and re-keys the sampler), so a
    later epoch draws a fresh neighborhood. The layout cache is host mode
    only (the device sampler builds its own layouts). ``partition`` (see
    ``_partition_token``) joins both caches' keys.
    """

    _SENTINEL = object()

    def __init__(
        self,
        sampler,
        seed_source: Union[SeedStream, EpochSeedStream,
                           Callable[[int], np.ndarray]],
        *,
        tile: int = 128,
        node_block: int = 128,
        bucket: bool = False,
        start_step: int = 0,
        num_batches: Optional[int] = None,
        cache_blocks: int = 0,
        cache_layouts: int = 0,
        feature_store=None,
        shape_floors=None,
        partition=None,
        depth: int = PREFETCH_DEPTH,
        device="cpu",
    ):
        self.sampler = sampler
        # loaders of different shards of one graph may share a process
        # (and a layout cache): the token keeps their entries apart
        self._partition_key = _partition_token(partition)
        self.shape_floors = shape_floors
        self._depth = max(1, depth)
        # single-writer: only this loader's producer calls its gather
        self.feature_store = feature_store
        self._seeds_for = (seed_source.batch
                           if hasattr(seed_source, "batch") else seed_source)
        # training streams expose epoch_of(step); serving streams don't
        self._epoch_of = getattr(seed_source, "epoch_of", None)
        self._start_step = start_step
        self.tile = tile
        self.node_block = node_block
        self.bucket = bucket
        self.num_batches = num_batches
        self.device = torch.device(device)
        self.block_cache = LRUCache(cache_blocks, name="block_cache") \
            if cache_blocks else None
        self.layout_cache = LRUCache(cache_layouts, name="layout_cache") \
            if cache_layouts else None
        self._fanout_key = tuple(
            tuple(int(x) for x in f) for f in sampler.fanouts)
        self.mode = ("device" if hasattr(sampler, "sample_minibatch")
                     else "host")
        self.host_builds = 0     # batches built by the host NumPy pipeline
        self.device_builds = 0   # batches built by the device sampler
        self._done = False
        self._thread = None
        if self.mode == "device":
            # threadless prefetch: a deque of already-dispatched batches,
            # each with its block-cache key (None: not cached)
            self._next_step = start_step
            self._pending: collections.deque = collections.deque()
            self._in_hand = 0
            return
        self.q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="MiniBatchLoader-producer")
        self._thread.start()

    @property
    def pending(self) -> int:
        """Batches built (device mode: dispatched, or about to be handed
        out) and not yet handed out."""
        return len(self._pending) + self._in_hand \
            if self.mode == "device" else self.q.qsize()

    def cache_stats(self) -> dict:
        """Hit/miss counters of both loader caches (empty if disabled)."""
        out = {}
        if self.block_cache is not None:
            out["block_cache"] = self.block_cache.stats()
        if self.layout_cache is not None:
            out["layout_cache"] = self.layout_cache.stats()
        return out

    def build_stats(self) -> dict:
        """Which pipeline built the batches the caches did not serve, and
        the caches' hit rates."""
        out = {"mode": self.mode, "host_builds": self.host_builds,
               "device_builds": self.device_builds}
        if self.block_cache is not None:
            out["block_cache_hit_rate"] = self.block_cache.hit_rate
        if self.layout_cache is not None:
            out["layout_cache_hit_rate"] = self.layout_cache.hit_rate
        return out

    def _attach_feats(self, mb: MiniBatch) -> MiniBatch:
        """``mb`` with its input rows gathered through the store. The
        device tier reads the ids where they are (on the device, no
        synchronize); the host tiers need them on the host, which the
        host pipeline kept (a device-sampled batch copies them back: the
        cost of those tiers)."""
        store = self.feature_store
        if store is None:
            return mb
        ids = mb.input_ids
        if store.kind != "device" and mb.host_input_ids is not None:
            ids = mb.host_input_ids
        return dataclasses.replace(mb, feats=store.gather(ids, step=mb.step))

    def _cache_key(self, seeds: np.ndarray, epoch) -> tuple:
        return (np.asarray(seeds).tobytes(), self._fanout_key, self.tile,
                self.node_block, self.bucket, epoch, self._partition_key)

    def _cached(self, step: int, seeds, epoch):
        """``(cached batch re-stamped with step or None, cache key)``."""
        if self.block_cache is None:
            return None, None
        key = self._cache_key(seeds, epoch)
        mb = self.block_cache.get(key)
        if mb is not None:
            mb = dataclasses.replace(mb, step=step)
        return mb, key

    def _build(self, step: int) -> MiniBatch:
        seeds = self._seeds_for(step)
        if seeds is None:
            raise _EndOfStream
        epoch = self._epoch_of(step) if self._epoch_of is not None else None
        mb, key = self._cached(step, seeds, epoch)
        if mb is not None:
            return self._attach_feats(mb)
        self.host_builds += 1
        with obs.span("sample", step=step):
            seq = self.sampler.sample(seeds, batch_index=step, epoch=epoch)
        with obs.span("layout", step=step):
            mb = build_minibatch(seq, step=step, tile=self.tile,
                                 node_block=self.node_block,
                                 bucket=self.bucket,
                                 layout_cache=self.layout_cache,
                                 layout_scope=self._partition_key,
                                 shape_floors=self.shape_floors,
                                 device=self.device)
        if key is not None:
            self.block_cache.put(key, mb)   # cached without feats
        return self._attach_feats(mb)

    def _build_device(self, step: int):
        seeds = self._seeds_for(step)
        if seeds is None:
            raise _EndOfStream
        epoch = self._epoch_of(step) if self._epoch_of is not None else None
        mb, key = self._cached(step, seeds, epoch)
        if mb is not None:
            return mb, None
        self.device_builds += 1
        mb = self.sampler.sample_minibatch(seeds, batch_index=step,
                                           epoch=epoch, step=step)
        if key is not None:
            self.block_cache.put(key, mb)   # cached without feats
        return mb, key

    def _pump(self) -> None:
        """Dispatch device builds until the prefetch window is full: each
        build only enqueues device work, so batch k+1 is sampled while the
        consumer runs batch k."""
        while len(self._pending) < self._depth:
            if (self.num_batches is not None and
                    self._next_step - self._start_step >= self.num_batches):
                return
            try:
                self._pending.append(self._build_device(self._next_step))
            except _EndOfStream:
                self.num_batches = self._next_step - self._start_step
                return
            except SourceNotReady:
                if not self.pending:
                    raise RuntimeError("the seed source was not ready and "
                                       "the loader holds no batch") from None
                return
            self._next_step += 1

    def _fill(self):
        step = self._start_step
        item = None
        while not self._stop.is_set():
            if item is None:
                if (self.num_batches is not None
                        and step - self._start_step >= self.num_batches):
                    item = self._SENTINEL
                else:
                    try:
                        item = self._build(step)
                    except _EndOfStream:
                        item = self._SENTINEL
                    except BaseException as e:  # surface in the consumer
                        item = e
                    step += 1
            try:
                self.q.put(item, timeout=0.5)
            except queue.Full:
                continue
            if item is self._SENTINEL or isinstance(item, BaseException):
                break
            item = None

    def __iter__(self):
        return self

    def __next__(self) -> MiniBatch:
        if self._done:
            raise StopIteration
        if self.mode == "device":
            self._pump()
            if not self._pending:
                self._done = True
                raise StopIteration
            # checked against its counts (rebuilt if it overflowed); a
            # cached batch was settled before, so this only reads its
            # finished counts
            mb, key = self._pending.popleft()
            settled = self.sampler.settle(mb)
            if key is not None and settled is not mb \
                    and key in self.block_cache:
                self.block_cache.put(key, settled)   # the rebuilt batch
            settled = self._attach_feats(settled)
            # dispatch the next batch before the caller runs; the batch
            # in hand counts as held (``pending``) meanwhile
            self._in_hand = 1
            try:
                self._pump()
            finally:
                self._in_hand = 0
            return settled
        while True:
            try:
                item = self.q.get(timeout=0.5)
                break
            except queue.Empty:
                # a worker that died without enqueuing anything must
                # surface as an error, not as an iterator that blocks
                if not self._thread.is_alive():
                    self._done = True
                    raise RuntimeError(
                        "MiniBatchLoader worker thread died without "
                        "reporting a batch or an exception") from None
        if item is self._SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            self._stop.set()
            self._thread.join(timeout=2)
            raise item
        return item

    def close(self):
        if self.mode == "device":
            self._done = True
            self._pending.clear()
            return
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
