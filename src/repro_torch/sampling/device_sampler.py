"""Device fanout sampler: sample -> layout -> execute with no host NumPy and
no device-to-host synchronization in the steady-state loop.

The port's counterpart of ``repro.sampling.device_sampler``.
``DeviceSampler`` reproduces ``FanoutSampler``'s exact selection (both rank
candidate in-edges by the shared counter-based keys of
``sampler.edge_sample_keys`` over the shared destination-sorted candidate
positions, keyed by the same ``hop_base_key(seed, batch_index, hop,
epoch)``), but evaluates it as fixed-shape torch programs over the device
CSC (``HeteroGraph.to_device_graph``), K9 keying the candidates, and builds
each block's ``GraphTensors`` and ``KernelLayouts`` on the device
(``kernels/sampling_ops.py``). The ``MiniBatch`` it emits is a drop-in for
the host loader's: same types, same hop chaining, same seed-order
restoration.

Shape discipline: every per-hop program is built for a static (frontier
bucket, fanout, count-bucket) tuple and cached under it. Stage A
(selection) is shaped by the frontier bucket alone; the stage-B
(compaction + layout) bucket is *predicted*, never read back: each
``(hop, seed bucket, fanout)`` signature starts from its analytic worst
case (``fp * sum(k_eff)`` edges, capped by the graph, always correct), and
a non-blocking drain of past count vectors shrinks the guess once to one
power-of-two step above the observed counts. Stage A's 3-vector of counts
is copied into pinned host memory without blocking, behind a CUDA event;
``drain`` reads only counts whose event has completed, so the steady-state
loop issues no device-to-host synchronization: ``count_syncs`` /
``bucket_overflows`` / ``bucket_shrinks`` pin that, alongside
``trace_count`` / ``cache_hits`` / ``cache_misses`` for program reuse. A
shrunken guess that a later batch outgrows is detected by the same drain
(``bucket_overflows``) and reset to the worst case. Until counts are
drained, batches run at the worst-case buckets.

A batch that outgrew its buckets is truncated. The reference serves it so;
here ``settle`` checks every batch's own counts before it is used (the
loader calls it when it hands a batch out) and samples an overflowing
batch again at the worst-case buckets (``overflow_rebuilds``). The 2x
headroom does not make overflows rare on power-law graphs at small
batches: at aifb with 32 seeds a batch with a hub seed has 4-7x the nodes
and edges of the first one.

``trace_count`` counts the first use of each static bucket tuple, that is,
program-cache misses: torch runs eagerly, so there is no trace to count,
but a new tuple is what a retrace would be in the reference. The
``sampler_traces`` counter of ``repro_torch.obs`` mirrors it, and every
hop's selection and layout build run inside ``sample_device`` /
``layout_device`` spans (they time the launches, with no synchronize).

Prefetch overlap needs no thread: every stage only enqueues device work,
so the loader dispatches batch k+1's sampling before the consumer runs
batch k. On the CPU, where the work runs as it is dispatched, counts are
ready at once.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import HeteroGraph, to_device
from repro_torch.kernels import sampling_ops as SO
from repro_torch.kernels.layout import pow2ceil
from repro_torch.sampling.loader import MiniBatch
from repro_torch.sampling.sampler import (FanoutSpec, hop_base_key,
                                          normalize_fanout)


@dataclasses.dataclass
class DeviceBlock:
    """Metadata summary of one device-sampled hop (execution order).

    The counts are the static bucket *capacities* (upper bounds on the real
    counts): the sync-free loop never reads the exact counts back, so the
    summary reports what was allocated, not what was filled. Real entries
    are identified in the tensors themselves by the sentinel pads."""

    num_src: int      # node bucket capacity (>= real nodes in the block)
    num_edges: int    # edge bucket capacity (>= real sampled edges)
    num_dst: int      # output-frontier capacity (exact for the seed hop)
    node_ids: torch.Tensor   # [n_pad] sorted global ids, sentinel N pads


@dataclasses.dataclass
class DeviceBlockSequence:
    """Device-path stand-in for ``sampler.BlockSequence``: carries the seed
    bookkeeping the consumers need (label slicing, per-hop summaries)
    without host ``Block``/``HeteroGraph`` objects."""

    blocks: List[DeviceBlock]
    seeds: np.ndarray       # requested seed IDs, order and dupes preserved
    num_nodes: int          # full-graph N (the pad sentinel)
    batch_index: int = 0    # the stream position it was sampled at
    epoch: Optional[int] = None
    # per hop: (buckets used, stage-A counts, event of their copy or None)
    checks: list = dataclasses.field(default_factory=list)

    @property
    def num_hops(self) -> int:
        return len(self.blocks)

    def slice_labels(self, labels: np.ndarray) -> np.ndarray:
        """Labels aligned with the block forward's output (one row per
        requested seed, in request order), as the host's."""
        return np.asarray(labels)[self.seeds]

    def describe(self) -> str:
        lines = [f"DeviceBlockSequence(seeds={len(self.seeds)})"]
        for i, b in enumerate(self.blocks):
            lines.append(f"  hop {i}: {b.num_src} nodes -> {b.num_dst} dst, "
                         f"{b.num_edges} edges (device)")
        return "\n".join(lines)


class DeviceSampler:
    """Fanout sampling and layout build over a device CSC.

    ``sample_minibatch`` is the whole device pipeline for one batch; the
    loader's device mode calls it in place of ``FanoutSampler.sample`` +
    ``build_minibatch``. ``device`` is where the CSC lives and the work
    runs (the CPU runs the same programs with K9's plain version).
    """

    def __init__(self, hg: HeteroGraph, fanouts: Sequence[FanoutSpec],
                 seed: int = 0, *, tile: int = 32, node_block: int = 32,
                 device):
        if not fanouts:
            raise ValueError("need at least one hop fanout")
        if tile & (tile - 1):
            raise ValueError("device sampling needs a power-of-two tile")
        if hg.num_edges == 0:
            raise ValueError("device sampling needs a graph with edges")
        self.hg = hg
        self.device = torch.device(device)
        self.dg = hg.to_device_graph(self.device)
        self.fanouts = [normalize_fanout(f, hg.num_etypes) for f in fanouts]
        self.seed = seed
        self.tile = tile
        self.node_block = node_block
        self._k_eff = [SO.effective_fanouts(f, self.dg.max_bin)
                       for f in self.fanouts]
        self._programs = {}
        self.trace_count = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.batches_sampled = 0
        # sync-free bucket speculation: per-(hop, seed bucket, fanout)
        # stage-B bucket guesses, plus the queue of not-yet-inspected count
        # vectors (read only once their copy to the host has completed)
        self._guess = {}          # sig -> (n_pad, e_pad, u_pad)
        self._shrunk = set()      # sigs whose guess already tightened once
        self._pending = collections.deque()  # (sig, fp, used, counts, event)
        self.count_syncs = 0
        self.bucket_overflows = 0
        self.bucket_shrinks = 0
        self.overflow_rebuilds = 0

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)

    # ------------------------------------------------------------------
    def _program(self, key, factory):
        """The program of a static bucket tuple, built on its first use
        (counted in ``trace_count``, ``cache_misses`` and the
        ``sampler_traces`` counter)."""
        fn = self._programs.get(key)
        if fn is None:
            self.cache_misses += 1
            self.trace_count += 1
            obs.metrics().counter("sampler_traces").inc()
            fn = factory()
            self._programs[key] = fn
        else:
            self.cache_hits += 1
        return fn

    def _bucket(self, count: int) -> int:
        return max(self.tile, pow2ceil(count + 1))

    def _worst_buckets(self, fp: int, k_eff) -> tuple:
        """Analytic stage-B buckets that can never overflow: ``fp`` frontier
        rows each select at most ``sum(k_eff)`` edges (capped by the graph's
        edge count), the union frontier adds at most one node per edge on
        top of the frontier itself (capped by N), and the unique
        (src, etype) pairs are at most the edges."""
        ksum = max(1, int(sum(k_eff)))
        e_w = min(self.hg.num_edges, fp * ksum)
        n_w = min(self.hg.num_nodes, fp + e_w)
        return (self._bucket(n_w), self._bucket(e_w), self._bucket(e_w))

    def _read_back(self, counts: torch.Tensor):
        """Start the copy of stage A's counts to the host; returns
        ``(host tensor, event)``, the event ``None`` when already there."""
        if counts.device.type != "cuda":
            return counts, None
        host = torch.empty(counts.shape, dtype=counts.dtype,
                           pin_memory=True)
        host.copy_(counts, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(counts.device))
        return host, event

    def drain(self, block: bool = False) -> None:
        """Inspect finished stage-A count vectors and tighten bucket
        guesses. Non-blocking by default: only counts whose copy to the
        host has completed (``event.query()``) are read, so the sampling
        loop stays sync-free. ``block=True`` waits for everything
        outstanding (a warmup barrier for benchmarks and tests; each wait
        counts as a ``count_syncs`` readback)."""
        while self._pending:
            sig, fp, used, counts, event = self._pending[0]
            if event is not None and not event.query():
                if not block:
                    return
                event.synchronize()
                self.count_syncs += 1
            self._pending.popleft()
            got = tuple(int(x) for x in counts.tolist())
            if any(c + 1 > b for c, b in zip(got, used)):
                # a shrunken bucket truncated this batch: report it and
                # fall back to the always-correct worst case
                self.bucket_overflows += 1
                self._guess[sig] = self._worst_buckets(fp, sig[2])
                self._shrunk.discard(sig)
                continue
            if sig in self._shrunk:
                continue
            worst = self._worst_buckets(fp, sig[2])
            # one pow2 step of headroom above the first observed counts;
            # shrink once per signature so steady state never re-buckets
            new = tuple(min(w, 2 * self._bucket(c))
                        for c, w in zip(got, worst))
            if new != self._guess.get(sig, worst):
                self._guess[sig] = new
                self.bucket_shrinks += 1
            self._shrunk.add(sig)

    def settle(self, mb: MiniBatch) -> MiniBatch:
        """``mb`` once its stage-A counts show that every hop fit the
        buckets it was built with; a batch that outgrew a shrunken bucket
        is sampled again at the worst-case buckets. Counts not yet on the
        host are waited for, one ``count_syncs`` each: in a loop that
        synchronizes every step (the drivers' loops do), a batch
        dispatched before the last step is ready, so only the first batch
        waits."""
        seq = mb.seq
        for used, counts, event in seq.checks:
            if event is not None and not event.query():
                event.synchronize()
                self.count_syncs += 1
            if any(c + 1 > b for c, b in zip(counts.tolist(), used)):
                self.overflow_rebuilds += 1
                return self.sample_minibatch(
                    seq.seeds, batch_index=seq.batch_index, epoch=seq.epoch,
                    step=mb.step, worst_case=True)
        return mb

    # ------------------------------------------------------------------
    def sample_minibatch(self, seeds: np.ndarray, batch_index: int = 0,
                         epoch: Optional[int] = None, step: int = 0,
                         worst_case: bool = False) -> MiniBatch:
        """Sample and build one device-resident ``MiniBatch``.

        Randomness is keyed as the host sampler's,
        ``hop_base_key(seed, batch_index, hop, epoch)``, so the two paths
        select the same edge multisets for the same stream position. The
        seeds go to the device through pinned memory without blocking.
        The stage-B buckets are the current guesses (``worst_case``: the
        analytic worst case); ``settle`` checks them against the counts
        before the batch is used."""
        seeds = np.asarray(seeds, dtype=np.int32)
        if seeds.ndim != 1 or seeds.size == 0:
            raise ValueError("seeds must be a non-empty 1-D int array")
        if seeds.min() < 0 or seeds.max() >= self.hg.num_nodes:
            raise ValueError("seed node id out of range")
        dg = self.dg
        nhops = self.num_hops
        b = int(seeds.shape[0])
        f0 = pow2ceil(b)

        prep = self._program(("prep", b, f0),
                             lambda: SO.make_prep_seeds(dg.num_nodes, f0))
        frontier, seed_perm = prep(to_device(
            torch.from_numpy(seeds), self.device, non_blocking=True))

        self.drain()      # non-blocking: fold in any finished count vectors

        hops = []         # sampling order (outermost first)
        checks = []
        for hop in range(nhops):
            k_eff = self._k_eff[nhops - 1 - hop]
            kmax = max(1, max(k_eff))
            fp = int(frontier.shape[0])
            base = int(hop_base_key(self.seed, int(batch_index), hop, epoch))
            with obs.span("sample_device", step=step, hop=hop):
                fn_a = self._program(
                    ("A", fp, k_eff),
                    lambda k_eff=k_eff, fp=fp: SO.make_sample_hop(
                        dg, k_eff, fp))
                union, sel_src, sel_valid, counts = fn_a(
                    dg.csc_indptr, dg.csc_src, frontier, base)
            # sync-free bucket pick: the signature's current guess (worst
            # case until a drained count vector tightened it); the counts
            # are queued for a later non-blocking inspection. The signature
            # carries the *seed* bucket, not the frontier bucket: real
            # counts do not depend on padding, so a guess learned before an
            # earlier hop shrank its frontier stays valid after.
            sig = (hop, f0, k_eff)
            guess = self._guess.setdefault(
                sig, self._worst_buckets(fp, k_eff))
            if worst_case:
                guess = self._worst_buckets(fp, k_eff)
            n_pad, e_pad, u_pad = guess
            host_counts, event = self._read_back(counts)
            self._pending.append((sig, fp, guess, host_counts, event))
            checks.append((guess, host_counts, event))
            with obs.span("layout_device", step=step, hop=hop):
                fn_b = self._program(
                    ("B", fp, kmax, n_pad, e_pad, u_pad),
                    lambda fp=fp, kmax=kmax, n_pad=n_pad, e_pad=e_pad,
                    u_pad=u_pad: SO.make_build_block(
                        dg, fp, kmax, n_pad, e_pad, u_pad, self.tile,
                        self.node_block))
                gt, kl, node_ids, dst_local, input_gather = fn_b(
                    union, sel_src, sel_valid, frontier, dg.node_type)
            hops.append(dict(gt=gt, kl=kl, node_ids=node_ids,
                             dst_local=dst_local, input_gather=input_gather,
                             num_src=n_pad, num_edges=e_pad, num_dst=fp))
            frontier = node_ids

        # execution order: innermost (last sampled) hop first; the seed
        # hop's output frontier is exactly the unique seeds
        hops[0]["num_dst"] = int(np.unique(seeds).size)
        hops.reverse()
        blocks = [DeviceBlock(num_src=h["num_src"], num_edges=h["num_edges"],
                              num_dst=h["num_dst"], node_ids=h["node_ids"])
                  for h in hops]
        seq = DeviceBlockSequence(blocks=blocks, seeds=seeds,
                                  num_nodes=self.hg.num_nodes,
                                  batch_index=int(batch_index), epoch=epoch,
                                  checks=checks)
        self.batches_sampled += 1
        return MiniBatch(
            step=step,
            seq=seq,
            tensors=[h["gt"] for h in hops],
            layouts=[h["kl"] for h in hops],
            input_ids=hops[0]["input_gather"],
            dst_locals=[h["dst_local"] for h in hops],
            seed_perm=seed_perm,
        )

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "batches_sampled": self.batches_sampled,
            "trace_count": self.trace_count,
            "jit_cache_hits": self.cache_hits,
            "jit_cache_misses": self.cache_misses,
            "compiled_programs": len(self._programs),
            "count_syncs": self.count_syncs,
            "bucket_overflows": self.bucket_overflows,
            "bucket_shrinks": self.bucket_shrinks,
            "overflow_rebuilds": self.overflow_rebuilds,
            "pending_counts": len(self._pending),
        }
