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

Not ported yet: the LRU block/layout caches and graph partitions.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import codegen
from repro_torch.core.graph import GraphTensors, HeteroGraph, to_device
from repro_torch.kernels.layout import pow2ceil
from repro_torch.sampling.bucketing import pad_block_graph, pad_index
from repro_torch.sampling.sampler import BlockSequence

# batches built ahead of the consumer (by the producer thread, or
# dispatched on the device)
PREFETCH_DEPTH = 2


class SeedStream:
    """Deterministic seed-node request stream: step -> seed ID batch.

    The port's own copy of ``repro.sampling.loader.SeedStream`` (uniform
    draws): the same seeds for the same (seed, step), drawn with
    replacement, fresh for every step. Repeat traffic and the Zipf-skewed
    and id-restricted streams come with the cache and feature-store slices.
    """

    def __init__(self, num_nodes: int, batch_size: int = 32, seed: int = 0):
        self.num_nodes = int(num_nodes)
        self.batch_size = batch_size
        self.seed = seed

    def batch(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, self.num_nodes, size=self.batch_size,
                            dtype=np.int32)


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

    @property
    def num_hops(self) -> int:
        return len(self.tensors)


def build_minibatch(seq: BlockSequence, step: int = 0, tile: int = 128,
                    node_block: int = 128, bucket: bool = False,
                    shape_floors=None, device="cpu") -> MiniBatch:
    """Host-side assembly of a ``MiniBatch`` from a sampled ``BlockSequence``,
    its tensors copied to ``device`` without blocking.

    With ``bucket=True`` each block graph, its kernel layouts and every
    gather-index vector are padded to power-of-two buckets (numerically
    inert: pad nodes/edges only feed pad rows, which the hop-chaining
    gathers never read). ``shape_floors`` (a ``bucketing.ShapeFloors``)
    pads each hop up to the largest bucket seen for this seed count.
    """
    graphs = [b.graph for b in seq.blocks]
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
        rf = (shape_floors.layout_floors(key, hop)
              if bucket and shape_floors is not None else None)
        return codegen.build_kernel_layouts(
            g, tile=tile, node_block=node_block, bucket=bucket,
            row_floors=rf)

    def dev(a: np.ndarray) -> torch.Tensor:
        return to_device(torch.from_numpy(np.ascontiguousarray(a)), device,
                         non_blocking=True)

    return MiniBatch(
        step=step,
        seq=seq,
        tensors=[g.to_tensors().to(device, non_blocking=True)
                 for g in graphs],
        layouts=[layouts_for(i, g).to(device, non_blocking=True)
                 for i, g in enumerate(graphs)],
        input_ids=dev(input_ids),
        dst_locals=[dev(d) for d in dst_locals],
        seed_perm=dev(seq.seed_perm),
    )


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
    ``step -> np.ndarray`` callable. Iteration yields ``MiniBatch`` in step
    order from ``start_step``; with ``num_batches`` set the loader raises
    ``StopIteration`` after that many. A source with ``epoch_of(step)``
    keys the sampler by epoch. ``close()`` stops and joins the worker.
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
        device="cpu",
    ):
        self.sampler = sampler
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
        self.mode = ("device" if hasattr(sampler, "sample_minibatch")
                     else "host")
        self.host_builds = 0     # batches built by the host NumPy pipeline
        self.device_builds = 0   # batches built by the device sampler
        self._done = False
        self._thread = None
        if self.mode == "device":
            # threadless prefetch: a deque of already-dispatched batches
            self._next_step = start_step
            self._pending: collections.deque = collections.deque()
            return
        self.q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _build(self, step: int) -> MiniBatch:
        seeds = self._seeds_for(step)
        self.host_builds += 1
        epoch = self._epoch_of(step) if self._epoch_of is not None else None
        seq = self.sampler.sample(seeds, batch_index=step, epoch=epoch)
        return build_minibatch(seq, step=step, tile=self.tile,
                               node_block=self.node_block,
                               bucket=self.bucket, device=self.device)

    def _build_device(self, step: int) -> MiniBatch:
        seeds = self._seeds_for(step)
        epoch = self._epoch_of(step) if self._epoch_of is not None else None
        self.device_builds += 1
        return self.sampler.sample_minibatch(seeds, batch_index=step,
                                             epoch=epoch, step=step)

    def _pump(self) -> None:
        """Dispatch device builds until the prefetch window is full: each
        build only enqueues device work, so batch k+1 is sampled while the
        consumer runs batch k."""
        while len(self._pending) < PREFETCH_DEPTH:
            if (self.num_batches is not None and
                    self._next_step - self._start_step >= self.num_batches):
                return
            self._pending.append(self._build_device(self._next_step))
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
            # checked against its counts (rebuilt if it overflowed)
            mb = self.sampler.settle(self._pending.popleft())
            self._pump()   # dispatch the next batch before the caller runs
            return mb
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
