"""Shared RGNN execution engine of the port: graph + stack + sampler +
loader wiring, as in ``repro.train.engine``; both drivers (serving and
training) build one.

The engine owns what is a pure function of (graph, model config, device):
the lowered per-layer plans, the block executor, the full-graph tensors
and kernel layouts (built on first use), the fanout sampler (and, with
``sampler="device"``, the ``DeviceSampler`` over the graph's CSC on the
device), and one sampled train-step executor per optimizer. Seed streams
and loaders are made per driver through ``make_loader``. With
``tune != "off"`` the engine builds a ``tune.Tuner`` on its device and
folds its measured (or cache-replayed) decisions into the stack: per-op
variants, per-layer COMPACT sets and the full-graph layout tile;
``tune_minibatch`` adds block-scale op variants. The executors capture one
CUDA graph per signature on a card (``core.executor``).
``make_feature_store`` builds the tiered node-feature store the config
asks for (``feature_store`` / ``feature_budget``, ``repro_torch.feats``),
the cached tier's per-ntype split measured on the caller's stream; loaders
attach its rows to every batch.

With ``dp`` / ``partitions`` (``repro_torch.dist``) the engine also builds,
eagerly, an edge-cut ``partition`` of the graph, this rank's
``data_mesh`` (``launch.mesh.DataGroup``) and the ``dist_batcher``, which
lays out the shards this rank runs on its device; ``shard_features``,
``dist_serve_executor`` and ``dist_train_executor(opt)`` complete the
data-parallel surface.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import HeteroGraph
from repro_torch.core.module import HectorStack
from repro_torch.device import resolve_device  # noqa: F401 (re-exported)
from repro_torch.feats import gather_input, make_feature_store
from repro_torch.models import (hgt_program, rgat_program, rgcn_cat_program,
                                rgcn_program)
from repro_torch.sampling import (DeviceSampler, FanoutSampler,
                                  MiniBatchLoader)

MODEL_PROGRAMS = {"rgcn": rgcn_program, "rgat": rgat_program,
                  "hgt": hgt_program, "rgcn_cat": rgcn_cat_program}


def parse_fanout(spec: str, layers: int) -> List[int]:
    """Parse a ``--fanout`` CLI spec: one int, or one per layer, comma
    separated; ``-1`` means the full neighborhood."""
    parts = [int(p) for p in spec.split(",")]
    if len(parts) == 1:
        parts = parts * layers
    if len(parts) != layers:
        raise ValueError(
            f"--fanout needs 1 or {layers} comma-separated ints, got {spec!r}"
        )
    return parts


@dataclasses.dataclass
class EngineConfig:
    """Model/compilation configuration shared by serving and training.

    ``model`` is a registry name (``MODEL_PROGRAMS``), a DSL-authored
    ``frontend.ModelSpec``, or any ``prog_fn(in_dim, out_dim) -> Program``.

    ``tune`` selects the autotuning mode (``repro_torch.tune``): ``off``
    keeps the defaults, ``cached`` replays persisted decisions with zero
    measurements, ``full`` measures whatever the persistent cache
    (``tune_cache``, default ``~/.cache/repro_torch-tune.json``) is
    missing. The tuner may override ``tile`` / ``node_block`` of the
    full-graph layouts with its measured layout decision; sampled blocks
    keep the configured ones.

    ``feature_store`` says where the node-feature table lives
    (``repro_torch.feats``): ``device`` (the whole table on the device),
    ``host`` (per-ntype host tables, only sampled rows shipped) or
    ``cached`` (the host tier behind a device hot-row cache of
    ``feature_budget`` rows, default table/4). All three give the same
    predictions bit for bit.
    """

    model: Union[str, Callable] = "rgat"
    layers: int = 2
    dim: int = 64
    hidden: int = 64
    classes: int = 16
    fanouts: Optional[Sequence] = None   # default: [5] * layers
    tile: int = 32
    node_block: int = 32
    bucket: bool = True
    activation: str = "relu"
    seed: int = 0
    device: Optional[str] = None         # None: the CUDA card
    sampler: str = "host"                # host | device
    feature_store: str = "device"        # device | host | cached
    feature_budget: Optional[int] = None  # cached: device rows (table/4)
    tune: str = "off"                    # off | cached | full
    tune_cache: Optional[str] = None     # persistent decision cache path
    # False for block-path-only callers (serving): keeps the materialization
    # decisions (they shape the shared lowered plans) but skips the
    # full-graph layout/op measurements serving traffic never queries
    tune_full_graph: bool = True
    # data-parallel execution: ``dp`` ranks over a ``partitions``-way
    # edge-cut partition of the graph (default: one shard per rank);
    # extra shards fold onto ranks with bit-identical results
    dp: int = 1
    partitions: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.model, str):
            if self.model not in MODEL_PROGRAMS:
                raise ValueError(f"unknown model {self.model!r}; "
                                 f"have {sorted(MODEL_PROGRAMS)}")
        elif not callable(self.model):
            raise ValueError(
                f"model must be a registry name or a program factory "
                f"(@hector_torch.model / prog_fn); got "
                f"{type(self.model).__name__}")
        if self.sampler not in ("host", "device"):
            raise ValueError(f"sampler={self.sampler!r}; pick host/device")
        if self.tune not in ("off", "cached", "full"):
            raise ValueError(f"tune={self.tune!r}; pick off/cached/full")
        if self.feature_store not in ("device", "host", "cached"):
            raise ValueError(f"feature_store={self.feature_store!r}; "
                             f"pick device/host/cached")
        self.fanouts = list(self.fanouts) if self.fanouts is not None \
            else [5] * self.layers
        if len(self.fanouts) != self.layers:
            raise ValueError("one fanout per layer required")
        if self.dp < 1:
            raise ValueError("dp must be >= 1")
        if self.partitions is not None and self.partitions % self.dp:
            raise ValueError(
                f"partitions={self.partitions} must be a multiple of "
                f"dp={self.dp} (shards fold evenly onto ranks)")

    @property
    def num_partitions(self) -> int:
        """Graph shards P (defaults to one per data-parallel rank)."""
        return self.partitions if self.partitions is not None else self.dp

    @property
    def distributed(self) -> bool:
        return self.num_partitions > 1 or self.dp > 1

    @property
    def dims(self) -> List[int]:
        return [self.dim] + [self.hidden] * (self.layers - 1) + [self.classes]

    @property
    def model_name(self) -> str:
        if isinstance(self.model, str):
            return self.model
        return getattr(self.model, "name", None) \
            or getattr(self.model, "__name__", "custom")


class RGNNEngine:
    """One multi-layer RGNN compiled for one graph on one device, for both
    execution modes: full graph (``forward_full``, ``StackTrainExecutor``)
    and sampled mini-batches (``forward_minibatch``,
    ``train_executor(opt)``), sharing plans and parameters."""

    def __init__(self, graph: HeteroGraph, cfg: EngineConfig, log=None):
        self.graph = graph
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        prog_fn = MODEL_PROGRAMS[cfg.model] if isinstance(cfg.model, str) \
            else cfg.model
        dims = cfg.dims
        programs = [prog_fn(dims[i], dims[i + 1]) for i in range(cfg.layers)]

        # autotuning: measured (or cache-replayed) per-op variants, per-var
        # materialization and the full-graph layout tile, all folded into
        # the stack below; the effective tile can differ from cfg.tile
        self.tuner = None
        self.decisions = None
        compact_vars = None
        self.tile, self.node_block = cfg.tile, cfg.node_block
        if cfg.tune != "off":
            from repro_torch.tune.tuner import Tuner  # lazy: imports codegen
            self.tuner = Tuner(mode=cfg.tune, cache_path=cfg.tune_cache,
                               log=log, device=self.device)
            report = self.tuner.tune_stack(
                programs, graph, tile=cfg.tile, node_block=cfg.node_block,
                feat_dims=dims[:-1], seed=cfg.seed,
                tune_layout=cfg.tune_full_graph,
                tune_ops=cfg.tune_full_graph)
            self.decisions = report.decisions
            compact_vars = report.compact_vars
            self.tile, self.node_block = report.tile, report.node_block

        self.stack = HectorStack(programs, graph, tile=self.tile,
                                 node_block=self.node_block,
                                 activation=cfg.activation,
                                 device=self.device,
                                 compact_vars=compact_vars,
                                 decisions=self.decisions)
        self.sampler = FanoutSampler(graph, cfg.fanouts, seed=cfg.seed)
        # the device pipeline: the CSC goes to the device once, here; it
        # shares the host sampler's seed, so both draw the same edges
        self.device_sampler = None
        if cfg.sampler == "device":
            self.device_sampler = DeviceSampler(
                graph, cfg.fanouts, seed=cfg.seed, tile=cfg.tile,
                node_block=cfg.node_block, device=self.device)
        # sampled train-step executors, one per optimizer instance (shared
        # by the compile facade and SampledTrainer)
        self._train_execs = {}

        # data-parallel pieces, built eagerly (cheap host work) so config
        # errors surface at compile time: the partition, this rank's data
        # group (dp > 1 needs the ranks launch.mesh.launch_ranks starts)
        # and the batcher of the shards it runs
        self.partition = None
        self.dist_batcher = None
        self.data_mesh = None
        self._dist_execs = {}
        if cfg.distributed:
            from repro_torch.dist import ShardedBatcher, partition_graph
            from repro_torch.launch.mesh import make_data_mesh
            self.partition = partition_graph(graph, cfg.num_partitions)
            self.data_mesh = make_data_mesh(cfg.dp, device=self.device)
            self.dist_batcher = ShardedBatcher(
                self.partition, cfg.fanouts, seed=cfg.seed, tile=cfg.tile,
                node_block=cfg.node_block,
                shards=self.data_mesh.shards(cfg.num_partitions),
                device=self.device)

    @property
    def plans(self):
        return self.stack.plans

    @property
    def block_executor(self):
        return self.stack.block_executor

    @property
    def gt(self):
        """Full-graph tensors on the engine's device (shared by layers)."""
        return self.stack.gt

    @property
    def layouts(self):
        """Full-graph kernel layouts on the engine's device."""
        return self.stack.layouts

    def init_params(self, generator: torch.Generator):
        return self.stack.init(generator)

    def train_executor(self, opt):
        """The sampled SGD step (``BlockTrainExecutor``) for this engine's
        plans and ``opt``, cached per optimizer instance (the oldest of
        more than 4 is dropped)."""
        from repro_torch.core import executor
        ex = self._train_execs.get(id(opt))
        if ex is None:
            ex = executor.BlockTrainExecutor(
                self.plans, opt, activation=self.cfg.activation,
                decisions=self.decisions)
            self._train_execs[id(opt)] = ex
            while len(self._train_execs) > 4:   # insertion-ordered
                self._train_execs.pop(next(iter(self._train_execs)))
        return ex

    # ------------------------------------------------------------------
    # data-parallel surface (cfg.dp / cfg.partitions)
    # ------------------------------------------------------------------
    def _require_dist(self):
        if self.partition is None:
            raise ValueError(
                "distributed execution needs dp > 1 or partitions > 1 in "
                "the EngineConfig (e.g. hector_torch.compile(..., "
                "partitions=4))")

    def shard_features(self, feats) -> torch.Tensor:
        """This rank's resident feature slabs ``[L, n_own, d]`` on its
        device (slab ``i`` holds shard ``shards[i]``'s owned rows, pad rows
        zero; the steps all-gather them for halo access).

        ``feats`` may be a raw ``[N, d]`` table or a ``repro_torch.feats``
        store: with a store each slab is read through ``host_rows``, so
        the whole table never goes to the device."""
        self._require_dist()
        from repro_torch.feats import is_feature_store
        part = self.partition
        shards = self.dist_batcher.shards
        if is_feature_store(feats):
            out = np.zeros((len(shards), part.max_owned, feats.dim),
                           dtype=feats.dtype)
            for i, p in enumerate(shards):
                lo, hi = int(part.bounds[p]), int(part.bounds[p + 1])
                out[i, : hi - lo] = feats.host_rows(
                    np.arange(lo, hi, dtype=np.int64))
        else:
            table = feats.cpu().numpy() if isinstance(feats, torch.Tensor) \
                else np.asarray(feats)
            out = part.shard_features(table)[list(shards)]
        return torch.from_numpy(np.ascontiguousarray(out)).to(self.device)

    def dist_serve_executor(self):
        """The multi-shard inference step (cached)."""
        self._require_dist()
        ex = self._dist_execs.get("serve")
        if ex is None:
            from repro_torch.dist import ShardedServeExecutor
            ex = ShardedServeExecutor(
                self.plans, self.data_mesh, activation=self.cfg.activation,
                decisions=self.decisions)
            self._dist_execs["serve"] = ex
        return ex

    def dist_train_executor(self, opt):
        """The multi-shard SGD step for ``opt`` (cached per optimizer
        instance, like ``train_executor``)."""
        self._require_dist()
        ex = self._dist_execs.get(id(opt))
        if ex is None:
            from repro_torch.dist import ShardedTrainExecutor
            ex = ShardedTrainExecutor(
                self.plans, opt, self.data_mesh,
                activation=self.cfg.activation, decisions=self.decisions)
            self._dist_execs[id(opt)] = ex
            while len(self._dist_execs) > 5:   # never evict the serve step
                self._dist_execs.pop(next(
                    k for k in self._dist_execs if k != "serve"))
        return ex

    def make_loader(
        self,
        seed_source: Union[object, Callable[[int], np.ndarray]],
        *,
        num_batches: Optional[int] = None,
        start_step: int = 0,
        cache_blocks: int = 0,
        cache_layouts: int = 0,
        feature_store=None,
        shape_floors=None,
        depth: int = 2,
    ) -> MiniBatchLoader:
        """A prefetching loader over this engine's sampler/layout config,
        delivering (bucketed, unless ``cfg.bucket`` is off) mini-batches on
        the engine's device from ``start_step`` on. Blocks keep the
        *configured* tile, not the tuned full-graph one: their op variants
        are tuned against these layouts by ``tune_minibatch``. With
        ``cfg.sampler == "device"`` it gets the ``DeviceSampler`` and
        prefetches without a thread (sampling and layouts as enqueued
        device work). ``cache_blocks`` / ``cache_layouts`` size the
        loader's LRU caches (0: off); ``feature_store`` (a store from
        ``make_feature_store``) attaches every batch's input rows;
        ``shape_floors`` (a ``bucketing.ShapeFloors``, host sampler only)
        pins each seed count's block buckets, as the serving runtime's
        rungs need; ``depth`` batches are prefetched."""
        active = self.device_sampler if self.device_sampler is not None \
            else self.sampler
        return MiniBatchLoader(
            active, seed_source,
            tile=self.cfg.tile, node_block=self.cfg.node_block,
            bucket=self.cfg.bucket, start_step=start_step,
            num_batches=num_batches, cache_blocks=cache_blocks,
            cache_layouts=cache_layouts, feature_store=feature_store,
            shape_floors=shape_floors, depth=depth, device=self.device,
        )

    def make_feature_store(self, feats, *, seed_source=None,
                           probe_batches: int = 4):
        """The ``repro_torch.feats`` store this config asks for
        (``cfg.feature_store`` / ``cfg.feature_budget``) on the engine's
        device, from the ``[N, dim]`` host table ``feats``.

        For the cached tier the per-ntype slot split is measured when
        ``seed_source`` is given: ``tune.feature_budget`` probes
        ``probe_batches`` seed batches through the host sampler and splits
        the budget by each ntype's share of the input rows."""
        kind = self.cfg.feature_store
        split = None
        if kind == "cached" and seed_source is not None:
            from repro_torch.tune.feature_budget import measured_split
            budget = self.cfg.feature_budget
            if budget is None:
                budget = max(1, self.graph.num_nodes // 4)
            split, _report = measured_split(
                self.graph, self.sampler, seed_source, budget,
                probe_batches=probe_batches)
        return make_feature_store(feats, self.graph, kind=kind,
                                  budget=self.cfg.feature_budget,
                                  split=split, device=self.device)

    def forward_minibatch(self, params, mb, global_feats,
                          compiled: bool = True) -> torch.Tensor:
        """Sampled forward: per-seed outputs for a ``MiniBatch``, inside an
        ``execute`` span (synchronized in the span only when tracing);
        ``compiled=False`` runs op by op. ``global_feats`` is the raw
        device table or a feature store; loader-attached ``mb.feats``
        win either way (``feats.gather_input``)."""
        with obs.span("execute", step=mb.step) as sp:
            return sp.sync(self.stack.apply_blocks(
                params, mb, compiled=compiled,
                feats=gather_input(global_feats, mb)))

    def forward_full(self, params, feats: torch.Tensor,
                     compiled: bool = True) -> torch.Tensor:
        """Full-graph forward over all nodes, without gradients, inside an
        ``execute`` span; ``compiled=False`` runs op by op."""
        with obs.span("execute", mode="full_graph") as sp, torch.no_grad():
            return sp.sync(self.stack.apply(params, {"feature": feats},
                                            compiled=compiled))

    def tune_minibatch(self, params, mb, global_feats) -> None:
        """Extend the decision table with block-scale op variants measured
        (or cache-replayed) on one representative ``MiniBatch``; the
        executors share the table, so the next call runs them. Without a
        tuner (``tune="off"``) nothing happens."""
        if self.tuner is None:
            return
        self.tuner.tune_block_sequence(self.plans, params, mb, global_feats,
                                       activation=self.cfg.activation)

    @property
    def tuner_stats(self) -> dict:
        return dict(self.tuner.stats) if self.tuner is not None else {}
