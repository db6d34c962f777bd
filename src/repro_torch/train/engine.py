"""Shared RGNN execution engine of the port: graph + stack + sampler +
loader wiring, as in ``repro.train.engine``; both drivers (serving and
training) build one.

The engine owns what is a pure function of (graph, model config, device):
the lowered per-layer plans, the block executor, the full-graph tensors
and kernel layouts (built on first use), the fanout sampler, and one
sampled train-step executor per optimizer. Seed streams and loaders are
made per driver through ``make_loader``. Tuning, device sampling, feature
stores and data parallelism are later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.graph import HeteroGraph
from repro_torch.core.module import HectorStack
from repro_torch.models import (hgt_program, rgat_program, rgcn_cat_program,
                                rgcn_program)
from repro_torch.sampling import FanoutSampler, MiniBatchLoader

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


def resolve_device(device) -> torch.device:
    """The entry points' device: ``None`` means the CUDA card. Without one
    this raises instead of running on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev


@dataclasses.dataclass
class EngineConfig:
    """Model/compilation configuration shared by serving and training.

    ``model`` is a registry name (``MODEL_PROGRAMS``), a DSL-authored
    ``frontend.ModelSpec``, or any ``prog_fn(in_dim, out_dim) -> Program``.
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
        self.fanouts = list(self.fanouts) if self.fanouts is not None \
            else [5] * self.layers
        if len(self.fanouts) != self.layers:
            raise ValueError("one fanout per layer required")

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

    def __init__(self, graph: HeteroGraph, cfg: EngineConfig):
        self.graph = graph
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        prog_fn = MODEL_PROGRAMS[cfg.model] if isinstance(cfg.model, str) \
            else cfg.model
        dims = cfg.dims
        programs = [prog_fn(dims[i], dims[i + 1]) for i in range(cfg.layers)]
        self.stack = HectorStack(programs, graph, tile=cfg.tile,
                                 node_block=cfg.node_block,
                                 activation=cfg.activation,
                                 device=self.device)
        self.sampler = FanoutSampler(graph, cfg.fanouts, seed=cfg.seed)
        # sampled train-step executors, one per optimizer instance (shared
        # by the compile facade and SampledTrainer)
        self._train_execs = {}

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
                self.plans, opt, activation=self.cfg.activation)
            self._train_execs[id(opt)] = ex
            while len(self._train_execs) > 4:   # insertion-ordered
                self._train_execs.pop(next(iter(self._train_execs)))
        return ex

    def make_loader(
        self,
        seed_source: Union[object, Callable[[int], np.ndarray]],
        *,
        num_batches: Optional[int] = None,
        start_step: int = 0,
    ) -> MiniBatchLoader:
        """A prefetching loader over this engine's sampler/layout config,
        delivering (bucketed, unless ``cfg.bucket`` is off) mini-batches on
        the engine's device from ``start_step`` on."""
        return MiniBatchLoader(
            self.sampler, seed_source,
            tile=self.cfg.tile, node_block=self.cfg.node_block,
            bucket=self.cfg.bucket, start_step=start_step,
            num_batches=num_batches, device=self.device,
        )

    def forward_minibatch(self, params, mb, global_feats) -> torch.Tensor:
        """Sampled forward: per-seed outputs for a ``MiniBatch``."""
        return self.stack.apply_blocks(params, mb, global_feats)

    def forward_full(self, params, feats: torch.Tensor) -> torch.Tensor:
        """Full-graph forward over all nodes, without gradients."""
        with torch.no_grad():
            return self.stack.apply(params, {"feature": feats})
