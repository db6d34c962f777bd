"""HectorStack — the multi-layer unit under ``hector_torch.compile()``;
sampled forward only in this slice (full-graph ``apply``, the per-layer
``HectorModule`` and training come later).

    stack = HectorStack([rgat_program(64, 64), rgat_program(64, 16)], graph)
    params = stack.init(torch.Generator().manual_seed(0))
    logits = stack.apply_blocks(params, mb, feats)
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.core import codegen, executor
from repro_torch.core.graph import HeteroGraph
from repro_torch.core.ir import inter_op as I
from repro_torch.core.ir.passes import lower_program


class HectorStack:
    """A multi-layer RGNN: one lowered Hector plan per layer, an
    elementwise activation between layers. ``apply_blocks`` runs one layer
    per hop of a sampled ``MiniBatch`` and returns the rows of the requested
    seeds in request order."""

    def __init__(
        self,
        programs: Sequence[I.Program],
        graph: HeteroGraph,
        *,
        activation: str = "relu",
        device="cpu",
    ):
        if not programs:
            raise ValueError("need at least one layer program")
        self.graph = graph
        self.plans = [lower_program(p) for p in programs]
        self.device = torch.device(device)
        self.block_executor = executor.BlockExecutor(self.plans,
                                                     activation=activation)

    @property
    def num_layers(self) -> int:
        return len(self.plans)

    def init(self, generator: torch.Generator,
             dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
        """Per-layer parameters, drawn layer after layer from
        ``generator``."""
        return [codegen.init_params(plan, self.graph.num_etypes,
                                    self.graph.num_ntypes, generator, dtype,
                                    self.device)
                for plan in self.plans]

    def apply_blocks(self, params: Sequence[Dict[str, torch.Tensor]], mb,
                     global_feats: torch.Tensor) -> torch.Tensor:
        """Sampled forward over a ``MiniBatch``; returns [len(seeds), out]."""
        if mb.num_hops != self.num_layers:
            raise ValueError(
                f"minibatch has {mb.num_hops} hops but the stack has "
                f"{self.num_layers} layers"
            )
        return self.block_executor.run_minibatch(list(params), mb,
                                                 global_feats)
