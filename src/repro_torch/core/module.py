"""HectorModule / HectorStack — the single-layer / multi-layer compilation
units under ``hector_torch.compile()``.

    stack = HectorStack([rgat_program(64, 64), rgat_program(64, 16)], graph,
                        device="cuda")
    params = stack.init(torch.Generator().manual_seed(0))
    logits = stack.apply(params, {"feature": x})          # full graph
    logits = stack.apply_blocks(params, mb, x)             # sampled batch

The full-graph ``GraphTensors`` and ``KernelLayouts`` (unbucketed, at the
stack's tile and node block) are built on the first full-graph call and
moved to the stack's device once, shared by every layer: a serving process
that only runs sampled batches never builds them.

The autotuner's results enter here: ``compact_vars`` (per layer, the edge
variables lowered COMPACT; ``None`` keeps the static policy) shapes the
lowered plans, and ``decisions`` (a ``tune.TuningDecisions``) picks each
op's variant at run time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import codegen, executor
from repro_torch.core.graph import HeteroGraph
from repro_torch.core.ir import inter_op as I
from repro_torch.core.ir.passes import lower_program


class FullGraph:
    """Lazily built full-graph tensors and kernel layouts on one device."""

    def __init__(self, graph: HeteroGraph, *, tile: int, node_block: int,
                 device):
        self.graph = graph
        self.tile = tile
        self.node_block = node_block
        self.device = torch.device(device)
        self._gt = None
        self._layouts: Optional[codegen.KernelLayouts] = None

    @property
    def gt(self):
        if self._gt is None:
            self._gt = self.graph.to_tensors().to(self.device)
        return self._gt

    @property
    def layouts(self) -> codegen.KernelLayouts:
        if self._layouts is None:
            self._layouts = codegen.build_kernel_layouts(
                self.graph, tile=self.tile,
                node_block=self.node_block).to(self.device)
        return self._layouts


class HectorModule:
    """One lowered Hector layer over the full graph. ``reorder`` and
    ``compact`` select the lowering passes (linear-operator reordering,
    compact materialization), both on by default as in the paper."""

    def __init__(
        self,
        program: I.Program,
        graph: HeteroGraph,
        *,
        reorder: bool = True,
        compact: bool = True,
        compact_vars=None,
        tile: int = 128,
        node_block: int = 128,
        device="cpu",
        full: Optional[FullGraph] = None,
        decisions=None,
    ):
        self.program = program
        self.graph = graph
        self.plan = lower_program(program, reorder=reorder, compact=compact,
                                  compact_vars=compact_vars)
        self.device = torch.device(device)
        # shared across the layers of a stack (HectorStack passes its own)
        self.full = full if full is not None else FullGraph(
            graph, tile=tile, node_block=node_block, device=self.device)
        self.executor = executor.PlanExecutor(self.plan, decisions)

    @property
    def gt(self):
        return self.full.gt

    @property
    def layouts(self) -> codegen.KernelLayouts:
        return self.full.layouts

    def init(self, generator: torch.Generator,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return codegen.init_params(self.plan, self.graph.num_etypes,
                                   self.graph.num_ntypes, generator, dtype,
                                   self.device)

    def apply(self, params, feats: Dict[str, torch.Tensor],
              compiled: bool = True):
        """The layer's outputs over the full graph (autograd records it
        when grad is enabled; without grad on a card, ``compiled`` replays
        one captured graph per signature)."""
        return self.executor(params, self.gt, self.layouts, feats,
                             compiled=compiled)

    def describe(self) -> str:
        return self.plan.describe()


class HectorStack:
    """A multi-layer RGNN: one lowered Hector plan per layer, an
    elementwise activation between layers.

    * ``apply(params, feats)`` — full-graph forward over all nodes;
    * ``apply_blocks(params, mb, x)`` — sampled forward over a
      ``MiniBatch``, one layer per hop, returning the rows of the requested
      seeds in request order.

    With full-neighborhood fanout the two agree on the seed rows."""

    def __init__(
        self,
        programs: Sequence[I.Program],
        graph: HeteroGraph,
        *,
        reorder: bool = True,
        compact: bool = True,
        compact_vars: Optional[Sequence] = None,   # per-layer COMPACT sets
        tile: int = 128,
        node_block: int = 128,
        activation: str = "relu",
        device="cpu",
        decisions=None,
    ):
        if not programs:
            raise ValueError("need at least one layer program")
        if compact_vars is not None and len(compact_vars) != len(programs):
            raise ValueError("need one compact-var set per layer (None to "
                             "keep a layer's default)")
        self.graph = graph
        self.device = torch.device(device)
        self.full = FullGraph(graph, tile=tile, node_block=node_block,
                              device=self.device)
        self.layers = [
            HectorModule(p, graph, reorder=reorder, compact=compact,
                         compact_vars=(None if compact_vars is None
                                       else compact_vars[i]),
                         device=self.device, full=self.full,
                         decisions=decisions)
            for i, p in enumerate(programs)]
        self.activation = activation
        self._act = codegen._ACTIVATIONS[activation]
        self.block_executor = executor.BlockExecutor(
            self.plans, activation=activation, decisions=decisions)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def plans(self):
        return [layer.plan for layer in self.layers]

    @property
    def gt(self):
        return self.full.gt

    @property
    def layouts(self) -> codegen.KernelLayouts:
        return self.full.layouts

    def init(self, generator: torch.Generator,
             dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
        """Per-layer parameters, drawn layer after layer from
        ``generator``."""
        return [layer.init(generator, dtype) for layer in self.layers]

    def apply(self, params: Sequence[Dict[str, torch.Tensor]],
              feats: Dict[str, torch.Tensor],
              compiled: bool = True) -> torch.Tensor:
        """Full-graph forward; returns the last layer's primary output."""
        cur = dict(feats)
        h = None
        for i, (layer, p) in enumerate(zip(self.layers, params)):
            h = layer.apply(p, cur, compiled)[layer.plan.outputs[0]]
            if i < self.num_layers - 1:
                cur = {"feature": self._act(h)}
        return h

    def apply_blocks(self, params: Sequence[Dict[str, torch.Tensor]], mb,
                     global_feats=None, compiled: bool = True, *,
                     feats=None) -> torch.Tensor:
        """Sampled forward over a ``MiniBatch``; returns [len(seeds), out].

        ``compiled=True`` runs the block sequence through the
        ``BlockExecutor``'s captured graph of the batch's signature (on a
        card; the CPU runs op by op either way); ``compiled=False`` is the
        op-by-op path, as the reference's. The input features: ``feats``,
        else ``mb.feats``, else ``global_feats`` (a table or a feature
        store) at ``mb.input_ids``."""
        if mb.num_hops != self.num_layers:
            raise ValueError(
                f"minibatch has {mb.num_hops} hops but the stack has "
                f"{self.num_layers} layers"
            )
        return self.block_executor.run_minibatch(list(params), mb,
                                                 global_feats, feats=feats,
                                                 compiled=compiled)
