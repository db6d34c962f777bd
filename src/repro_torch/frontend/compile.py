"""The ``hector_torch.compile()`` front door.

One call takes a model (a DSL ``ModelSpec``, a registry name like
``"rgat"``, or any ``prog_fn(in_dim, out_dim, **kw) -> Program``) plus a
``HeteroGraph`` and builds the stack: per-layer traced programs ->
validated/lowered plans -> ``HectorStack`` -> fanout sampler, on one
device. The returned ``CompiledRGNN`` exposes ``init`` / ``apply_blocks``
(sampled mini-batch) / ``describe`` and delegates every other attribute to
the underlying ``RGNNEngine``. Full-graph ``apply`` and ``train_step`` come
with later slices.

``device=None`` means the CUDA card, and raises without one: pass
``device="cpu"`` to run the plain versions on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["compile", "CompiledRGNN"]


class CompiledRGNN:
    """A compiled multi-layer RGNN bound to one graph and one device."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def init(self, seed: Union[int, torch.Generator] = 0):
        """Per-layer parameter dicts on the engine's device, drawn from a
        ``torch.Generator`` (an int seeds a fresh one)."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(int(seed))
        return self.engine.init_params(gen)

    def params_from_reference(self, params_np):
        """The reference package's per-layer params (numpy arrays) as this
        model's, checked against the plans' weight tables."""
        from repro_torch.core.codegen import params_from_reference
        return params_from_reference(
            params_np, self.engine.device, plans=self.engine.plans,
            num_etypes=self.engine.graph.num_etypes,
            num_ntypes=self.engine.graph.num_ntypes)

    def apply_blocks(self, params, mb, global_feats) -> torch.Tensor:
        """Sampled mini-batch forward over a ``sampling.MiniBatch``;
        returns one row per requested seed."""
        return self.engine.forward_minibatch(params, mb, global_feats)

    def describe(self) -> str:
        """The generated plans, one per layer."""
        return "\n".join(p.describe() for p in self.engine.plans)

    def __repr__(self) -> str:
        cfg = self.engine.cfg
        return (f"CompiledRGNN<{cfg.model_name}: {cfg.layers} layers, "
                f"dims {cfg.dims}, device {self.engine.device}>")


def compile(  # noqa: A001 - deliberate: the hector_torch.compile() front door
    model,
    graph,
    *,
    layers: int = 2,
    dim: int = 64,
    hidden: int = 64,
    classes: int = 16,
    sample: Optional[Union[int, Sequence[int]]] = None,
    tile: int = 32,
    node_block: int = 32,
    activation: str = "relu",
    seed: int = 0,
    device=None,
) -> CompiledRGNN:
    """Compile ``model`` for ``graph`` on ``device`` (``None``: the CUDA
    card) and return a ``CompiledRGNN``.

    ``model``: a registry name (``"rgat"``), a ``@hector_torch.model``
    ``ModelSpec`` or any ``prog_fn(in_dim, out_dim) -> Program``.
    ``sample``: per-hop neighbor fanout of the mini-batch path — an int
    (every hop), a per-layer sequence, or ``-1`` for full neighborhoods.
    """
    from repro_torch.train.engine import EngineConfig, RGNNEngine

    if isinstance(sample, (int, np.integer)):
        sample = [int(sample)] * layers
    cfg = EngineConfig(
        model=model, layers=layers, dim=dim, hidden=hidden, classes=classes,
        fanouts=sample, tile=tile, node_block=node_block,
        activation=activation, seed=seed, device=device)
    return CompiledRGNN(RGNNEngine(graph, cfg))
