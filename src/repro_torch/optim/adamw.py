"""AdamW with decoupled weight decay, global-norm clipping, fp32 moments —
the port of ``repro.optim.adamw``, with the same defaults (b2 = 0.95,
clipping at 1.0) and the same arithmetic, step for step. (It is not
``torch.optim.AdamW``, whose defaults and clipping differ.)

The update is functional: ``update(grads, state)`` returns a new
``TrainState`` and leaves the old one as it was. Parameter trees are what
the executors use: a list of ``{name: tensor}`` dicts, one per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Union

import torch


@dataclasses.dataclass
class TrainState:
    params: Any
    mu: Any
    nu: Any
    step: torch.Tensor        # int32 scalar, on the params' device


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree (``TrainState``, list/tuple, dict in sorted
    key order, or a tensor) in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, TrainState):
        return (tree_leaves(tree.params) + tree_leaves(tree.mu)
                + tree_leaves(tree.nu) + [tree.step])
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def tree_like(like, leaves):
    """A tree of ``like``'s structure whose tensors are ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, TrainState):
            return TrainState(params=build(t.params), mu=build(t.mu),
                              nu=build(t.nu), step=build(t.step))
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return type(t)(build(v) for v in t)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    return tree_like(tree, [fn(*ts) for ts in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> TrainState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return TrainState(params=params, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        # a fill, not a host-to-device copy: the step may be captured
        return torch.full((), self.learning_rate, dtype=torch.float32,
                          device=step.device)

    @torch.no_grad()
    def update(self, grads, state: TrainState) -> TrainState:
        step = state.step + 1
        if self.clip_norm is not None:
            gsq = torch.zeros((), dtype=torch.float32, device=step.device)
            for g in tree_leaves(grads):
                gsq = gsq + torch.sum(torch.square(g.to(torch.float32)))
            gnorm = torch.sqrt(gsq)
            scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        lr = self._lr(step)

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            delta = delta + self.weight_decay * p.to(torch.float32)
            newp = p.to(torch.float32) - lr * delta
            return newp.to(p.dtype), m, v

        out = [upd(p, g, m, v) for p, g, m, v in zip(
            tree_leaves(state.params), tree_leaves(grads),
            tree_leaves(state.mu), tree_leaves(state.nu))]
        return TrainState(
            params=tree_like(state.params, [o[0] for o in out]),
            mu=tree_like(state.mu, [o[1] for o in out]),
            nu=tree_like(state.nu, [o[2] for o in out]),
            step=step)
