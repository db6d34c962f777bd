"""Pipeline parallelism over the ``pod`` axis, GPipe-style (the port's
counterpart of ``repro.runtime.pipeline``).

At multi-pod scale the cross-pod link is the slowest; instead of pure data
parallelism (every parameter's gradient all-reduced across pods), a
pipeline sends only microbatch activations across the pod boundary:

* stage ``i`` runs on the ranks whose coordinate on ``axis`` is ``i``
  (every other coordinate runs a ring of stages of its own);
* microbatches stream through on the reference's schedule: ``M + P - 1``
  ticks for ``M`` microbatches and ``P`` stages; at tick ``t`` stage 0
  takes microbatch ``t`` and stage ``P - 1`` emits microbatch
  ``t - P + 1``; the bubble is ``(P - 1) / (M + P - 1)``;
* each tick ends in the handoff, ``RankMesh.send_recv`` (gloo ``isend`` /
  ``irecv`` to ``(i + 1) % P`` from ``(i - 1) % P``: the reference's ring
  ``ppermute``);
* the last stage's outputs go to every stage (``RankMesh.broadcast``,
  where the reference ``psum``s them).

``pipeline_forward`` gives the sequential stages' values (bit for bit
where ``stage_fn`` is deterministic: each stage computes on the same
microbatches) and is differentiable end to end. Its backward runs the
schedule in reverse: each tick's handoff goes back by the reverse shift
(``ppermute``'s transpose), each stage takes the VJP of the microbatches
it ran (their graphs kept from the forward, as the reference's autodiff
keeps its residuals), and the broadcast's backward treats every rank's
copy as replicated: every rank holds the same outputs and computes the
same loss, so the last stage keeps its own gradient and the copies' are
dropped. Each stage's parameter gradient is then the sequential run's,
not ``P`` times it. The input is replicated the same way: stage 0's
gradient of ``x`` goes to every stage (``RankMesh.broadcast``), so a
replicated parameter upstream of ``x`` gets the same gradient on every
rank.

Differences by design: a stage computes only on the ticks where it holds
a microbatch (the reference's SPMD program computes every tick and keeps
the result with ``where``); the idle ticks wait in the handoff. The
pipeline is one autograd Function, not a handoff Function a tick: autograd
skips the nodes that do not lead to the inputs whose gradient is asked
(a stage's handoffs before its first microbatch lead to no parameter of
it), so per-tick handoffs would run different reverse shifts on different
ranks and hang; one Function runs the same ``M + P - 2`` reverse shifts on
every rank.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.optim.adamw import tree_leaves, tree_like


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *leaves):
        stage_fn, treedef, mesh, axis, grad = run
        p, m = mesh.shape[axis], x.shape[0]
        idx = mesh.coord[axis]
        ctx.run, ctx.x_grad = run, x.requires_grad
        ctx.tapes = {}                 # tick -> (input, leaves, output)
        buf = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
        outs = torch.zeros_like(x)
        for t in range(m + p - 1):
            if idx == 0 and t < m:
                buf = x[t]                        # stage 0 takes mb t
            if 0 <= t - idx < m:
                if grad:
                    with torch.enable_grad():
                        h = buf.detach().requires_grad_(True)
                        own = [a.detach().requires_grad_(a.requires_grad)
                               for a in leaves]
                        y = stage_fn(tree_like(treedef, own), h)
                    ctx.tapes[t] = (h, own, y)
                    buf = y.detach()
                else:
                    buf = stage_fn(tree_like(treedef, list(leaves)), buf)
            if idx == p - 1 and t >= p - 1:      # stage P - 1 emits
                outs[t - p + 1] = buf
            if t < m + p - 2:
                buf = mesh.send_recv(buf, axis, 1)
        return mesh.broadcast(outs, axis, p - 1)

    @staticmethod
    def backward(ctx, g):
        stage_fn, treedef, mesh, axis, grad = ctx.run
        p, m = mesh.shape[axis], g.shape[0]
        idx = mesh.coord[axis]
        n = len(ctx.needs_input_grad) - 2
        grads = [None] * n
        gx = torch.zeros_like(g) if ctx.x_grad else None
        gbuf = torch.zeros(g.shape[1:], dtype=g.dtype, device=g.device)
        for t in reversed(range(m + p - 1)):
            if t < m + p - 2:
                gbuf = mesh.send_recv(gbuf.contiguous(), axis, -1)
            if idx == p - 1 and t >= p - 1:
                # the broadcast's copies are replicated: this stage's own
                gbuf = gbuf + g[t - p + 1]
            if t in ctx.tapes:
                h, own, y = ctx.tapes.pop(t)
                wrt = [h] + [a for a in own if a.requires_grad]
                got = torch.autograd.grad(y, wrt, gbuf, allow_unused=True)
                gbuf = got[0] if got[0] is not None else torch.zeros_like(h)
                it = iter(got[1:])
                for k, a in enumerate(own):
                    if a.requires_grad:
                        d = next(it)
                        if d is not None:
                            grads[k] = d if grads[k] is None else grads[k] + d
            if idx == 0 and t < m:
                if gx is not None:
                    gx[t] = gbuf
                gbuf = torch.zeros_like(gbuf)
        if gx is not None:
            # ``x`` is replicated: every stage gets stage 0's gradient
            gx = mesh.broadcast(gx, axis, 0)
        return (None, gx, *grads)


def pipeline_forward(stage_fn: Callable, params: Any, x: torch.Tensor, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run the ``M`` microbatches of ``x`` (``[M, mb, ...]``, the same on
    every rank) through ``P = mesh.shape[axis]`` stages: ``stage_fn(
    stage_params, h [mb, ...]) -> [mb, ...]`` with ``params`` a tree of
    leaves stacked ``[P, ...]`` (each rank uses its stage's slice).
    Returns the last stage's ``[M, mb, ...]`` on every rank."""
    idx = mesh.coord[axis]
    leaves = [a[idx] for a in tree_leaves(params)]
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(a.requires_grad for a in leaves))
    run = (stage_fn, params, mesh, axis, grad)
    return _GPipe.apply(run, x, *leaves)


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
