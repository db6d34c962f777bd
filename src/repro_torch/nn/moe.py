"""Mixture-of-Experts FFN (the port's copy of ``repro.nn.moe``).

The expert layer is an edgewise typed linear layer in the paper's sense:
tokens = edges, experts = edge types, router = type assignment, gate = the
fused per-row scalar, capacity padding = tile-aligned segments. Tokens are
routed into a capacity-bucketed ``[E, cap, D]`` buffer, so the expert
products cost the routed compute, not the E/k x dense-masked blowup.

The expert products stay ``torch.bmm``: the reference computes them as
einsums outside any Pallas kernel (its docstring's "feeds
``kernels/segment_mm.py``" is not what its code does).

On a mesh (``launch/partitioning.py``) two paths run, as in the
reference. Where the reference takes its expert-parallel branch (v-B,
``moe_ep``; ``Partitioner.ep_dup``) ``_moe_ffn_ep`` is step for step its
``_moe_ffn_ep``: each model rank routes its own slice of its data shard's
tokens, an all-to-all over ``model`` takes the ``[E, cap, D]`` buffer to
the experts' owners, each rank runs its ``E / tp`` experts (or, with
fewer experts than ranks, its copy's share of one expert's capacity
rows), the reverse all-to-all brings the rows back, and the slices are
all-gathered over ``model``. Elsewhere the expert stacks are gathered
whole and the batch's tokens gathered over its axes (``lm/model.py``),
so every rank runs the dense dispatch. ``moe_ffn_ep_plain`` computes on
one device what the ranks of the EP branch compute (the tests' and
``chip_smoke.py``'s yardstick; nothing on the main path calls it).

Differences by design: EP routes, caps and drops per token slice, with
``capacity(t_slice, ..., multiple=8 * dup)``, and its ``lb_loss`` /
``dropped`` are means of the slices' (the reference's ``pmean``): at a
capacity factor that drops, EP is not the dense dispatch's function
(nor is it in the reference). The dispatch
writes only the kept rows, with a plain index assignment: kept ``(expert,
position)`` pairs are unique, so it needs neither the reference's
accumulating scatter nor its trash row, and its backward is a gather (the
input's rows sum their kept copies through the sort-based accumulating
``index_put_``, as the embedding's backward does): deterministic.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.common import dense_init, mesh_ctx, shard


def init_moe(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             num_experts: int, dtype: torch.dtype, lead: tuple = ()) -> Dict:
    """Router (fp32 whatever ``dtype``, as in the reference) and the
    experts' gated-SiLU weights ``[E, D, F]`` / ``[E, F, D]``."""
    e = num_experts
    return {
        "router": dense_init((d_model, e), torch.float32, generator,
                             lead=lead),
        "w_gate": dense_init((e, d_model, d_ff), dtype, generator, lead=lead),
        "w_up": dense_init((e, d_model, d_ff), dtype, generator, lead=lead),
        "w_down": dense_init((e, d_ff, d_model), dtype, generator,
                             fan_in=d_ff, lead=lead),
    }


def capacity(tokens: int, num_experts: int, k: int, factor: float,
             multiple: int = 8) -> int:
    c = math.ceil(tokens * k * factor / num_experts)
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


def route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """The fp32 router: ``(probs [T, E], gate [T, k] renormalized, idx [T,
    k])``."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def positions(idx_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (token, choice) pair's slot in its expert: the number of
    earlier pairs, in token-major order, routed to the same expert. The
    reference counts it by a cumsum over the ``[T*k, E]`` one-hot; here a
    stable sort by expert ranks the pairs (the same integers, without a
    scan over ``T*k`` rows of ``E`` int64s)."""
    order = torch.argsort(idx_flat, stable=True)
    counts = torch.bincount(idx_flat, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(idx_flat.numel(), device=idx_flat.device)
    return torch.empty_like(idx_flat).index_put_(
        (order,), rank - starts[idx_flat[order]])


def _route_and_fill(xf: torch.Tensor, router: torch.Tensor, e: int, k: int,
                    cap: int):
    """Route ``xf [T, D]`` and write the kept rows into the ``[e, cap, D]``
    segment buffer: ``(buf, idx, pos, gate, keep, {"lb_loss",
    "dropped"})``. A ``(token, choice)`` pair's slot in its expert is its
    rank among the pairs routed there, in token-major order
    (``positions``); pairs ranked at or past the capacity are dropped."""
    t, d = xf.shape
    probs, gate, idx = route(xf, router, k)
    idx_flat = idx.reshape(-1)
    pos = positions(idx_flat, e).reshape(t, k)                   # [T, k]
    keep = pos < cap
    sel = keep.reshape(-1).nonzero()[:, 0]
    buf = xf.new_zeros((e, cap, d)).index_put(
        (idx_flat[sel], pos.reshape(-1)[sel]), xf[sel // k])
    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)
    chosen = torch.zeros((t, e), dtype=torch.bool, device=xf.device)
    ce = chosen.scatter_(1, idx, True).float().mean(dim=0)
    aux = {"lb_loss": e * torch.sum(me * ce),
           "dropped": 1.0 - keep.float().mean()}
    return buf, idx, pos, gate, keep, aux


def _experts(buf: torch.Tensor, w_gate, w_up, w_down,
             check=shard) -> torch.Tensor:
    """The per-expert segment GEMMs (the typed linear layer); ``check``
    sees the hidden rows (the reference's EP body names none)."""
    h = F.silu(torch.bmm(buf, w_gate))
    h = check("moe_hidden", h * torch.bmm(buf, w_up))
    return torch.bmm(h, w_down)


def _combine(y: torch.Tensor, idx, pos, gate, keep) -> torch.Tensor:
    """Each ``(token, choice)`` row of ``y [E, cap, D]`` times its gate,
    summed over the choices: ``[T, D]``."""
    out = y[idx, torch.clamp(pos, max=y.shape[1] - 1)]           # [T, k, D]
    out = out * (gate * keep).to(out.dtype)[..., None]
    return out.sum(dim=1)


def moe_ffn(params: Dict, x: torch.Tensor, num_experts: int, k: int,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, Dict]:
    """``x [B, S, D]`` through the top-``k`` experts: ``(out [B, S, D],
    {"lb_loss", "dropped"})``. On a mesh whose step takes the EP branch
    (the resolver's ``run.ep``) ``x`` is the rank's data shard and this is
    ``_moe_ffn_ep``; otherwise it is step for step the reference's
    ``_moe_ffn_dense`` over the tokens given."""
    ctx = mesh_ctx()
    if ctx is not None and ctx.run.ep:
        return _moe_ffn_ep(params, x, num_experts, k, capacity_factor, ctx)
    return _moe_ffn_dense(params, x, num_experts, k, capacity_factor)


def _moe_ffn_dense(params, x, num_experts, k, capacity_factor):
    b, s, d = x.shape
    t, e = b * s, num_experts
    cap = capacity(t, e, k, capacity_factor)
    buf, idx, pos, gate, keep, aux = _route_and_fill(
        x.reshape(t, d), params["router"], e, k, cap)
    buf = shard("moe_dispatch", buf)
    y = shard("moe_dispatch", _experts(buf, params["w_gate"], params["w_up"],
                                       params["w_down"]))
    out = _combine(y, idx, pos, gate, keep).reshape(b, s, d)
    return out, aux


def _ep_shape(e: int, tp: int, t_local: int, k: int,
              capacity_factor: float) -> Tuple[int, int, int, int]:
    """``(e_local, dup, t_slice, cap)`` of the EP branch: each rank's
    experts (``dup`` copies of each where ``E < tp``), its slice of the
    data shard's tokens and that slice's capacity."""
    e_local, dup = (e // tp, 1) if e % tp == 0 else (1, tp // e)
    t_slice = t_local // tp
    return e_local, dup, t_slice, capacity(t_slice, e, k, capacity_factor,
                                           multiple=8 * dup)


def _moe_ffn_ep(params, x, num_experts, k, capacity_factor, ctx):
    """v-B on this rank: ``x [b_local, S, D]`` is the rank's data shard,
    replicated over ``model``; the expert stacks are its ``E / tp``
    experts (``dup == 1``) or every expert (``dup > 1``, gathered)."""
    b, s, d = x.shape
    e, tp, m = num_experts, ctx.tp, ctx.model_index()
    e_local, dup, t_slice, cap = _ep_shape(e, tp, b * s, k, capacity_factor)
    xf = ctx.model_slice(x.reshape(b * s, d))                 # [t_slice, D]
    buf, idx, pos, gate, keep, aux = _route_and_fill(
        xf, params["router"], e, k, cap)
    # dispatch: (expert, capacity-slice) blocks to their owners
    n = e_local * cap // dup
    recv = ctx.exchange(buf.reshape(tp, n, d))
    tok = recv.reshape(tp, e_local, cap // dup, d).transpose(0, 1).reshape(
        e_local, tp * cap // dup, d)
    w = [params[name] for name in ("w_gate", "w_up", "w_down")]
    if dup > 1:                         # this rank's copy of expert m // dup
        w = [t[m // dup:m // dup + 1] for t in w]
    y = _experts(tok, *w, check=lambda name, t: t)          # [e_local, ., D]
    # combine: the reverse all-to-all back to the source ranks
    y = y.reshape(e_local, tp, cap // dup, d).transpose(0, 1).reshape(
        tp, n, d)
    y = ctx.exchange(y.contiguous()).reshape(e, cap, d)
    out = ctx.model_gather(_combine(y, idx, pos, gate, keep))   # [b*s, D]
    # the slices' means over model (the step averages over the batch's axes)
    aux = {key: ctx.reduce_model(v / tp) for key, v in aux.items()}
    return out.reshape(b, s, d), aux


def moe_ffn_ep_plain(params: Dict, x: torch.Tensor, num_experts: int, k: int,
                     capacity_factor: float = 1.25, *, tp: int,
                     dp: int = 1) -> Tuple[torch.Tensor, Dict]:
    """On one device, what the ranks of a ``(dp, tp)`` mesh compute on
    v-B's EP branch for the global ``x [B, S, D]`` and whole parameters:
    every (data shard, model rank) token slice routed, capped and dropped
    on its own, the experts run on every slice's kept rows, the aux means
    over the slices. Where the branch is not taken (``E`` and ``tp``
    indivisible, ``dp`` not dividing ``B``, ``tp`` not dividing a shard's
    tokens) it is the dense dispatch over the whole batch, as on the
    mesh."""
    b, s, d = x.shape
    e = num_experts
    if not ((e % tp == 0 or tp % e == 0) and b % dp == 0
            and (b // dp * s) % tp == 0):
        return _moe_ffn_dense(params, x, e, k, capacity_factor)
    _, _, t_slice, cap = _ep_shape(e, tp, b // dp * s, k, capacity_factor)
    slices = [_route_and_fill(xs, params["router"], e, k, cap)
              for xs in x.reshape(dp * tp, t_slice, d)]
    bufs = torch.stack([sl[0] for sl in slices], dim=1)      # [e, n, cap, D]
    y = _experts(bufs.reshape(e, -1, d), params["w_gate"], params["w_up"],
                 params["w_down"]).reshape(bufs.shape)
    out = torch.cat([_combine(y[:, i], *sl[1:5])
                     for i, sl in enumerate(slices)])
    aux = {key: torch.stack([sl[5][key] for sl in slices]).mean()
           for key in ("lb_loss", "dropped")}
    return out.reshape(b, s, d), aux
