"""Mixture-of-Experts FFN (the port's copy of ``repro.nn.moe``).

The expert layer is an edgewise typed linear layer in the paper's sense:
tokens = edges, experts = edge types, router = type assignment, gate = the
fused per-row scalar, capacity padding = tile-aligned segments. Tokens are
routed into a capacity-bucketed ``[E, cap, D]`` buffer, so the expert
products cost the routed compute, not the E/k x dense-masked blowup.

The expert products stay ``torch.bmm``: the reference computes them as
einsums outside any Pallas kernel (its docstring's "feeds
``kernels/segment_mm.py``" is not what its code does).

Differences by design: only the reference's dense dispatch
(``_moe_ffn_dense``) is ported. On a mesh the expert stacks are gathered
whole and the batch's tokens gathered over its axes (``lm/model.py``), so
every rank runs this dispatch; the expert-parallel path (``_moe_ffn_ep``,
an all-to-all over the model axis, the reference's v-B) waits in
``ROADMAP.md`` §1. The dispatch
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

from repro_torch.nn.common import dense_init, shard


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


def moe_ffn(params: Dict, x: torch.Tensor, num_experts: int, k: int,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, Dict]:
    """``x [B, S, D]`` through the top-``k`` experts: ``(out [B, S, D],
    {"lb_loss", "dropped"})``, step for step the reference's
    ``_moe_ffn_dense``. A token's slot in its expert is its rank among the
    ``(token, choice)`` pairs routed there, in token-major order
    (``positions``); pairs ranked at or past the capacity are dropped (they
    add nothing)."""
    b, s, d = x.shape
    t, e = b * s, num_experts
    xf = x.reshape(t, d)
    cap = capacity(t, e, k, capacity_factor)
    probs, gate, idx = route(xf, params["router"], k)

    # position of each (token, choice) within its expert
    idx_flat = idx.reshape(-1)
    pos = positions(idx_flat, e).reshape(t, k)                   # [T, k]
    keep = pos < cap
    dropped = 1.0 - keep.float().mean()

    # dispatch: write the kept rows into the [E, cap, D] segment buffer
    sel = keep.reshape(-1).nonzero()[:, 0]
    buf = x.new_zeros((e, cap, d)).index_put(
        (idx_flat[sel], pos.reshape(-1)[sel]), xf[sel // k])
    buf = shard("moe_dispatch", buf)

    # per-expert segment GEMMs (the typed linear layer)
    h = F.silu(torch.bmm(buf, params["w_gate"]))
    h = shard("moe_hidden", h * torch.bmm(buf, params["w_up"]))
    y = shard("moe_dispatch", torch.bmm(h, params["w_down"]))   # [E, cap, D]

    # combine: gather each (token, choice) row, fuse the gate scalar
    out = y[idx, torch.clamp(pos, max=cap - 1)]                  # [T, k, D]
    out = out * (gate * keep).to(out.dtype)[..., None]
    out = out.sum(dim=1).reshape(b, s, d)

    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)
    chosen = torch.zeros((t, e), dtype=torch.bool, device=x.device)
    ce = chosen.scatter_(1, idx, True).float().mean(dim=0)
    lb_loss = e * torch.sum(me * ce)
    return out, {"lb_loss": lb_loss, "dropped": dropped}
