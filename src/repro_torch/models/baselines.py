"""Vanilla baseline implementations (the systems Hector is compared against),
in plain torch ops over ``GraphTensors``: the port's copy of
``repro.models.baselines``.

They reproduce the inefficiencies the paper profiles in §2.3 / Fig. 4 with
numerics identical to the generated code (same parameter dicts as the
``HectorModule`` plans), and serve as the model-level oracle of the tests:

* ``typed_linear_replicated`` — materializes the [E, d_in, d_out] per-edge
  weight tensor (PyG FastRGCNConv / bmm pattern);
* ``typed_linear_per_type_loop`` — one dense GEMM *per relation* with a
  masked scatter (DGL HeteroConv's Python loop);
* full vanilla RGCN / RGAT / HGT / rgcn_cat forwards built from those
  pieces (no reordering, no compaction).

Nothing on the card's main path calls them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import compat
from repro_torch.core.graph import GraphTensors
from repro_torch.kernels import ref as R

_ACT = {"relu": lambda x: torch.clamp(x, min=0), "tanh": torch.tanh}


def typed_linear_replicated(x: torch.Tensor, w: torch.Tensor,
                            types: torch.Tensor) -> torch.Tensor:
    """bmm with replicated weights: W'[i] = W[T[i]] (§2.3's anti-pattern)."""
    w_rep = w[types.long()]              # [M, d_in, d_out], materialized
    return torch.einsum("mk,mkn->mn", x, w_rep)


def typed_linear_per_type_loop(x: torch.Tensor, w: torch.Tensor,
                               types: torch.Tensor) -> torch.Tensor:
    """Per-relation GEMM + mask (serialized small kernels)."""
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for r in range(w.shape[0]):  # python loop == serial kernel launches
        mask = (types == r)[:, None]
        out = out + torch.where(mask, x @ w[r], x.new_zeros(()))
    return out


def _maybe_loop(x, w, types, per_type_loop: bool):
    if per_type_loop:
        return typed_linear_per_type_loop(x, w, types)
    return typed_linear_replicated(x, w, types)


def _mean_agg(msg: torch.Tensor, gt: GraphTensors) -> torch.Tensor:
    agg = compat.segment_sum(msg, gt.dst, gt.num_nodes)
    deg = (gt.dst_ptr[1:] - gt.dst_ptr[:-1]).to(agg.dtype)
    return agg / torch.clamp(deg, min=1.0)[:, None]


# ---------------------------------------------------------------------------
# full vanilla model forwards (match HectorModule numerics)
# ---------------------------------------------------------------------------
def rgcn_vanilla(params: Dict, gt: GraphTensors, feats: Dict,
                 activation: str = "relu", per_type_loop: bool = False):
    x = feats["feature"]
    msg = _maybe_loop(x[gt.src.long()], params["W_rel"], gt.etype,
                      per_type_loop)
    h = _mean_agg(msg, gt) + x @ params["W_self"]
    return {"h_out": _ACT[activation](h)}


def rgcn_cat_vanilla(params: Dict, gt: GraphTensors, feats: Dict,
                     activation: str = "relu", per_type_loop: bool = False):
    """Concat-combine RGCN (models/zoo.py): concat(agg, self) @ W_out."""
    x = feats["feature"]
    msg = _maybe_loop(x[gt.src.long()], params["W_rel"], gt.etype,
                      per_type_loop)
    h = torch.cat([_mean_agg(msg, gt), x @ params["W_self"]], dim=-1)
    return {"h_out": _ACT[activation](h @ params["W_out"])}


def rgat_vanilla(params: Dict, gt: GraphTensors, feats: Dict,
                 slope: float = 0.01, per_type_loop: bool = False):
    x = feats["feature"]
    et = gt.etype.long()
    hs = _maybe_loop(x[gt.src.long()], params["W_rel"], et, per_type_loop)
    ht = _maybe_loop(x[gt.dst.long()], params["W_rel"], et, per_type_loop)
    atts = torch.sum(hs * params["w_att_src"][et], dim=-1)
    attt = torch.sum(ht * params["w_att_dst"][et], dim=-1)
    raw = atts + attt
    raw = torch.where(raw > 0, raw, slope * raw)
    att = R.edge_softmax_ref(raw, gt.dst, gt.num_nodes)
    return {"h_out": compat.segment_sum(att[:, None] * hs, gt.dst,
                                        gt.num_nodes)}


def hgt_vanilla(params: Dict, gt: GraphTensors, feats: Dict,
                per_type_loop: bool = False):
    x = feats["feature"]
    d = params["W_K"].shape[-1]
    kk = _maybe_loop(x, params["W_K"], gt.node_type, per_type_loop)
    qq = _maybe_loop(x, params["W_Q"], gt.node_type, per_type_loop)
    vv = _maybe_loop(x, params["W_V"], gt.node_type, per_type_loop)
    src, dst = gt.src.long(), gt.dst.long()
    katt = _maybe_loop(kk[src], params["W_att"], gt.etype, per_type_loop)
    msg = _maybe_loop(vv[src], params["W_msg"], gt.etype, per_type_loop)
    raw = torch.sum(katt * qq[dst], dim=-1) / math.sqrt(d)
    att = R.edge_softmax_ref(raw, gt.dst, gt.num_nodes)
    return {"h_out": compat.segment_sum(att[:, None] * msg, gt.dst,
                                        gt.num_nodes)}


VANILLA = {"rgcn": rgcn_vanilla, "rgat": rgat_vanilla, "hgt": hgt_vanilla,
           "rgcn_cat": rgcn_cat_vanilla}
