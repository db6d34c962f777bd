"""Plain torch oracles (the counterparts of ``repro.kernels.ref``).

Deliberately simple (per-row weight gather, ``compat.segment_*``) and
O(E·d·f) whatever the layout. They are the values the kernels' plain
versions and the CPU paths are held to.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import compat


def segment_mm_ref(x: torch.Tensor, w: torch.Tensor, seg_ids: torch.Tensor,
                   row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[i] = (row_scale[i] *) x[i] @ w[seg_ids[i]].

    x: [M, k]; w: [R, k, n]; seg_ids: [M] int; row_scale: [M] or None.
    """
    y = torch.einsum("mk,mkn->mn", x, w[seg_ids.long()])
    if row_scale is not None:
        y = y * row_scale[:, None]
    return y


def gather_mm_ref(feats: torch.Tensor, w: torch.Tensor,
                  gather_idx: torch.Tensor, seg_ids: torch.Tensor,
                  row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full GEMM template: Y = (X[G] @ W[T]) with optional per-row scale."""
    return segment_mm_ref(feats[gather_idx.long()], w, seg_ids, row_scale)


def segment_softmax_stats_ref(scores: torch.Tensor, dst: torch.Tensor,
                              num_nodes: int):
    """Per-destination max and sum-exp (the stabilized edge-softmax stats);
    a node with no incoming edge gets max 0 and sum 0."""
    dst = dst.long()
    mx = compat.segment_max(scores, dst, num_nodes)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    den = compat.segment_sum(torch.exp(scores - mx[dst]), dst, num_nodes)
    return mx, den


def edge_softmax_ref(scores: torch.Tensor, dst: torch.Tensor,
                     num_nodes: int) -> torch.Tensor:
    mx, den = segment_softmax_stats_ref(scores, dst, num_nodes)
    dst = dst.long()
    return torch.exp(scores - mx[dst]) / torch.clamp(den[dst], min=1e-38)


def softmax_agg_ref(scores: torch.Tensor, msg: torch.Tensor,
                    dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[v] = sum_{e: dst(e)=v} softmax(scores)_e * msg[e]."""
    att = edge_softmax_ref(scores, dst, num_nodes)
    return compat.segment_sum(att[:, None] * msg, dst, num_nodes)


def weighted_agg_ref(scale: Optional[torch.Tensor], msg: torch.Tensor,
                     dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[v] = sum_{e: dst(e)=v} scale_e * msg[e] (plain traversal agg)."""
    contrib = msg if scale is None else scale[:, None] * msg
    return compat.segment_sum(contrib, dst, num_nodes)
