"""Operators the code generator instantiates, over the kernel wrappers.

The counterpart of ``repro.kernels.ops`` without its three backends: each
op dispatches on the device of its tensors. On the CPU it runs the plain
PyTorch versions (the CPU tests' path); on a CUDA card it launches the
hand-written kernels (``segment_mm.py``, ``traversal.py``) or raises.

Every ``custom_vjp`` of the reference on the ported path is a
``torch.autograd.Function`` here, with the same backward on both devices:

* ``segment_mm_gather`` — forward K1; dX by K4 with W transposed and K11
  summing its rows into the source rows, dW by K5,
  ``dscale = Σ dy · y_pre``;
* ``segment_mm`` — forward K4; the same backward without the scatter;
* ``edge_softmax_agg`` — forward K2 + K3 (with ``fuse_gather=False``, K2
  + K6 over the messages padded into the dst-sorted slots); the backward
  is the reference's plain ops, with the attention rebuilt from K2's saved
  statistics, the compact ``dmsg`` summed by K11 and the softmax VJP's
  per-destination sum by K7 at width 1 over the forward's blocked CSR;
* ``edge_softmax`` — forward K2 and its epilogue; backward the softmax VJP
  (its sum by K7, as above);
* ``weighted_agg`` — forward K7 (``fuse_gather=False``: K8 over padded
  messages); the backward is the reference's plain ops
  (``dmsg = scale · g``, summed into a compact table by K11; ``dscale``).

The GEMMs take the tuner's ``tile_rows`` (a divisor of the layout tile:
K1 / K4 run over the tile -> group map expanded to sub-tiles, as do the
dX of the backward; K5 keeps the layout tile, whose fp64 sum over a
group's rows is the same) and ``tile_n`` (the column slice of a K1 / K4
thread block).

The backward's scatter-adds (``dx``, the compact ``dmsg``, the softmax
VJP's ``segment_sum``), which the reference leaves to XLA, run in a fixed
order without float atomics: K11 over a stable sort of the target index
(``traversal.sorted_segments``, built in the backward with static shapes)
and K7 over the forward's blocked CSR. Gradients on the card are therefore
bit for bit the same from run to run, captured or op by op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import to_device
from repro_torch.kernels import layout as L
from repro_torch.kernels import ref as R
from repro_torch.kernels import segment_mm as SK
from repro_torch.kernels import traversal as TK
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.segment_mm import segment_mm_gather_padded
from repro_torch.kernels.traversal import (seg_softmax_agg_gather_padded,
                                           seg_softmax_agg_padded,
                                           seg_stats_padded, seg_sum_sorted,
                                           seg_weighted_agg_gather_padded,
                                           seg_weighted_agg_padded,
                                           sorted_segments)


# ---------------------------------------------------------------------------
# device-side layout bundles
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class PaddedSegmentsDev:
    row_map: torch.Tensor          # [Rp]
    inv_map: torch.Tensor          # [M]
    t2g: torch.Tensor              # [max(1, T)]
    group_tile_ptr: torch.Tensor   # [R + 1] each group's run of real tiles
    group_chunk_ptr: torch.Tensor  # [R + 1] each group's K5 chunks
    tile: int
    num_groups: int
    num_chunks: int
    chunk_tiles: int               # K5's chunk size (from static shapes)

    def to(self, device, non_blocking: bool = False) -> "PaddedSegmentsDev":
        return _move(self, ("row_map", "inv_map", "t2g", "group_tile_ptr",
                            "group_chunk_ptr"), device, non_blocking)


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedCSRDev:
    edge_map: torch.Tensor         # [Ep] canonical edge index or -1
    edge_map_unique: torch.Tensor  # [Ep] compact (unique-pair) row or -1
    local_dst: torch.Tensor        # [T, tile]
    t2b: torch.Tensor              # [max(1, T)]
    block_tile_ptr: torch.Tensor   # [num_node_blocks + 1] tile range per block
    edge_tile: int
    node_block: int
    num_node_blocks: int
    num_nodes: int

    def to(self, device, non_blocking: bool = False) -> "BlockedCSRDev":
        return _move(self, ("edge_map", "edge_map_unique", "local_dst",
                            "t2b", "block_tile_ptr"), device, non_blocking)


def _move(obj, fields, device, non_blocking):
    return dataclasses.replace(obj, **{
        f: to_device(getattr(obj, f), device, non_blocking) for f in fields})


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def padded_segments_dev(ps: L.PaddedSegments) -> PaddedSegmentsDev:
    """Host tensors of a ``PaddedSegments`` (``.to(device)`` moves them),
    with K5's work split: the real-tile run of every group and its chunks
    of ``outer_chunk_tiles`` of the padded tile count.

    ``num_chunks`` is the static bound ``padded_rows / tile / chunk_tiles
    + G`` of ``device_padded_segments``, not ``group_chunk_ptr[G]``: every
    static field is then a function of the layout's shapes alone, so the
    executors' keys (and the CUDA graphs captured under them) never depend
    on a batch's group sizes. K5 launches that many chunks; those past
    ``group_chunk_ptr[G]`` return before any work."""
    gtp = SK.outer_tile_ptr(ps.seg_sizes, ps.tile)
    ct = SK.outer_chunk_tiles(ps.padded_rows // ps.tile)
    gcp = SK.outer_chunk_ptr(gtp, ct)
    return PaddedSegmentsDev(
        row_map=_tensor(ps.row_map), inv_map=_tensor(ps.inv_map),
        t2g=_tensor(ps.tile_to_group), group_tile_ptr=_tensor(gtp),
        group_chunk_ptr=_tensor(gcp), tile=ps.tile,
        num_groups=ps.num_groups,
        num_chunks=static_chunk_count(ps.padded_rows, ps.tile, ct,
                                      ps.num_groups),
        chunk_tiles=ct)


def static_chunk_count(padded_rows: int, tile: int, chunk_tiles: int,
                       num_groups: int) -> int:
    """K5's launch width for a layout: at least ``group_chunk_ptr[G]`` for
    any group sizes that fit ``padded_rows`` (each group's chunk count
    rounds up by less than one), from static shapes alone."""
    return padded_rows // tile // chunk_tiles + num_groups


def block_tile_ptr(t2b: np.ndarray, num_tiles: int,
                   num_node_blocks: int) -> np.ndarray:
    """[num_node_blocks + 1] offsets of each node block's tile range, from
    the non-decreasing tile -> block map (its first ``num_tiles`` entries).
    A block that owns no tile gets an empty range."""
    counts = np.bincount(np.asarray(t2b[:num_tiles], dtype=np.int64),
                         minlength=num_node_blocks)
    ptr = np.zeros(num_node_blocks + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    return ptr


def blocked_csr_dev(
    bc: L.BlockedCSR, perm_dst: np.ndarray,
    edge_to_unique: Optional[np.ndarray] = None,
) -> BlockedCSRDev:
    """Compose dst-sorted edge_map with perm_dst -> canonical edge indices;
    with ``edge_to_unique``, also the slot -> compact-row map. Host tensors
    (``.to(device)`` moves them)."""
    slots = np.flatnonzero(bc.edge_map >= 0)
    edge_map = np.full(bc.edge_map.shape, -1, dtype=np.int32)
    edge_map[slots] = np.asarray(perm_dst)[bc.edge_map[slots]]
    if edge_to_unique is None:
        edge_map_u = edge_map
    else:
        edge_map_u = np.full(bc.edge_map.shape, -1, dtype=np.int32)
        edge_map_u[slots] = np.asarray(edge_to_unique)[edge_map[slots]]
    t = bc.num_tiles
    return BlockedCSRDev(
        edge_map=_tensor(edge_map),
        edge_map_unique=_tensor(edge_map_u),
        local_dst=_tensor(bc.local_dst.reshape(t, bc.edge_tile)),
        t2b=_tensor(bc.tile_to_block),
        block_tile_ptr=_tensor(block_tile_ptr(bc.tile_to_block, t,
                                              bc.num_node_blocks)),
        edge_tile=bc.edge_tile,
        node_block=bc.node_block,
        num_node_blocks=bc.num_node_blocks,
        num_nodes=bc.num_nodes,
    )


def device_padded_segments(seg_ptr: torch.Tensor,
                           group_of_row: torch.Tensor, tile: int,
                           padded_rows: int) -> PaddedSegmentsDev:
    """``padded_segments_dev`` built on the tensors' device without a
    readback (``layout.device_pad_segments`` plus K5's work split).

    Every field equals the host's at the same ``padded_rows``, the chunk
    count included (``static_chunk_count``). K5 launches that many chunks;
    those past ``group_chunk_ptr[G]`` return before any work."""
    row_map, inv_map, t2g = L.device_pad_segments(seg_ptr, group_of_row,
                                                  tile, padded_rows)
    num_groups = int(seg_ptr.shape[0]) - 1
    ct = SK.outer_chunk_tiles(padded_rows // tile)
    tiles = (seg_ptr[1:] - seg_ptr[:-1] + tile - 1) // tile
    gtp = L.exclusive_cumsum(tiles)
    gcp = L.exclusive_cumsum((tiles + ct - 1) // ct)
    return PaddedSegmentsDev(
        row_map=row_map, inv_map=inv_map, t2g=t2g, group_tile_ptr=gtp,
        group_chunk_ptr=gcp, tile=tile, num_groups=num_groups,
        num_chunks=static_chunk_count(padded_rows, tile, ct, num_groups),
        chunk_tiles=ct)


def device_blocked_csr(dst_ptr: torch.Tensor, dst_sorted: torch.Tensor,
                       perm_dst: torch.Tensor, edge_to_unique: torch.Tensor,
                       edge_tile: int, node_block: int,
                       padded_edges: int) -> BlockedCSRDev:
    """``blocked_csr_dev`` built on the tensors' device without a readback
    (``layout.device_block_csr``); ``block_tile_ptr`` is a binary search of
    the non-decreasing tile -> block map."""
    em_d, local_dst, t2b = L.device_block_csr(
        dst_ptr, dst_sorted, edge_tile, node_block, padded_edges)
    edge_map = torch.where(em_d >= 0, perm_dst[em_d.clamp(min=0).long()], -1)
    edge_map_u = torch.where(
        edge_map >= 0, edge_to_unique[edge_map.clamp(min=0).long()], -1)
    num_nodes = int(dst_ptr.shape[0]) - 1
    nb = (num_nodes + node_block - 1) // node_block
    return BlockedCSRDev(
        edge_map=edge_map.to(torch.int32),
        edge_map_unique=edge_map_u.to(torch.int32),
        local_dst=local_dst.reshape(-1, edge_tile), t2b=t2b,
        block_tile_ptr=L.ptr_of_sorted(t2b, nb), edge_tile=edge_tile,
        node_block=node_block, num_node_blocks=nb, num_nodes=num_nodes)


def pad_rows(x: torch.Tensor, row_map: torch.Tensor,
             fill: float = 0.0) -> torch.Tensor:
    """Gather rows into the padded layout; pad rows get ``fill``."""
    valid = row_map >= 0
    xp = x[row_map.clamp(min=0).long()]
    if x.dim() == 1:
        return torch.where(valid, xp, fill)
    return torch.where(valid[:, None], xp, fill)


# ---------------------------------------------------------------------------
# segment MM (the GEMM template)
# ---------------------------------------------------------------------------
def fit_tile_n(n: int, tile_n: int) -> int:
    """Largest usable column tile: ``tile_n`` capped at ``n``, falling back
    to ``n`` itself when it does not divide evenly (the reference's
    ``_fit_tile_n``)."""
    tn = min(tile_n, n)
    return n if n % tn else tn


def fit_tile_rows(lay_tile: int, tile_rows: Optional[int]) -> int:
    """Effective kernel row tile: a requested sub-tile of the layout tile
    (each sub-tile then still lies within one type segment), or the layout
    tile itself when unset or not a divisor."""
    if tile_rows is None or tile_rows <= 0 or lay_tile % tile_rows:
        return lay_tile
    return tile_rows


@dataclasses.dataclass(frozen=True, eq=False)
class GemmTiles:
    """How K1 / K4 cut one GEMM: the row tile, its tile -> group map, and
    the requested column tile (``None``: the kernel's default)."""

    t2g: torch.Tensor
    tile: int
    tile_n: Optional[int] = None

    def cols(self, width: int) -> Optional[int]:
        """The column slice of a product ``width`` columns wide."""
        return None if self.tile_n is None else fit_tile_n(width,
                                                           self.tile_n)


def gemm_tiles(lay: PaddedSegmentsDev, tile_rows: Optional[int] = None,
               tile_n: Optional[int] = None) -> GemmTiles:
    """The kernel tiling of a GEMM over ``lay`` with the tuner's knobs:
    ``tile_rows`` splits each layout tile into sub-tiles of the same group,
    ``tile_n`` sets the column slice."""
    if tile_n is not None and tile_n <= 0:
        raise ValueError(f"tile_n={tile_n} must be positive")
    tr = fit_tile_rows(lay.tile, tile_rows)
    t2g = lay.t2g
    if tr != lay.tile:
        t2g = t2g.repeat_interleave(lay.tile // tr)
    return GemmTiles(t2g=t2g, tile=tr, tile_n=tile_n)


def _gemm_backward(needs, dy, x, w, scale_p, y_pre, lay: PaddedSegmentsDev,
                   gidx: Optional[torch.Tensor] = None,
                   tiles: Optional[GemmTiles] = None):
    """(dx, dw, dscale) of ``Y_p = X_p @ W[t2g]`` (x ``scale_p``) for the
    inputs ``needs`` flags; ``X_p = x[gidx]`` when ``gidx`` is given, else
    ``x`` itself. dX is K4 over dY with W transposed, cut as the forward
    (``tiles``; then, for a gather, a scatter-add to the source rows), dW
    is K5 over the padded rows at the layout tile. The dX of a gather sums
    K4's rows into the source rows with K11 (``scatter_rows``)."""
    dys = dy if scale_p is None else dy * scale_p
    dx = dw = dscale = None
    if needs[0]:
        t = tiles or gemm_tiles(lay)
        dxg = SK.segment_mm_padded(dys, w, t.t2g, tile=t.tile,
                                   transpose_w=True,
                                   tile_n=t.cols(w.shape[1]))
        dx = dxg if gidx is None else scatter_rows(dxg, gidx, x.shape[0])
    if needs[1]:
        x_p = x if gidx is None else pad_rows(x, gidx)
        # groups that own no tile get exact zeros from K5 (the reference's
        # mask)
        dw = SK.segment_outer_padded(
            x_p, dys, lay.group_tile_ptr, lay.group_chunk_ptr,
            num_groups=lay.num_groups, num_chunks=lay.num_chunks,
            tile=lay.tile, chunk_tiles=lay.chunk_tiles)
    if needs[2]:
        dscale = torch.sum(dy * y_pre, dim=1, keepdim=True)
    return dx, dw, dscale


def _gemm_forward(ctx, kernel, scale_p):
    """The forward of both GEMM Functions: ``kernel(scale)`` with the scale
    as its epilogue or, when the scale needs a gradient, without it, so
    that the pre-scale ``y_pre`` can be saved."""
    if scale_p is not None and ctx.needs_input_grad[2]:
        y_pre = kernel(None)
        return y_pre * scale_p, y_pre
    return kernel(scale_p), None


def scatter_rows(values: torch.Tensor, target: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """``out[r] = Σ_{target[i] = r} values[i]`` (-1: dropped) in a fixed
    order: K11 over a stable sort of ``target``. -> [num_rows, d]."""
    perm, key = sorted_segments(target)
    return seg_sum_sorted(values, perm, key, num_rows)


def _recording(*tensors) -> bool:
    """Will autograd record an op on these inputs?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _SegmentMM(torch.autograd.Function):
    """``Y_p = X_p @ W[t2g]`` (x scale) over pre-padded rows: K4 forward."""

    @staticmethod
    def forward(ctx, x_p, w, scale_p, lay, tiles):
        y, y_pre = _gemm_forward(ctx, lambda s: SK.segment_mm_padded(
            x_p, w, tiles.t2g, s, tile=tiles.tile,
            tile_n=tiles.cols(w.shape[2])), scale_p)
        ctx.lay, ctx.tiles = lay, tiles
        ctx.save_for_backward(x_p, w, scale_p, y_pre)
        return y

    @staticmethod
    def backward(ctx, dy):
        x_p, w, scale_p, y_pre = ctx.saved_tensors
        return (*_gemm_backward(ctx.needs_input_grad, dy, x_p, w, scale_p,
                                y_pre, ctx.lay, tiles=ctx.tiles), None, None)


class _SegmentMMGather(torch.autograd.Function):
    """``Y_p = X[gidx] @ W[t2g]`` (x scale): K1 forward."""

    @staticmethod
    def forward(ctx, x, w, scale_p, gidx, lay, tiles):
        y, y_pre = _gemm_forward(ctx, lambda s: segment_mm_gather_padded(
            x, w, gidx, tiles.t2g, s, tile=tiles.tile,
            tile_n=tiles.cols(w.shape[2])), scale_p)
        ctx.lay, ctx.tiles = lay, tiles
        ctx.save_for_backward(x, w, scale_p, gidx, y_pre)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, scale_p, gidx, y_pre = ctx.saved_tensors
        return (*_gemm_backward(ctx.needs_input_grad, dy, x, w, scale_p,
                                y_pre, ctx.lay, gidx, ctx.tiles),
                None, None, None)


def segment_mm(
    x_sorted: torch.Tensor,                  # [M, k] type-sorted rows
    w: torch.Tensor,                         # [R, k, n]
    lay: PaddedSegmentsDev,
    row_scale: Optional[torch.Tensor] = None,  # [M]
    tile_n: Optional[int] = None,            # K4's column slice (tuner knob)
    tile_rows: Optional[int] = None,         # sub-tile of lay.tile (tuner)
) -> torch.Tensor:
    """Y = X @ W[type] (+ per-row scale), X presorted by type. -> [M, n].

    K4 over the padded rows; differentiable (K4 and K5 backward)."""
    if x_sorted.shape[0] == 0:
        return x_sorted.new_zeros((0, w.shape[-1]))
    x_p = pad_rows(x_sorted, lay.row_map)
    scale_p = None
    if row_scale is not None:
        scale_p = pad_rows(row_scale, lay.row_map)[:, None]
    tiles = gemm_tiles(lay, tile_rows, tile_n)
    if _recording(x_p, w, scale_p):
        y_p = _SegmentMM.apply(x_p, w, scale_p, lay, tiles)
    else:
        y_p = SK.segment_mm_padded(x_p, w, tiles.t2g, scale_p,
                                   tile=tiles.tile,
                                   tile_n=tiles.cols(w.shape[-1]))
    return y_p[lay.inv_map.long()]


def segment_mm_gather(
    x_src: torch.Tensor,                     # [Nx, k] ungathered source rows
    w: torch.Tensor,                         # [R, k, n]
    lay: PaddedSegmentsDev,
    gather_rows: torch.Tensor,               # [Rp] slot -> source row, or -1
    row_scale: Optional[torch.Tensor] = None,  # [M] canonical per-row scale
    tile_n: Optional[int] = None,            # K1's column slice (tuner knob)
    tile_rows: Optional[int] = None,         # sub-tile of lay.tile (tuner)
) -> torch.Tensor:
    """Y = X[G] @ W[type] with the gather inside K1. -> [M, n].

    ``gather_rows`` is the padded gather-index layout
    (``layout.compose_gather_rows``), so no ``[Rp, k]`` copy of the input
    exists outside the kernel on the forward; the backward builds it for
    K5 only. Differentiable in ``x_src``, ``w`` and ``row_scale``."""
    n = w.shape[-1]
    if lay.inv_map.shape[0] == 0:
        # empty block (e.g. a sampled hop with no edges): no tiles to sweep
        return x_src.new_zeros((0, n))
    scale_p = None
    if row_scale is not None:
        scale_p = pad_rows(row_scale, lay.row_map)[:, None]
    tiles = gemm_tiles(lay, tile_rows, tile_n)
    if _recording(x_src, w, scale_p):
        y_p = _SegmentMMGather.apply(x_src, w, scale_p, gather_rows, lay,
                                     tiles)
    else:
        y_p = segment_mm_gather_padded(x_src, w, gather_rows, tiles.t2g,
                                       scale_p, tile=tiles.tile,
                                       tile_n=tiles.cols(n))
    return y_p[lay.inv_map.long()]


# ---------------------------------------------------------------------------
# traversal ops
# ---------------------------------------------------------------------------
def _padded_scores(scores: torch.Tensor, bc: BlockedCSRDev) -> torch.Tensor:
    """Canonical per-edge scores -> [T, tile] dst-sorted slots (pads -1e30)."""
    valid = bc.edge_map >= 0
    sp = torch.where(valid, scores[bc.edge_map.clamp(min=0).long()],
                     TK.NEG_INF)
    return sp.reshape(-1, bc.edge_tile)


def _stats(scores: torch.Tensor, bc: BlockedCSRDev):
    scores_p = _padded_scores(scores, bc)
    mx, den = seg_stats_padded(
        scores_p, bc.local_dst, bc.t2b, bc.block_tile_ptr,
        node_block=bc.node_block, num_node_blocks=bc.num_node_blocks)
    return scores_p, mx, den


def _attention(scores, dst, mx, den):
    """Per-edge softmax weights from K2's per-destination statistics."""
    d = dst.long()
    return (torch.exp(scores - mx.reshape(-1)[d])
            / torch.clamp(den.reshape(-1)[d], min=1e-38))


def _softmax_vjp(att, datt, dst, num_nodes, bc: BlockedCSRDev):
    """dscores of ``att = edge_softmax(scores)`` given ``datt``; the
    per-destination sum ``Σ_{e→v} att_e · datt_e`` is K7 at width 1 over
    the forward's blocked CSR (scale 1 on real slots, 0 on pads)."""
    c = seg_weighted_agg_gather_padded(
        _padded_scale(None, bc, att), (att * datt)[:, None], bc.edge_map,
        bc.local_dst, bc.t2b, bc.block_tile_ptr, node_block=bc.node_block,
        num_node_blocks=bc.num_node_blocks)[:num_nodes, 0]
    return att * (datt - c[dst.long()])


def _msg_slot_map(bc: BlockedCSRDev,
                  msg_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """Padded slot -> message-row map for in-kernel message gathers."""
    if msg_rows is None:
        return bc.edge_map
    return torch.where(bc.edge_map >= 0,
                       msg_rows[bc.edge_map.clamp(min=0).long()],
                       -1).to(torch.int32)


class _EdgeSoftmaxAgg(torch.autograd.Function):
    """The fused softmax + aggregation: K2 then K3 forward (without a slot
    map, K6 over the messages padded into the slots: ``msg`` is then in
    canonical edge order); the backward is the reference's plain ops on the
    attention rebuilt from K2's saved ``mx``/``den`` (no second K2
    launch)."""

    @staticmethod
    def forward(ctx, scores, msg, dst, msg_rows, num_nodes, bc,
                msg_slot_map):
        scores_p, mx, den = _stats(scores, bc)
        kw = dict(node_block=bc.node_block,
                  num_node_blocks=bc.num_node_blocks)
        if msg_slot_map is None:
            out = seg_softmax_agg_padded(
                scores_p, pad_rows(msg, bc.edge_map), bc.local_dst, bc.t2b,
                bc.block_tile_ptr, mx, den, **kw)
        else:
            out = seg_softmax_agg_gather_padded(
                scores_p, msg, msg_slot_map, bc.local_dst, bc.t2b,
                bc.block_tile_ptr, mx, den, **kw)
        ctx.num_nodes, ctx.bc = num_nodes, bc
        ctx.save_for_backward(scores, msg, dst, msg_rows, mx, den)
        return out[:num_nodes]

    @staticmethod
    def backward(ctx, dout):
        scores, msg, dst, msg_rows, mx, den = ctx.saved_tensors
        att = _attention(scores, dst, mx, den)
        g = dout[dst.long()]                            # [E, d]
        dscores = dmsg = None
        if msg_rows is None:
            msg_e = msg
            if ctx.needs_input_grad[1]:
                dmsg = att[:, None] * g
        else:                                           # compact messages
            rows = msg_rows.long()
            msg_e = msg[rows]
            if ctx.needs_input_grad[1]:
                dmsg = scatter_rows(att[:, None] * g, msg_rows,
                                    msg.shape[0])
        if ctx.needs_input_grad[0]:
            datt = torch.sum(msg_e * g, dim=-1)
            dscores = _softmax_vjp(att, datt, dst, ctx.num_nodes, ctx.bc)
        return dscores, dmsg, None, None, None, None, None


class _EdgeSoftmax(torch.autograd.Function):
    """Per-edge softmax from K2's statistics; backward the softmax VJP."""

    @staticmethod
    def forward(ctx, scores, dst, num_nodes, bc):
        _, mx, den = _stats(scores, bc)
        att = _attention(scores, dst, mx, den)
        ctx.num_nodes, ctx.bc = num_nodes, bc
        ctx.save_for_backward(att, dst)
        return att

    @staticmethod
    def backward(ctx, datt):
        att, dst = ctx.saved_tensors
        return (_softmax_vjp(att, datt, dst, ctx.num_nodes, ctx.bc), None,
                None, None)


def edge_softmax_agg(
    scores: torch.Tensor,        # [E] canonical order
    msg: torch.Tensor,           # [Em, d] in storage order (see msg_rows)
    dst: torch.Tensor,           # [E] canonical destination ids
    num_nodes: int,
    bc: Optional[BlockedCSRDev] = None,
    msg_rows: Optional[torch.Tensor] = None,    # [E] edge -> msg row
    msg_slot_map: Optional[torch.Tensor] = None,  # [Ep] precomposed map
    fuse_gather: bool = True,
) -> torch.Tensor:
    """out[v] = Σ_{e→v} softmax(scores)_e · msg_e — the fused traversal
    region, K2 then K3; differentiable in ``scores`` and ``msg``.

    ``msg_rows`` lets messages live in a compact storage (the unique
    (src, etype) table with ``edge_to_unique`` as the map); K3 gathers them
    per slot, so no dst-sorted ``[Ep, d]`` copy is materialized.
    ``fuse_gather=False`` materializes that copy (``msg[msg_rows]`` padded
    into the slots by ``bc.edge_map``) and runs K6 in place of K3, the
    reference's materialized-gather variant."""
    if dst.shape[0] == 0:
        return msg.new_zeros((num_nodes, msg.shape[-1]))
    if bc is None:
        if msg.device.type != "cpu":
            raise ValueError("edge_softmax_agg on CUDA needs the blocked "
                             "CSR layout (bc)")
        msg_e = msg if msg_rows is None else msg[msg_rows.long()]
        return R.softmax_agg_ref(scores, msg_e, dst, num_nodes)
    if not fuse_gather:
        msg_e = msg if msg_rows is None else msg[msg_rows.long()]
        return _EdgeSoftmaxAgg.apply(scores, msg_e, dst, None, num_nodes,
                                     bc, None)
    if msg_slot_map is None:
        msg_slot_map = _msg_slot_map(bc, msg_rows)
    return _EdgeSoftmaxAgg.apply(scores, msg, dst, msg_rows, num_nodes, bc,
                                 msg_slot_map)


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                 bc: Optional[BlockedCSRDev] = None) -> torch.Tensor:
    """Per-edge stabilized softmax over incoming-edge groups.

    With ``bc`` the statistics come from K2 (deterministic, no atomics) and
    the backward is the softmax VJP; without it, the CPU oracle."""
    if dst.shape[0] == 0:
        return scores.new_zeros((0,))
    if bc is None:
        if scores.device.type != "cpu":
            raise ValueError("edge_softmax on CUDA needs the blocked CSR "
                             "layout (bc)")
        return R.edge_softmax_ref(scores, dst, num_nodes)
    return _EdgeSoftmax.apply(scores, dst, num_nodes, bc)


def _padded_scale(scale: Optional[torch.Tensor], bc: BlockedCSRDev,
                  like: torch.Tensor) -> torch.Tensor:
    """Canonical per-edge scales -> [T, tile] dst-sorted slots (pads 0;
    ``None`` means ones, as the reference's op takes it)."""
    valid = bc.edge_map >= 0
    if scale is None:
        sp = valid.to(like.dtype)
    else:
        sp = torch.where(valid, scale[bc.edge_map.clamp(min=0).long()],
                         scale.new_zeros(()))
    return sp.reshape(-1, bc.edge_tile)


class _WeightedAgg(torch.autograd.Function):
    """``out[v] = Σ_{e→v} scale_e · msg_e``: K7 forward (without a slot map,
    K8 over the messages padded into the slots); the backward is the
    reference's plain VJP (no second K7 launch)."""

    @staticmethod
    def forward(ctx, scale, msg, dst, msg_rows, num_nodes, bc,
                msg_slot_map):
        scale_p = _padded_scale(scale, bc, msg)
        kw = dict(node_block=bc.node_block,
                  num_node_blocks=bc.num_node_blocks)
        if msg_slot_map is None:
            out = seg_weighted_agg_padded(
                scale_p, pad_rows(msg, bc.edge_map), bc.local_dst, bc.t2b,
                bc.block_tile_ptr, **kw)
        else:
            out = seg_weighted_agg_gather_padded(
                scale_p, msg, msg_slot_map, bc.local_dst, bc.t2b,
                bc.block_tile_ptr, **kw)
        ctx.save_for_backward(scale, msg, dst, msg_rows)
        return out[:num_nodes]

    @staticmethod
    def backward(ctx, dout):
        scale, msg, dst, msg_rows = ctx.saved_tensors
        g = dout[dst.long()]                            # [E, d]
        contrib = g if scale is None else scale[:, None] * g
        dscale = dmsg = None
        if msg_rows is None:
            msg_e = msg
            if ctx.needs_input_grad[1]:
                dmsg = contrib
        else:                                           # compact messages
            rows = msg_rows.long()
            msg_e = msg[rows] if ctx.needs_input_grad[0] else None
            if ctx.needs_input_grad[1]:
                dmsg = scatter_rows(contrib, msg_rows, msg.shape[0])
        if ctx.needs_input_grad[0]:
            dscale = torch.sum(msg_e * g, dim=-1)
        return dscale, dmsg, None, None, None, None, None


def weighted_agg(
    scale: Optional[torch.Tensor],   # [E] or None (ones)
    msg: torch.Tensor,               # [Em, d] in storage order
    dst: torch.Tensor,
    num_nodes: int,
    bc: Optional[BlockedCSRDev] = None,
    msg_rows: Optional[torch.Tensor] = None,
    msg_slot_map: Optional[torch.Tensor] = None,
    fuse_gather: bool = True,
) -> torch.Tensor:
    """out[v] = Σ_{e→v} scale_e · msg_e (gather semantics as
    ``edge_softmax_agg``) — K7 over the blocked CSR ``bc`` (K8 over the
    padded messages with ``fuse_gather=False``); differentiable in
    ``scale`` and ``msg``. Without ``bc``, the CPU oracle."""
    if dst.shape[0] == 0:
        return msg.new_zeros((num_nodes, msg.shape[-1]))
    if bc is None:
        if msg.device.type != "cpu":
            raise ValueError("weighted_agg on CUDA needs the blocked CSR "
                             "layout (bc)")
        msg_e = msg if msg_rows is None else msg[msg_rows.long()]
        return R.weighted_agg_ref(scale, msg_e, dst, num_nodes)
    if not fuse_gather:
        msg_e = msg if msg_rows is None else msg[msg_rows.long()]
        return _WeightedAgg.apply(scale, msg_e, dst, None, num_nodes, bc,
                                  None)
    if msg_slot_map is None:
        msg_slot_map = _msg_slot_map(bc, msg_rows)
    return _WeightedAgg.apply(scale, msg, dst, msg_rows, num_nodes, bc,
                              msg_slot_map)


_COUNTED = (SK.segment_mm_gather_padded, TK.seg_stats_padded,
            TK.seg_softmax_agg_gather_padded, SK.segment_mm_padded,
            SK.segment_outer_padded, TK.seg_softmax_agg_padded,
            TK.seg_weighted_agg_gather_padded, TK.seg_weighted_agg_padded,
            flash_attention, TK.seg_sum_sorted)


def _counted():
    # K9 lives in ``sampling_ops``, which imports this module
    from repro_torch.kernels.sampling_ops import candidate_keys
    return _COUNTED + (candidate_keys,)


def launch_counts() -> dict:
    """Launches of each ported kernel so far in this process."""
    return {fn.__name__: fn.launches for fn in _counted()}


def reset_launch_counts() -> None:
    for fn in _counted():
        fn.launches = 0
