"""Host-side tile-aligned layouts for the two Hector templates on TPU.

GPU Hector applies gather/scatter lists *inside* kernels at per-element
granularity. The MXU wants contiguous (8,128)-aligned tiles, so the TPU
adaptation moves irregularity to **block granularity**:

* ``PaddedSegments`` — for the GEMM template: rows presorted by type are
  padded so every type segment occupies whole row-tiles; a scalar-prefetched
  ``tile_to_group`` map then selects the weight block per tile. This is the
  paper's "presort to enable segment MM" taken one step further (tile-aligned
  so a single kernel sweeps all relations without per-row indirection).

* ``BlockedCSR`` — for the traversal template: destination-sorted edges are
  padded so no edge tile spans two destination-node blocks; a
  ``tile_to_block`` map lets consecutive edge tiles accumulate into the same
  output node block in VMEM (deterministic replacement for GPU atomics).

Both are computed once per graph on the host (NumPy) and are *data layout
choices* in the sense of §3.2.2 — the inter-op IR never sees them.

The port's own copy of ``repro.kernels.layout``: the host (NumPy)
builders, whose arrays are identical (``tests/test_torch_sampling.py``),
and the ``device_*`` builders of device sampling: fixed-shape torch code
that reads nothing back from the device, array-equal to the reference's
(``tests/test_torch_device_sampling.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PaddedSegments:
    """Tile-aligned padded layout for type-segmented rows."""

    tile: int                 # rows per tile (C)
    num_groups: int           # R
    padded_rows: int          # Rp = sum over groups of ceil(s_r / C) * C
    row_map: np.ndarray       # [Rp] int32: original row index, or -1 (pad)
    inv_map: np.ndarray       # [M]  int32: padded position of original row
    tile_to_group: np.ndarray  # [Rp // C] int32
    seg_sizes: np.ndarray     # [R] int32 original segment sizes

    @property
    def num_tiles(self) -> int:
        return self.padded_rows // self.tile

    @property
    def pad_overhead(self) -> float:
        m = int(self.seg_sizes.sum())
        return self.padded_rows / max(1, m)


def pad_segments(seg_ptr: np.ndarray, tile: int) -> PaddedSegments:
    """Build a ``PaddedSegments`` layout from segment offsets [R+1] (the
    reference's per-group loop, vectorized: the same arrays)."""
    seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    sizes = np.diff(seg_ptr)
    num_groups = len(sizes)
    padded = ((sizes + tile - 1) // tile) * tile
    rp = int(padded.sum())
    m = int(sizes.sum())
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    # a group's rows are one contiguous run, shifted to its padded start
    pos = (np.arange(m, dtype=np.int32)
           + np.repeat((starts - seg_ptr[:-1] + seg_ptr[0]).astype(np.int32),
                       sizes))
    row_map = np.full(rp, -1, dtype=np.int32)
    row_map[pos] = np.arange(seg_ptr[0], seg_ptr[0] + m, dtype=np.int32)
    inv_map = pos
    t2g = np.zeros(max(1, rp // tile), dtype=np.int32)
    t2g[:rp // tile] = np.repeat(np.arange(num_groups, dtype=np.int32),
                                 padded // tile)
    return PaddedSegments(
        tile=tile, num_groups=num_groups, padded_rows=rp,
        row_map=row_map, inv_map=inv_map, tile_to_group=t2g,
        seg_sizes=sizes.astype(np.int32),
    )


def pow2ceil(x: int) -> int:
    """Smallest power of two >= max(1, x)."""
    return 1 << (max(1, int(x)) - 1).bit_length()


def compose_gather_rows(ps: PaddedSegments, idx: np.ndarray) -> np.ndarray:
    """Padded gather-index layout: compose a per-row gather list with the
    tile-aligned padding map.

    ``idx`` maps a canonical row (edge or unique pair) to the source row it
    reads (e.g. ``src`` for BY_EDGE_SRC, ``unique_src`` for BY_UNIQUE_SRC).
    The result maps each *padded* slot directly to that source row (-1 for
    pad slots), so a kernel can scalar-prefetch it and perform the gather in
    its own index space — no ``[rows, k]`` copy is materialized between the
    source tensor and the GEMM (paper §3.3's in-kernel access schemes).
    """
    # the valid slots are exactly ``inv_map``'s (row i sits at slot
    # inv_map[i]): one gather and one scatter over the rows
    out = np.full(ps.padded_rows, -1, dtype=np.int32)
    out[ps.inv_map] = np.asarray(idx)[ps.row_map[ps.inv_map]]
    return out


def pad_segments_rows(ps: PaddedSegments, target_rows: int) -> PaddedSegments:
    """Grow a ``PaddedSegments`` layout to ``target_rows`` padded rows.

    Extra rows are pure padding (``row_map`` = -1) and extra tiles extend
    the **last** group's run — the tile->group map must stay non-decreasing
    because the accumulating kernels detect a group's first tile via
    ``t != prev``. Pad tiles multiply zero rows and are never read back
    through ``inv_map``. Used by the serving path to bucket layout shapes so
    jit/eager compilation caches hit across mini-batches.
    """
    if target_rows % ps.tile:
        raise ValueError(f"target_rows {target_rows} not a multiple of tile")
    extra = target_rows - ps.padded_rows
    if extra < 0:
        raise ValueError("target smaller than current layout")
    if extra == 0:
        return ps
    return dataclasses.replace(
        ps,
        padded_rows=target_rows,
        row_map=np.concatenate(
            [ps.row_map, np.full(extra, -1, dtype=np.int32)]),
        tile_to_group=np.concatenate(
            [ps.tile_to_group[: ps.padded_rows // ps.tile],
             np.full(extra // ps.tile, ps.num_groups - 1, dtype=np.int32)]),
    )


def pad_blocked_csr(bc: BlockedCSR, target_edges: int) -> BlockedCSR:
    """Grow a ``BlockedCSR`` to ``target_edges`` padded edge slots.

    Extra tiles carry no edges (``edge_map`` = -1, ``local_dst`` points past
    the block) and extend the **last** node block's run, keeping the
    tile->block map non-decreasing (the aggregation kernels re-initialize an
    output block whenever the map changes value); they accumulate exact
    zeros there.
    """
    if target_edges % bc.edge_tile:
        raise ValueError("target_edges not a multiple of edge_tile")
    extra = target_edges - bc.padded_edges
    if extra < 0:
        raise ValueError("target smaller than current layout")
    if extra == 0:
        return bc
    return dataclasses.replace(
        bc,
        padded_edges=target_edges,
        edge_map=np.concatenate(
            [bc.edge_map, np.full(extra, -1, dtype=np.int32)]),
        local_dst=np.concatenate(
            [bc.local_dst, np.full(extra, bc.node_block, dtype=np.int32)]),
        tile_to_block=np.concatenate(
            [bc.tile_to_block[: bc.padded_edges // bc.edge_tile],
             np.full(extra // bc.edge_tile, bc.num_node_blocks - 1,
                     dtype=np.int32)]),
    )


@dataclasses.dataclass(frozen=True)
class BlockedCSR:
    """Tile-aligned padded layout for destination-sorted edges.

    Nodes are grouped in blocks of ``node_block``; the (dst-sorted) edge list
    of each node block is padded to a multiple of ``edge_tile`` so every edge
    tile belongs to exactly one node block.
    """

    edge_tile: int
    node_block: int
    num_nodes: int
    padded_edges: int             # Ep
    edge_map: np.ndarray          # [Ep] int32: dst-sorted edge index, or -1
    local_dst: np.ndarray         # [Ep] int32: dst - block_start (pads -> node_block)
    tile_to_block: np.ndarray     # [Ep // edge_tile] int32
    num_node_blocks: int

    @property
    def num_tiles(self) -> int:
        return self.padded_edges // self.edge_tile


def block_csr(dst_ptr: np.ndarray, edge_tile: int, node_block: int) -> BlockedCSR:
    dst_ptr = np.asarray(dst_ptr, dtype=np.int64)
    num_nodes = len(dst_ptr) - 1
    nb = (num_nodes + node_block - 1) // node_block
    # edges per node block
    blk_start = dst_ptr[np.minimum(np.arange(nb) * node_block, num_nodes)]
    blk_end = dst_ptr[np.minimum((np.arange(nb) + 1) * node_block, num_nodes)]
    sizes = blk_end - blk_start
    padded = ((sizes + edge_tile - 1) // edge_tile) * edge_tile
    ep = int(padded.sum())
    edge_map = np.full(ep, -1, dtype=np.int32)
    local_dst = np.full(ep, node_block, dtype=np.int32)  # pads point past block
    t2b = np.zeros(max(1, ep // edge_tile), dtype=np.int32)

    # each dst-sorted edge laid into its node block's padded run (the
    # reference's per-block loop, vectorized: the same arrays); a block's
    # edges are one contiguous run of the dst-sorted order
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    edges = np.arange(dst_ptr[0], dst_ptr[-1], dtype=np.int32)
    pos = edges + np.repeat((starts - blk_start).astype(np.int32), sizes)
    edge_map[pos] = edges
    local_dst[pos] = (np.repeat(np.arange(num_nodes, dtype=np.int32),
                                np.diff(dst_ptr))
                      - np.repeat(np.arange(nb, dtype=np.int32) * node_block,
                                  sizes))
    t2b[:ep // edge_tile] = np.repeat(np.arange(nb, dtype=np.int32),
                                      padded // edge_tile)
    return BlockedCSR(
        edge_tile=edge_tile, node_block=node_block, num_nodes=num_nodes,
        padded_edges=ep, edge_map=edge_map, local_dst=local_dst,
        tile_to_block=t2b, num_node_blocks=nb,
    )


# ---------------------------------------------------------------------------
# device-side (fixed-shape, sync-free) layout builders
# ---------------------------------------------------------------------------
def scatter_drop(size: int, fill: int, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``full(size, fill).at[idx].set(vals, mode="drop")``: writes whose
    index lies outside ``[0, size)`` land in one trash slot past the end,
    which is sliced off (``scatter_`` would fault on them)."""
    out = torch.full((size + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    idx = idx.long()
    idx = torch.where((idx < 0) | (idx > size), size, idx)
    return out.scatter_(0, idx, vals)[:size]


def ptr_of_sorted(sorted_vals: torch.Tensor, num: int) -> torch.Tensor:
    """[num + 1] segment offsets of the values ``0..num-1`` in a
    non-decreasing int32 array: the cumulative counts, by binary search
    (a bincount reads its maximum back to the host)."""
    return torch.searchsorted(
        sorted_vals, torch.arange(num + 1, dtype=sorted_vals.dtype,
                                  device=sorted_vals.device),
        out_int32=True)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """[0, x0, x0+x1, ...] as int32: offsets from sizes."""
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0, dtype=torch.int32)])


def _device_tile_runs(pstart: torch.Tensor, tile: int, num_tiles: int,
                      num_groups: int) -> torch.Tensor:
    """tile -> group map from tile-aligned padded group starts [G+1].

    Tiles past the populated prefix extend the **last** group's run (the
    ``pad_segments_rows`` growth rule: accumulating kernels need the map
    non-decreasing, and trailing pad tiles must not open a new group).
    """
    boundaries = (pstart[1:] // tile).contiguous()      # [G] end tile of g
    t = torch.arange(num_tiles, dtype=boundaries.dtype,
                     device=boundaries.device)
    t2g = torch.searchsorted(boundaries, t, right=True, out_int32=True)
    return t2g.clamp(0, num_groups - 1)


def device_pad_segments(seg_ptr: torch.Tensor, group_of_row: torch.Tensor,
                        tile: int, padded_rows: int):
    """``pad_segments`` (+ ``pad_segments_rows`` growth) at fixed shapes.

    ``seg_ptr`` [G+1] are the group offsets over ``M = len(group_of_row)``
    type-sorted rows (every row's group in ``group_of_row``, non-decreasing).
    ``padded_rows`` is the static row capacity and must satisfy
    ``padded_rows >= M + G*tile > M + sum_g (tile-1)`` (room for the
    worst-case per-group tile padding) and be a tile multiple. Returns
    ``(row_map [padded_rows], inv_map [M], t2g [padded_rows//tile])`` with
    the host semantics: pad slots are -1 in ``row_map`` and trailing tiles
    extend the last group's run.
    """
    if padded_rows % tile:
        raise ValueError("padded_rows must be a tile multiple")
    num_groups = int(seg_ptr.shape[0]) - 1
    m = int(group_of_row.shape[0])
    if padded_rows < m + num_groups * tile:
        raise ValueError(
            f"padded_rows={padded_rows} cannot hold {m} rows with "
            f"{num_groups} groups of up-to-(tile-1) padding each")
    sizes = seg_ptr[1:] - seg_ptr[:-1]
    pstart = exclusive_cumsum(((sizes + tile - 1) // tile) * tile)
    g = group_of_row.long()
    rows = torch.arange(m, dtype=torch.int32, device=seg_ptr.device)
    inv_map = pstart[g] + (rows - seg_ptr[g])
    row_map = scatter_drop(padded_rows, -1, inv_map, rows)
    t2g = _device_tile_runs(pstart, tile, padded_rows // tile, num_groups)
    return row_map, inv_map, t2g


def device_compose_gather_rows(row_map: torch.Tensor,
                               idx: torch.Tensor) -> torch.Tensor:
    """``compose_gather_rows`` on tensors: padded slot -> source row (or
    -1)."""
    return torch.where(row_map >= 0, idx[row_map.clamp(min=0).long()],
                       -1).to(torch.int32)


def device_block_csr(dst_ptr: torch.Tensor, dst_sorted: torch.Tensor,
                     edge_tile: int, node_block: int, padded_edges: int):
    """``block_csr`` at fixed shapes.

    ``dst_ptr`` [N+1] / ``dst_sorted`` [E] describe the destination-sorted
    edges. ``padded_edges`` is the static slot capacity and must satisfy
    ``padded_edges >= E + num_node_blocks*edge_tile`` (worst-case per-block
    tile padding) and be a tile multiple. Returns ``(edge_map_d
    [padded_edges], local_dst [padded_edges], t2b)`` where ``edge_map_d``
    holds **dst-sorted** edge indices (compose with ``perm_dst`` for
    canonical order), pads are -1 / ``node_block``, and trailing tiles
    extend the last block's run.
    """
    if padded_edges % edge_tile:
        raise ValueError("padded_edges must be an edge_tile multiple")
    num_nodes = int(dst_ptr.shape[0]) - 1
    e = int(dst_sorted.shape[0])
    nb = (num_nodes + node_block - 1) // node_block
    if padded_edges < e + nb * edge_tile:
        raise ValueError(
            f"padded_edges={padded_edges} cannot hold {e} edges over "
            f"{nb} node blocks")
    dev = dst_ptr.device
    bidx = torch.clamp(torch.arange(nb + 1, device=dev) * node_block,
                       max=num_nodes)
    bptr = dst_ptr[bidx]                                    # [nb+1]
    sizes = bptr[1:] - bptr[:-1]
    pstart = exclusive_cumsum(
        ((sizes + edge_tile - 1) // edge_tile) * edge_tile)
    b_of = dst_sorted // node_block                         # [E]
    bl = b_of.long()
    edges = torch.arange(e, dtype=torch.int32, device=dev)
    slot = pstart[bl] + (edges - bptr[bl])
    edge_map_d = scatter_drop(padded_edges, -1, slot, edges)
    local_dst = scatter_drop(padded_edges, node_block, slot,
                             (dst_sorted - b_of * node_block)
                             .to(torch.int32))
    t2b = _device_tile_runs(pstart, edge_tile, padded_edges // edge_tile, nb)
    return edge_map_d, local_dst, t2b
