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

The port's own copy of the host (NumPy) half of ``repro.kernels.layout``;
the arrays are identical (``tests/test_torch_sampling.py``). The
reference's jit-traceable ``device_*`` builders belong to the
device-sampling slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
    """Build a ``PaddedSegments`` layout from segment offsets [R+1]."""
    seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    sizes = np.diff(seg_ptr)
    num_groups = len(sizes)
    padded = ((sizes + tile - 1) // tile) * tile
    rp = int(padded.sum())
    row_map = np.full(rp, -1, dtype=np.int32)
    inv_map = np.zeros(int(sizes.sum()), dtype=np.int32)
    t2g = np.zeros(max(1, rp // tile), dtype=np.int32)
    off = 0
    tile_off = 0
    for r in range(num_groups):
        s, p = int(sizes[r]), int(padded[r])
        row_map[off : off + s] = np.arange(seg_ptr[r], seg_ptr[r] + s, dtype=np.int32)
        inv_map[seg_ptr[r] : seg_ptr[r] + s] = np.arange(off, off + s, dtype=np.int32)
        t2g[tile_off : tile_off + p // tile] = r
        off += p
        tile_off += p // tile
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
    idx = np.asarray(idx)
    return np.where(
        ps.row_map >= 0, idx[np.maximum(ps.row_map, 0)], -1
    ).astype(np.int32)


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

    # dst id of each dst-sorted edge
    dst_of_edge = np.repeat(
        np.arange(num_nodes, dtype=np.int64), np.diff(dst_ptr)
    )
    off = 0
    toff = 0
    for b in range(nb):
        s, p = int(sizes[b]), int(padded[b])
        lo = int(blk_start[b])
        edge_map[off : off + s] = np.arange(lo, lo + s, dtype=np.int32)
        local_dst[off : off + s] = (
            dst_of_edge[lo : lo + s] - b * node_block
        ).astype(np.int32)
        t2b[toff : toff + p // edge_tile] = b
        off += p
        toff += p // edge_tile
    return BlockedCSR(
        edge_tile=edge_tile, node_block=node_block, num_nodes=num_nodes,
        padded_edges=ep, edge_map=edge_map, local_dst=local_dst,
        tile_to_block=t2b, num_node_blocks=nb,
    )
