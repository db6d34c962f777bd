"""GEMM-template kernels K1, K4, K5 (Hector Algorithm 1 and its backward)
and their plain versions.

``segment_mm_gather_padded``  K1: Y_p[slot] = X[gidx[slot]] @ W[t2g[tile]]
                              (x the fused per-row scale), over the
                              tile-aligned ``PaddedSegments`` layout.
``segment_mm_padded``         K4: Y_p = X_p @ W[t2g[tile]] (or W^T with
                              ``transpose_w``) over pre-padded rows: the
                              forward of ungathered GEMMs and the dX of
                              every GEMM's backward.
``segment_outer_padded``      K5: dW[g] = Σ_{tiles t of g} X_tᵀ dY_t, the dW
                              of every GEMM's backward, on the fp64 tensor
                              cores, the groups' tiles cut into chunks of
                              ``outer_chunk_tiles`` tiles.

Each wrapper dispatches on the tensors' device: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the hand-written Hopper kernel in
``csrc/segment_mm.cu`` (which replaces the Pallas kernels of the same names
in ``repro/kernels/segment_mm.py``). Nothing falls back: a failed build or
launch raises. ``<wrapper>.launches`` counts each wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

# K1 / K4 work split (``gemm_plan``, from the shapes alone). n <= 16 takes
# the narrow route: pieces of GEMM_NARROW_ROWS rows, one row a thread with
# all n columns (NC = 1, 4, 8 or 16 held in registers; at NC = 1 a block
# is one piece, each warp on its own). Wider products take the wide route:
# pieces of 16 * TM rows by GEMM_WIDE_COLS columns, each thread a TM x 8
# (TM = 8) or TM x 4 (TM = 2) register tile; TM = 8 where that still gives
# the call at least GEMM_WIDE_MIN_PIECES 128-row pieces (four a
# multiprocessor on the H100's GEMM_SMS), else TM = 2 (a small call, such
# as a served aifb batch's, then spreads over the card). Past NC = 1,
# blocks are persistent: whole waves of GEMM_RESIDENT blocks a
# multiprocessor (what its registers and shared memory hold), each walking
# a span of consecutive pieces, at most GEMM_SPAN_MAX rows (``kSpanMax``).
GEMM_NARROW_MAX_N = 16
GEMM_NARROW_ROWS = 128
GEMM_NARROW_WIDTHS = (1, 4, 8, 16)
GEMM_WIDE_COLS = 64
GEMM_SMS = 132
GEMM_WIDE_MIN_PIECES = 4 * GEMM_SMS
GEMM_RESIDENT = {("wide", 8): 3, ("wide", 2): 2, ("narrow", 4): 4,
                 ("narrow", 8): 4, ("narrow", 16): 4}
GEMM_SPAN_MAX = 1024
_ROUTE_CODE = {"wide": 0, "narrow": 1}    # csrc/segment_mm.cu's kRoute*

# K5 splits each group's run of real tiles into chunks of at most
# ``outer_chunk_tiles(T)`` tiles, one thread block each (``outer_chunk_ptr``):
# about K5_TARGET_CHUNKS chunks for T padded tiles (about one wave of two
# blocks on each of the H100's 132 SMs), each of K5_MIN_CHUNK_TILES to
# K5_MAX_CHUNK_TILES tiles: on an H100, 4 tiles were the fastest of 1-64
# at the aifb-b64 training steps' calls (T <= 1024), 16-32 at the bgs
# full-graph steps' calls (T = 3-21K)
K5_TARGET_CHUNKS = 256
K5_MIN_CHUNK_TILES = 4
K5_MAX_CHUNK_TILES = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "segment_mm_gather_f32": [_P] * 6 + [_I] * 8 + [_P],
    "segment_mm_padded_f32": [_P] * 5 + [_I] * 9 + [_P],
    "segment_outer_f32": [_P] * 7 + [_I] * 6 + [_P],
}


def _library() -> ctypes.CDLL:
    return build.load("segment_mm", _SIGNATURES)


def _device_or_raise(kernel: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for CUDA (the
    kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return False


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_tile_n(tile_n: Optional[int], kernel: str) -> None:
    """``tile_n`` (the tuner's column tile) must be positive when given;
    the kernels' blocks no longer follow it (``gemm_plan``)."""
    if tile_n is not None and tile_n <= 0:
        raise ValueError(f"{kernel}: tile_n={tile_n} must be positive")


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How one K1 / K4 call is cut: the route, what a thread holds (wide:
    TM rows, of 8 columns at TM = 8 and 4 at TM = 2; narrow: NC >= n
    columns of one row), the rows of a piece (what the block's threads
    cover at once), and the grid:
    ``row_blocks`` blocks, each walking ``block_rows`` rows (a whole number
    of pieces), by ``col_blocks`` slices of ``block_cols`` columns."""

    route: str
    per_thread: int
    piece_rows: int
    block_rows: int
    block_cols: int
    row_blocks: int
    col_blocks: int


@functools.lru_cache(maxsize=4096)
def gemm_plan(rows: int, n: int) -> GemmPlan:
    """The route and work split of a K1 / K4 call with ``rows`` padded rows
    and ``n`` output columns (the reduction width and the tiles do not
    matter: blocks cut the reduction into chunks and their rows into runs
    of one group)."""
    if rows <= 0 or n <= 0:
        raise ValueError(f"no work to split: rows={rows}, n={n}")
    if n <= GEMM_NARROW_MAX_N:
        route, col_blocks, block_cols = "narrow", 1, n
        per = next(c for c in GEMM_NARROW_WIDTHS if c >= n)
        piece = GEMM_NARROW_ROWS
        if per == 1:
            return GemmPlan(route, per, piece, piece, block_cols,
                            -(-rows // piece), 1)
    else:
        route, block_cols = "wide", GEMM_WIDE_COLS
        col_blocks = -(-n // GEMM_WIDE_COLS)
        per = (8 if -(-rows // 128) * col_blocks >= GEMM_WIDE_MIN_PIECES
               else 2)
        piece = 16 * per
    # whole waves of resident blocks, each walking at most GEMM_SPAN_MAX
    # rows: a part-filled last wave would leave most of the card idle
    slots = max(1, GEMM_RESIDENT[route, per] * GEMM_SMS // col_blocks)
    pieces = -(-rows // piece)
    waves = -(-pieces // (slots * (GEMM_SPAN_MAX // piece)))
    span = piece * -(-pieces // min(pieces, slots * waves))
    return GemmPlan(route, per, piece, span, block_cols, -(-rows // span),
                    col_blocks)


def _aligned(x: torch.Tensor, w: torch.Tensor) -> int:
    """The kernels' ``aligned`` bits: 1 where x is 16-byte aligned, 2 where
    w is."""
    return int(x.data_ptr() % 16 == 0) | 2 * int(w.data_ptr() % 16 == 0)


# ---------------------------------------------------------------------------
# K1: gather-fused segment GEMM
# ---------------------------------------------------------------------------
def segment_mm_gather_padded_plain(
    x: torch.Tensor,                 # [Nx, k] source rows
    w: torch.Tensor,                 # [R, k, n]
    gidx: torch.Tensor,              # [Rp] int32 slot -> source row, or -1
    t2g: torch.Tensor,               # [>= Rp/tile] int32 tile -> group
    row_scale_p: Optional[torch.Tensor] = None,   # [Rp, 1] or [Rp]
    *,
    tile: int,
    tile_n: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, batched product per tile
    (``tile_n``, the tuner's column tile, does not change the result)."""
    rp = int(gidx.shape[0])
    k, n = int(w.shape[1]), int(w.shape[2])
    num_tiles = rp // tile
    valid = gidx >= 0
    if x.shape[0] == 0:
        xp = x.new_zeros((rp, k))
    else:
        xp = torch.where(valid[:, None], x[gidx.clamp(min=0).long()],
                         x.new_zeros(()))
    y = torch.bmm(xp.view(num_tiles, tile, k),
                  w[t2g[:num_tiles].long()]).reshape(rp, n)
    if row_scale_p is not None:
        y = y * row_scale_p.reshape(rp, 1)
    return torch.where(valid[:, None], y, y.new_zeros(()))


def segment_mm_gather_padded(
    x: torch.Tensor,
    w: torch.Tensor,
    gidx: torch.Tensor,
    t2g: torch.Tensor,
    row_scale_p: Optional[torch.Tensor] = None,
    *,
    tile: int,
    tile_n: Optional[int] = None,
) -> torch.Tensor:
    """K1: ``Y_p = X[gidx] @ W[t2g[tile]]`` (x ``row_scale_p``) -> [Rp, n].

    The gather runs inside the kernel; ``gidx`` = -1 gives a zero row.
    ``tile`` is the row tile (``t2g`` holds one group per tile of it);
    ``tile_n``, the tuner's column tile, is checked but cuts nothing: the
    blocks follow ``gemm_plan``, and no result depends on either."""
    rp = int(gidx.shape[0])
    nx, k = x.shape
    r, k2, n = w.shape
    if k != k2:
        raise ValueError(f"x has k={k} but w has k={k2}")
    if rp % tile:
        raise ValueError(f"{rp} padded rows is not a multiple of tile {tile}")
    _check_tile_n(tile_n, "segment_mm_gather_padded")
    if _device_or_raise("segment_mm_gather_padded", x):
        return segment_mm_gather_padded_plain(x, w, gidx, t2g, row_scale_p,
                                              tile=tile)
    build.check_args("segment_mm_gather_padded", x.device,
                     x=(x, torch.float32), w=(w, torch.float32),
                     gidx=(gidx, torch.int32), t2g=(t2g, torch.int32),
                     row_scale_p=(row_scale_p, torch.float32))
    num_tiles = rp // tile
    if t2g.shape[0] < num_tiles:
        raise ValueError(f"t2g has {t2g.shape[0]} entries for {num_tiles} "
                         f"tiles")
    y = torch.empty((rp, n), dtype=torch.float32, device=x.device)
    if num_tiles == 0 or n == 0:
        return y                  # an empty grid is never launched
    x, w = x.contiguous(), w.contiguous()
    gidx, t2g = gidx.contiguous(), t2g.contiguous()
    scale = (row_scale_p.reshape(rp).contiguous()
             if row_scale_p is not None else None)
    plan = gemm_plan(rp, n)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.segment_mm_gather_f32(
            x.data_ptr(), w.data_ptr(), gidx.data_ptr(), t2g.data_ptr(),
            scale.data_ptr() if scale is not None else None, y.data_ptr(),
            k, n, rp, tile, _ROUTE_CODE[plan.route], plan.per_thread,
            plan.block_rows, _aligned(x, w), _stream(x.device))
    build.check(lib, rc, "segment_mm_gather_padded")
    segment_mm_gather_padded.launches += 1
    return y


segment_mm_gather_padded.launches = 0


# ---------------------------------------------------------------------------
# K4: segment GEMM over pre-padded rows
# ---------------------------------------------------------------------------
def segment_mm_padded_plain(
    x_p: torch.Tensor,               # [Rp, kd] padded, type-sorted rows
    w: torch.Tensor,                 # [R, kd, n], or [R, n, kd] transposed
    t2g: torch.Tensor,               # [>= Rp/tile] int32 tile -> group
    row_scale_p: Optional[torch.Tensor] = None,   # [Rp, 1] or [Rp]
    *,
    tile: int,
    transpose_w: bool = False,
    tile_n: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K4: one batched product per tile (``tile_n``
    does not change the result)."""
    rp, kd = x_p.shape
    num_tiles = rp // tile
    wt = w[t2g[:num_tiles].long()]
    if transpose_w:
        wt = wt.transpose(1, 2)
    y = torch.bmm(x_p.reshape(num_tiles, tile, kd), wt).reshape(
        rp, wt.shape[2])
    if row_scale_p is not None:
        y = y * row_scale_p.reshape(rp, 1)
    return y


def segment_mm_padded(
    x_p: torch.Tensor,
    w: torch.Tensor,
    t2g: torch.Tensor,
    row_scale_p: Optional[torch.Tensor] = None,
    *,
    tile: int,
    transpose_w: bool = False,
    tile_n: Optional[int] = None,
) -> torch.Tensor:
    """K4: ``Y_p = X_p @ W[t2g[tile]]`` (x ``row_scale_p``) -> [Rp, n].

    With ``transpose_w`` the product is with ``W[g]ᵀ`` of a ``w`` of shape
    [R, n, kd], read by stride inside the kernel (no transposed copy).
    ``tile`` and ``tile_n`` as for K1."""
    rp, kd = x_p.shape
    r, a, b = w.shape
    wk, n = (b, a) if transpose_w else (a, b)
    if kd != wk:
        raise ValueError(f"x_p has k={kd} but w{'ᵀ' if transpose_w else ''} "
                         f"has k={wk}")
    if rp % tile:
        raise ValueError(f"{rp} padded rows is not a multiple of tile {tile}")
    _check_tile_n(tile_n, "segment_mm_padded")
    if _device_or_raise("segment_mm_padded", x_p):
        return segment_mm_padded_plain(x_p, w, t2g, row_scale_p, tile=tile,
                                       transpose_w=transpose_w)
    build.check_args("segment_mm_padded", x_p.device,
                     x_p=(x_p, torch.float32), w=(w, torch.float32),
                     t2g=(t2g, torch.int32),
                     row_scale_p=(row_scale_p, torch.float32))
    num_tiles = rp // tile
    if t2g.shape[0] < num_tiles:
        raise ValueError(f"t2g has {t2g.shape[0]} entries for {num_tiles} "
                         f"tiles")
    y = torch.empty((rp, n), dtype=torch.float32, device=x_p.device)
    if num_tiles == 0 or n == 0:
        return y                  # an empty grid is never launched
    x_p, w, t2g = x_p.contiguous(), w.contiguous(), t2g.contiguous()
    scale = (row_scale_p.reshape(rp).contiguous()
             if row_scale_p is not None else None)
    plan = gemm_plan(rp, n)
    lib = _library()
    with torch.cuda.device(x_p.device):
        rc = lib.segment_mm_padded_f32(
            x_p.data_ptr(), w.data_ptr(), t2g.data_ptr(),
            scale.data_ptr() if scale is not None else None, y.data_ptr(),
            kd, n, rp, tile, _ROUTE_CODE[plan.route], plan.per_thread,
            plan.block_rows, _aligned(x_p, w), int(transpose_w),
            _stream(x_p.device))
    build.check(lib, rc, "segment_mm_padded")
    segment_mm_padded.launches += 1
    return y


segment_mm_padded.launches = 0


# ---------------------------------------------------------------------------
# K5: per-group outer-product sum (dW)
# ---------------------------------------------------------------------------
def outer_tile_ptr(seg_sizes: np.ndarray, tile: int) -> np.ndarray:
    """[R + 1] offsets of each group's run of real tiles (tiles that hold
    at least one row of the group): the tile-aligned layout gives group g
    ``ceil(seg_sizes[g] / tile)`` of them, in group order, and bucketing
    only appends pure-pad tiles after the last."""
    counts = (np.asarray(seg_sizes, np.int64) + tile - 1) // tile
    ptr = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    return ptr


def outer_chunk_tiles(num_tiles: int) -> int:
    """K5's chunk size for a layout of ``num_tiles`` padded tiles (a static
    shape, never the device's real-tile count): about K5_TARGET_CHUNKS
    chunks, each between K5_MIN_CHUNK_TILES and K5_MAX_CHUNK_TILES
    tiles."""
    return max(K5_MIN_CHUNK_TILES, min(K5_MAX_CHUNK_TILES, -(
        -int(num_tiles) // K5_TARGET_CHUNKS)))


def outer_chunk_ptr(group_tile_ptr: np.ndarray,
                    chunk_tiles: int) -> np.ndarray:
    """[R + 1] offsets of each group's K5 chunks: its run of real tiles cut
    into pieces of at most ``chunk_tiles`` tiles."""
    counts = (np.diff(np.asarray(group_tile_ptr, np.int64))
              + chunk_tiles - 1) // chunk_tiles
    ptr = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    return ptr


# K5's arrival counters, one int32 per (group, 64 x 64 slice of dW), by
# device: zero between launches (the last block of each group resets its
# own), so no call clears them. A buffer outgrown by a larger launch is
# kept, never freed: a CUDA graph that captured a launch holds its
# pointer for the graph's whole life.
_counters: dict = {}
_retired: list = []


def _outer_counters(dev: torch.device, size: int) -> torch.Tensor:
    buf = _counters.get(dev)
    if buf is None or buf.numel() < size:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(size, 1024), dtype=torch.int32, device=dev)
        _counters[dev] = buf
    return buf


def segment_outer_padded_plain(
    x_p: torch.Tensor,               # [Rp, k]
    dy_p: torch.Tensor,              # [Rp, n]
    group_tile_ptr: torch.Tensor,    # [R + 1] real-tile runs per group
    group_chunk_ptr: Optional[torch.Tensor] = None,
    *,
    num_groups: int,
    num_chunks: int = 0,
    tile: int,
    chunk_tiles: int = 1,
) -> torch.Tensor:
    """Plain version of K5 -> [R, k, n]: each real tile's ``X_tᵀ dY_t``
    summed into its group, in fp64 (as the kernel), returned in the input
    dtype. ``group_chunk_ptr`` / ``num_chunks`` / ``chunk_tiles`` are the
    kernel's work split and do not change the result."""
    k, n = int(x_p.shape[1]), int(dy_p.shape[1])
    counts = torch.diff(group_tile_ptr.long())
    real = int(counts.sum())
    dw = torch.zeros((num_groups, k, n), dtype=torch.float64,
                     device=x_p.device)
    if real:
        xt = x_p[: real * tile].reshape(real, tile, k).double()
        dt = dy_p[: real * tile].reshape(real, tile, n).double()
        group = torch.repeat_interleave(
            torch.arange(num_groups, device=x_p.device), counts)
        dw.index_add_(0, group, torch.bmm(xt.transpose(1, 2), dt))
    return dw.to(x_p.dtype)


def segment_outer_padded(
    x_p: torch.Tensor,
    dy_p: torch.Tensor,
    group_tile_ptr: torch.Tensor,
    group_chunk_ptr: torch.Tensor,
    *,
    num_groups: int,
    num_chunks: int,
    tile: int,
    chunk_tiles: int,
) -> torch.Tensor:
    """K5: ``dW[g] = Σ_{real tiles t of g} X_tᵀ dY_t`` -> [R, k, n] fp32.

    Only the tiles in ``group_tile_ptr``'s runs are read (the pure-pad
    tiles bucketing appends hold zero rows); a group without real tiles
    gets zeros. ``group_chunk_ptr`` (``outer_chunk_ptr`` at
    ``chunk_tiles``, which the layout carries) splits the runs over thread
    blocks; ``num_chunks`` blocks are launched (at least
    ``group_chunk_ptr[R]``; the surplus returns at once). The CPU route
    ignores the split."""
    rp, k = x_p.shape
    rp2, n = dy_p.shape
    if rp != rp2:
        raise ValueError(f"x_p has {rp} rows but dy_p {rp2}")
    if rp % tile:
        raise ValueError(f"{rp} padded rows is not a multiple of tile {tile}")
    if group_tile_ptr.shape[0] != num_groups + 1:
        raise ValueError(f"group_tile_ptr has {group_tile_ptr.shape[0]} "
                         f"entries for {num_groups} groups")
    if _device_or_raise("segment_outer_padded", x_p):
        return segment_outer_padded_plain(
            x_p, dy_p, group_tile_ptr, group_chunk_ptr,
            num_groups=num_groups, num_chunks=num_chunks, tile=tile,
            chunk_tiles=chunk_tiles)
    dev = x_p.device
    build.check_args("segment_outer_padded", dev,
                     x_p=(x_p, torch.float32), dy_p=(dy_p, torch.float32),
                     group_tile_ptr=(group_tile_ptr, torch.int32),
                     group_chunk_ptr=(group_chunk_ptr, torch.int32))
    if group_chunk_ptr.shape[0] != num_groups + 1:
        raise ValueError(f"group_chunk_ptr has {group_chunk_ptr.shape[0]} "
                         f"entries for {num_groups} groups")
    if num_groups == 0 or k == 0 or n == 0 or rp == 0 or num_chunks == 0:
        # nothing to sum: no kernel is launched
        return torch.zeros((num_groups, k, n), dtype=torch.float32,
                           device=dev)
    if chunk_tiles < 1:
        raise ValueError(f"segment_outer_padded: chunk_tiles={chunk_tiles} "
                         f"below 1")
    dw = torch.empty((num_groups, k, n), dtype=torch.float32, device=dev)
    partial = torch.empty((num_chunks, k, n), dtype=torch.float64,
                          device=dev)
    counters = _outer_counters(dev, num_groups * -(-k // 64) * -(-n // 64))
    args = [t.contiguous() for t in (x_p, dy_p, group_tile_ptr,
                                     group_chunk_ptr)]
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.segment_outer_f32(
            *(t.data_ptr() for t in args), partial.data_ptr(),
            dw.data_ptr(), counters.data_ptr(), k, n, tile, num_groups,
            num_chunks, chunk_tiles, _stream(dev))
    build.check(lib, rc, "segment_outer_padded")
    segment_outer_padded.launches += 1
    return dw


segment_outer_padded.launches = 0
