"""GEMM-template kernel K1 (Hector Algorithm 1) and its plain version.

``segment_mm_gather_padded``  Y_p[slot] = X[gidx[slot]] @ W[t2g[tile]]
                              (x the fused per-row scale), over the
                              tile-aligned ``PaddedSegments`` layout.

The wrapper dispatches on the tensors' device: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the hand-written Hopper kernel in
``csrc/segment_mm.cu`` (which replaces the Pallas kernel
``repro/kernels/segment_mm.py::segment_mm_gather_padded``). Nothing falls
back: a failed build or launch raises. ``segment_mm_gather_padded.launches``
counts the kernel launches.

``segment_mm_padded`` (GEMM over pre-padded rows), ``segment_outer_padded``
(the dW backward) are not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "segment_mm_gather_f32": [_P] * 6 + [_I] * 5 + [_P],
    "segment_mm_gather_smem_bytes": [_I] * 3,
}


def _library() -> ctypes.CDLL:
    return build.load("segment_mm", _SIGNATURES,
                      sizes=("segment_mm_gather_smem_bytes",))


def segment_mm_gather_padded_plain(
    x: torch.Tensor,                 # [Nx, k] source rows
    w: torch.Tensor,                 # [R, k, n]
    gidx: torch.Tensor,              # [Rp] int32 slot -> source row, or -1
    t2g: torch.Tensor,               # [>= Rp/tile] int32 tile -> group
    row_scale_p: Optional[torch.Tensor] = None,   # [Rp, 1] or [Rp]
    *,
    tile: int,
) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, batched product per tile."""
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
) -> torch.Tensor:
    """K1: ``Y_p = X[gidx] @ W[t2g[tile]]`` (x ``row_scale_p``) -> [Rp, n].

    The gather runs inside the kernel; ``gidx`` = -1 gives a zero row."""
    rp = int(gidx.shape[0])
    nx, k = x.shape
    r, k2, n = w.shape
    if k != k2:
        raise ValueError(f"x has k={k} but w has k={k2}")
    if rp % tile:
        raise ValueError(f"{rp} padded rows is not a multiple of tile {tile}")
    if x.device.type == "cpu":
        return segment_mm_gather_padded_plain(x, w, gidx, t2g, row_scale_p,
                                              tile=tile)
    if x.device.type != "cuda":
        raise ValueError(f"segment_mm_gather_padded: no kernel for device "
                         f"{x.device}")
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
    lib = _library()
    smem = lib.segment_mm_gather_smem_bytes(k, n, tile)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"segment_mm_gather_padded: tile={tile}, k={k} "
                         f"needs {smem} bytes of shared memory per block "
                         f"(limit {build.MAX_SMEM_BYTES})")
    vec4 = int(k % 4 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.segment_mm_gather_f32(
            x.data_ptr(), w.data_ptr(), gidx.data_ptr(), t2g.data_ptr(),
            scale.data_ptr() if scale is not None else None, y.data_ptr(),
            k, n, num_tiles, tile, vec4, stream)
    build.check(lib, rc, "segment_mm_gather_padded")
    segment_mm_gather_padded.launches += 1
    return y


segment_mm_gather_padded.launches = 0

