"""K10: grouped-query flash attention for LM prefill and decode, and its
plain version.

``flash_attention``        the wrapper: a CPU tensor runs the plain version,
                           a CUDA tensor launches the hand-written Hopper
                           kernel in ``csrc/flash_attention.cu`` (which
                           replaces ``repro/kernels/flash_attention.py``'s
                           Pallas kernel). Nothing falls back: a failed build
                           or launch raises. ``flash_attention.launches``
                           counts its launches.
``flash_attention_plain``  the einsum / softmax of ``repro/nn/attention.py``
                           (and ``tests/test_flash.py::ref_attention``) on
                           tensors, in fp32, for any lengths.

Both take ``q [B, Sq, H, hd]`` and ``k, v [B, Sk, KV, hd]`` (KV divides H;
head ``h`` reads KV head ``h // (H / KV)``), query ``i`` at position
``q_offset + i`` and key ``j`` at position ``j``, and return ``[B, Sq, H,
hd]`` in ``q``'s dtype. Unlike the Pallas kernel, neither length has to be
a multiple of a tile. A row that sees no key (its window starts past the
last key) averages every value, as the Pallas kernel's does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_NEG = -1e30

# the kernel's tiles (``kRows`` query rows, ``kKeys`` keys a thread block)
ROWS_PER_BLOCK = 64
KEYS_PER_TILE = 32
# decode's key splits: about this many thread blocks per SM, and at least
# this many keys a split
_BLOCKS_PER_SM = 2
_MIN_SPLIT_KEYS = 128
MAX_HEAD_DIM = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_fwd": ([_P] * 5 + [_I] * 7 + [_L] * 6
                            + [_I, _I, ctypes.c_float, _I, _I, _I, _P]),
    "flash_attention_smem_bytes": [_I],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    return build.load("flash_attention", _SIGNATURES,
                      sizes=("flash_attention_smem_bytes",))


def _check_shapes(q, k, v) -> Tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "([B, S, heads, head_dim])")
    b, sq, h, hd = q.shape
    bk, sk, kv, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: v {tuple(v.shape)} differs from "
                         f"k {tuple(k.shape)}")
    if bk != b or hdk != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kv} KV heads")
    return b, sq, h, hd, sk, kv


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: Optional[int], causal: bool) -> torch.Tensor:
    """[Q, S] boolean mask (True = attend) of batch-shared positions: key
    at or before the query (``causal``) and less than ``window`` behind
    it."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m = m & (k_pos[None, :] > (q_pos[:, None] - window))
    return m


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K10: grouped einsums in fp32, the -1e30
    mask and a softmax over all ``Sk`` keys."""
    b, sq, h, hd, sk, kv = _check_shapes(q, k, v)
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(q_offset + torch.arange(sq, device=q.device),
                          torch.arange(sk, device=q.device), window, causal)
    s = torch.where(mask, s, torch.tensor(_NEG, dtype=s.dtype,
                                          device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def key_splits(b: int, kv: int, rows: int, sk: int,
               sms: int) -> Tuple[int, int]:
    """``(splits, chunk)``: how many thread blocks share each (batch, KV
    head, row tile)'s key range, and the keys of each (a multiple of the
    key tile). A grid of ``b * kv * ceil(rows / 64)`` blocks that leaves
    SMs idle (decode) is split towards ``2 * sms`` blocks, at least 128
    keys a split; it depends on the shapes only, so every decode step over
    one cache splits alike."""
    base = b * kv * -(-rows // ROWS_PER_BLOCK)
    if base >= sms:
        return 1, sk
    want = -(-_BLOCKS_PER_SM * sms // base)
    splits = max(1, min(want, -(-sk // _MIN_SPLIT_KEYS)))
    chunk = -(-sk // splits)
    chunk = -(-chunk // KEYS_PER_TILE) * KEYS_PER_TILE
    return -(-sk // chunk), chunk


def _operand(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``t`` itself where the kernel can read it in place (unit element
    stride, heads ``hd`` apart, batch and sequence strides multiples of 4,
    a 16-byte aligned base), else a contiguous copy."""
    if (t.stride(3) == 1 and t.stride(2) == hd and t.stride(0) % 4 == 0
            and t.stride(1) % 4 == 0 and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous() if not t.is_contiguous() else t.clone()


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> torch.Tensor:
    """K10: attention of ``q`` over ``k, v`` (see the module docstring),
    reading a KV cache's ``[B, Sk, KV, hd]`` slice in place. ``window``
    (at least 1) and ``softcap`` (positive) are optional; ``q_offset`` is a
    run-time argument of the kernel."""
    b, sq, h, hd, sk, kv = _check_shapes(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap={softcap} must be > 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    build.check_args("flash_attention", q.device, k=(k, q.dtype),
                     v=(v, q.dtype))
    if hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple "
                         f"of 4 and at most {MAX_HEAD_DIM}")
    if b * kv > 65535:
        raise ValueError(f"flash_attention: batch x KV heads = {b * kv} "
                         f"exceeds the grid's 65535")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or sk == 0:
        return out.zero_()                        # nothing is launched
    q, k, v = _operand(q, hd), _operand(k, hd), _operand(v, hd)
    lib = _library()
    smem = lib.flash_attention_smem_bytes(hd)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: head_dim {hd} needs {smem} bytes "
                         f"of shared memory per block (limit "
                         f"{build.MAX_SMEM_BYTES})")
    index = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    splits, chunk = key_splits(b, kv, sq * (h // kv), sk, _sm_count(index))
    ws = None
    if splits > 1:
        ws = torch.empty((splits * b * sq * h * (hd + 2),),
                         dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, _DTYPES[q.dtype],
            b, sq, sk, h, kv, hd, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), int(causal),
            int(window or 0), float(softcap or 0.0), int(q_offset), splits,
            chunk, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
