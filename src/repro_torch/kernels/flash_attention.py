"""K10: grouped-query flash attention for LM prefill and decode, and its
plain version.

``flash_attention``        the wrapper: a CPU tensor runs the plain version,
                           a CUDA tensor launches one of the hand-written
                           Hopper kernels in ``csrc/flash_attention.cu``
                           (which replace ``repro/kernels/
                           flash_attention.py``'s Pallas kernel), the one
                           ``plan`` names. Nothing falls back: a failed build
                           or launch raises. ``flash_attention.launches``
                           counts its calls that launch.
``flash_attention_plain``  the einsum / softmax of ``repro/nn/attention.py``
                           (and ``tests/test_flash.py::ref_attention``) on
                           tensors, in fp32, for any lengths.
``plan``                   the kernel a call takes (``route``), its key
                           splits and how many kernels it launches.
``FlashAttention``         K10 under autograd, which ``flash_attention``
                           goes through whenever a gradient is wanted: the
                           forward as above; the backward recomputes the
                           plain version from the saved ``q, k, v`` and
                           takes its VJP. The reference has no backward
                           kernel either: its training attention is XLA's
                           autodiff of the same einsum / softmax
                           (``repro/nn/attention.py``), which is what the
                           plain version computes.

Both take ``q [B, Sq, H, hd]`` and ``k, v [B, Sk, KV, hd]`` (KV divides H;
head ``h`` reads KV head ``h // (H / KV)``), query ``i`` at position
``q_offset + i`` and key ``j`` at position ``j``, and return ``[B, Sq, H,
hd]`` in ``q``'s dtype. Unlike the Pallas kernel, neither length has to be
a multiple of a tile. A row that sees no key (its window starts past the
last key) averages every value, as the Pallas kernel's does.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

_NEG = -1e30

# rows a thread block of the "fma" kernel serves, and of the "mma" kernel
# (128 at hd 128); the "mma" route takes calls of at least this many rows.
# Keys a tile of each route's kernel (a key split's chunk is a multiple).
ROWS_PER_BLOCK = 64
KEY_TILE = {"fma": 32, "mma": 64, "decode": 16}
# key splits: towards this many thread blocks per SM, at least this many
# keys a split
_BLOCKS_PER_SM = 2
_MIN_SPLIT_KEYS = 128
MAX_HEAD_DIM = 256
# the kernels of ``csrc/flash_attention.cu``, by the id the C entry takes
ROUTES = ("fma", "mma", "decode")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_fwd": ([_P] * 5 + [_I] * 8 + [_L] * 6
                            + [_I, _I, ctypes.c_float, _I, _I, _I, _P]),
    "flash_attention_smem_bytes": [_I, _I],
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


class Plan(NamedTuple):
    """How one call runs on the card: the kernel (``route``), the thread
    blocks sharing each key range (``splits``) and the keys of each."""
    route: str
    splits: int
    chunk: int

    @property
    def kernels(self) -> int:
        """Kernels the call launches: the route's, and the split combine
        where the keys are split."""
        return 2 if self.splits > 1 else 1


def route(dtype: torch.dtype, hd: int, rows: int) -> str:
    """The kernel a call takes, by dtype, head dim and its ``Sq * g``
    flattened (query, head-in-group) rows: ``"mma"`` (tensor cores) for
    bf16 with ``hd`` a multiple of 16 and at least 64 rows (every prefill),
    ``"decode"`` (the warps spread over the keys) for the same with fewer
    rows, and ``"fma"`` (CUDA-core fp32 FMAs) for fp32 inputs and bf16 at
    other head dims. A dispatch between kernels, not a fallback: each
    raises if it fails to build or launch."""
    if dtype != torch.bfloat16 or hd % 16:
        return "fma"
    return "mma" if rows >= ROWS_PER_BLOCK else "decode"


def key_splits(b: int, kv: int, rows: int, sk: int, sms: int,
               route: str) -> Tuple[int, int]:
    """``(splits, chunk)``: how many thread blocks share each key range, and
    the keys of each (a multiple of ``KEY_TILE[route]``). The grid has
    ``b * kv`` blocks at decode (one serves every row of a (batch, KV
    head)), else ``b * kv * ceil(rows / 64)``. A grid that leaves SMs idle
    is split towards at most ``2 * sms`` blocks, at least 128 keys a split;
    it depends on the shapes only, so every decode step over one cache
    splits alike."""
    base = b * kv * (1 if route == "decode" else -(-rows // ROWS_PER_BLOCK))
    if base >= sms:
        return 1, sk
    splits = max(1, min(_BLOCKS_PER_SM * sms // base,
                        -(-sk // _MIN_SPLIT_KEYS)))
    tile = KEY_TILE[route]
    chunk = -(-sk // splits)
    chunk = -(-chunk // tile) * tile
    return -(-sk // chunk), chunk


def plan(q: torch.Tensor, k: torch.Tensor,
         sms: Optional[int] = None) -> Plan:
    """The ``Plan`` of ``flash_attention(q, k, ...)`` on a card of ``sms``
    SMs (default: ``q``'s card)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rows = sq * (h // kv)
    if sms is None:
        index = q.device.index if q.device.index is not None else \
            torch.cuda.current_device()
        sms = _sm_count(index)
    r = route(q.dtype, hd, rows)
    return Plan(r, *key_splits(b, kv, rows, sk, sms, r))


def _operand(t: torch.Tensor, hd: int, align: int) -> torch.Tensor:
    """``t`` itself where the kernel can read it in place, else a
    contiguous copy. In place: unit element stride, heads ``hd`` apart,
    batch and sequence strides multiples of ``align`` elements (16 bytes
    for the tensor-core and decode kernels' loads, 4 elements for the
    CUDA-core kernel's), a 16-byte aligned base. A KV cache's ``[B, Sk, KV,
    hd]`` slice passes (its strides are multiples of ``KV * hd``), so only
    a layout that breaks one of these is copied."""
    if (t.stride(3) == 1 and t.stride(2) == hd and t.stride(0) % align == 0
            and t.stride(1) % align == 0 and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous() if not t.is_contiguous() else t.clone()


# the bytes of one fp32 [rows, h, Sq, Sk] score tensor of the backward's
# recompute: a batch whose tensor would be larger is taken a few rows at a
# time. The plain VJP keeps several such tensors alive at once (the
# scores, the masked copy, the probabilities and their gradients), so its
# peak is a few times this
_BACKWARD_SCORE_BYTES = 1 << 30


class FlashAttention(torch.autograd.Function):
    """K10 under autograd. Only ``q, k, v`` are saved, never the ``[B, KV,
    g, Sq, Sk]`` probabilities: the backward recomputes the plain version
    under ``enable_grad`` (a few batch rows at a time, so each of its fp32
    score tensors stays near ``_BACKWARD_SCORE_BYTES``) and returns its
    VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        return _forward(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        b, sq, h, _ = q.shape
        per_row = 4 * h * sq * k.shape[1]
        rows = max(1, min(b, _BACKWARD_SCORE_BYTES // max(1, per_row)))
        grads = [[] for _ in range(3)]
        with torch.profiler.record_function("flash_attention.backward"), \
                torch.enable_grad():
            for lo in range(0, b, rows):
                part = [t[lo:lo + rows].detach().requires_grad_(w)
                        for t, w in zip((q, k, v), want)]
                out = flash_attention_plain(*part, **ctx.opts)
                got = torch.autograd.grad(
                    out, [t for t in part if t.requires_grad],
                    dout[lo:lo + rows])
                it = iter(got)
                for i, w in enumerate(want):
                    if w:
                        grads[i].append(next(it))
        dq, dk, dv = (torch.cat(g) if len(g) > 1 else (g[0] if g else None)
                      for g in grads)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> torch.Tensor:
    """K10: attention of ``q`` over ``k, v`` (see the module docstring),
    reading a KV cache's ``[B, Sk, KV, hd]`` slice in place. ``window``
    (at least 1) and ``softcap`` (positive) are optional; ``q_offset`` is a
    run-time argument of the kernel. Where grad is enabled and an input
    requires it, the call goes through ``FlashAttention`` (the same
    forward, a backward); serving's calls (no input requires grad) do not.
    """
    _check_shapes(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap={softcap} must be > 0")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    q_offset)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset)


_WATCHERS: list = []


@contextlib.contextmanager
def watch_forward(before: Callable[[], None],
                  after: Callable[..., None]):
    """While inside, ``before()`` runs before every forward of K10 and
    ``after(q, k, v, out)`` after it (``out`` ``None`` if it raised): for
    tools that account for K10 as one kernel, such as the dry run's
    memory proxy, which skips the plain version's ops between the two."""
    pair = (before, after)
    _WATCHERS.append(pair)
    try:
        yield
    finally:
        _WATCHERS.remove(pair)


def _forward(q, k, v, **opts):
    """The forward of K10 on checked arguments, inside the watchers'
    ``before`` / ``after`` (``watch_forward``)."""
    if not _WATCHERS:
        return _run(q, k, v, **opts)
    watchers = list(_WATCHERS)
    for before, _ in watchers:
        before()
    out = None
    try:
        out = _run(q, k, v, **opts)
        return out
    finally:
        for _, after in watchers:
            after(q, k, v, out)


def _run(q, k, v, *, causal, window, softcap, q_offset):
    """The forward of K10 on checked arguments: the plain version on a CPU
    tensor, the kernel on a CUDA one."""
    b, sq, h, hd, sk, kv = _check_shapes(q, k, v)
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
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or sk == 0:
        return out.zero_()                        # nothing is launched
    pl = plan(q, k)
    # the grid's y dimension: (batch, KV head) pairs on the CUDA-core
    # kernel, row blocks on the tensor-core one, key splits at decode
    grid_y = {"fma": b * kv, "mma": -(-sq * (h // kv) // ROWS_PER_BLOCK),
              "decode": pl.splits}[pl.route]
    if grid_y > 65535:
        raise ValueError(f"flash_attention: {grid_y} thread blocks in the "
                         f"grid's y dimension exceed its 65535")
    align = 4 if pl.route == "fma" else 16 // q.element_size()
    q, k, v = (_operand(t, hd, align) for t in (q, k, v))
    lib = _library()
    smem = lib.flash_attention_smem_bytes(ROUTES.index(pl.route), hd)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: head_dim {hd} needs {smem} bytes "
                         f"of shared memory per block (limit "
                         f"{build.MAX_SMEM_BYTES})")
    ws = None
    if pl.splits > 1:
        ws = torch.empty((pl.splits * b * sq * h * (hd + 2),),
                         dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, _DTYPES[q.dtype],
            ROUTES.index(pl.route), b, sq, sk, h, kv, hd, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            int(causal), int(window or 0), float(softcap or 0.0),
            int(q_offset), pl.splits, pl.chunk,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
