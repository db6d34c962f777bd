"""Shared LM primitives: norms, RoPE, initializers, softcap and the
sharding hooks (the port's copy of ``repro.nn.common``).

The hooks: model code names its logical tensors (``shard``) and its
row-parallel contractions (``rp_einsum``); the step installs a resolver
(``sharding_context``, ``launch/partitioning.LogicalResolver``). With no
resolver installed each hook is the identity it is in the reference, so
every single-device path is unchanged. Under a resolver ``shard`` checks
the local shape against the resolver's spec (it copies nothing), and
``rp_einsum`` all-reduces its partial sums over ``model`` where the
resolver splits the contracted weight: in fp32, or, with v-D's
``bf16_reduce``, in the model dtype (the partials produced and summed in
it: 2 bytes an element on the wire); under v-E (``seq=True``) the sum is
a reduce-scatter over the sequence, and an unsplit contraction keeps the
rank's slice of the sequence.

``init_hook`` lets a caller see every ``dense_init`` draw as it is made
(the sharded initialization keeps each rank's slice of one leaf at a
time).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch

_SHARDING_CTX: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("repro_torch_sharding_ctx", default=None)
_INIT_HOOK: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("repro_torch_init_hook", default=None)


@contextlib.contextmanager
def sharding_context(resolver: Callable[[str, torch.Tensor], torch.Tensor]):
    token = _SHARDING_CTX.set(resolver)
    try:
        yield
    finally:
        _SHARDING_CTX.reset(token)


def shard(name: str, x: torch.Tensor) -> torch.Tensor:
    """The active resolver's check of logical tensor ``name`` (the
    identity without one)."""
    resolver = _SHARDING_CTX.get()
    if resolver is None:
        return x
    return resolver(name, x)


def mesh_ctx():
    """The active resolver object (mesh, axis and run-time metadata), or
    ``None``."""
    return _SHARDING_CTX.get()


def _contract(pattern: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The two row-parallel contractions of the layers as the matmuls the
    single-device path runs (``torch.einsum`` for any other pattern)."""
    if pattern == "bqhk,hkd->bqd":
        h, k, d = b.shape
        return torch.matmul(a.reshape(a.shape[0], a.shape[1], h * k),
                            b.reshape(h * k, d))
    if pattern == "bsf,fd->bsd":
        return a @ b
    return torch.einsum(pattern, a, b)


class _Partials(torch.autograd.Function):
    """``a @ b`` of bf16 / fp16 matrices with fp32 output: the tensor-core
    GEMM accumulates in fp32 and writes its partial sums without rounding
    them (``torch.mm``'s ``out_dtype`` on CUDA; the CPU widens the operands,
    whose products fp32 holds exactly). The backward runs in the operands'
    dtype, as the single-device matmul's does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.t() if ctx.needs_input_grad[0] else None,
                a.t() @ g if ctx.needs_input_grad[1] else None)


def _partials(pattern: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The contraction's fp32 partial sums from operands in their own
    dtype (fp32 ones contract as ``_contract`` does)."""
    if a.dtype not in (torch.bfloat16, torch.float16):
        return _contract(pattern, a, b)
    if pattern == "bqhk,hkd->bqd":
        b = b.reshape(-1, b.shape[-1])
    elif pattern != "bsf,fd->bsd":
        raise ValueError(f"no fp32-output form of {pattern!r}")
    out = _Partials.apply(a.reshape(-1, b.shape[0]), b)
    return out.reshape(a.shape[0], a.shape[1], b.shape[1])


def rp_einsum(pattern: str, a: torch.Tensor, b: torch.Tensor, *,
              leaf: str, seq: bool = False) -> torch.Tensor:
    """Row-parallel einsum: where the resolver splits ``leaf`` (``"wo"``,
    ``"w_down"``) over ``model``, the contraction's partial sums are taken
    in fp32 from operands in the model dtype, all-reduced over ``model``
    and cast to ``a``'s dtype (XLA's hoisted-fp32 all-reduce in the
    reference); with ``bf16_reduce`` (v-D) the partials are produced and
    all-reduced in ``a``'s dtype. ``seq`` (v-E: ``a`` holds the whole
    sequence, the result the rank's slice of it) reduce-scatters over the
    sequence instead, or slices an unsplit contraction. Otherwise, and
    with no resolver, the plain contraction."""
    ctx = mesh_ctx()
    if ctx is None or not ctx.splits(leaf):
        out = _contract(pattern, a, b)
        return ctx.seq_slice(out) if seq else out
    if ctx.bf16_reduce:
        part, wire = _contract(pattern, a, b), a.dtype
    else:
        part, wire = _partials(pattern, a, b), torch.float32
    if seq:
        return ctx.seq_reduce_scatter(part, a.dtype, wire)
    return ctx.reduce_model(part, a.dtype, wire)


@contextlib.contextmanager
def init_hook(fn: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, ``dense_init`` returns ``fn(weights)``."""
    token = _INIT_HOOK.set(fn)
    try:
        yield
    finally:
        _INIT_HOOK.reset(token)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm with fp32 accumulation. ``plus_one`` = Gemma-style (1+w)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (x * w).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply RoPE (half-split, fp32 angles). x: [B, S, H, hd]; positions:
    [S] integers shared across the batch."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * freqs
    cos = torch.cos(ang)[None, :, None, :]                     # [1, S, 1, half]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_device(generator: Optional[torch.Generator]) -> torch.device:
    """Where initializers put their tensors: the generator's device, or the
    meta device (shapes only) for ``None``."""
    return generator.device if generator is not None else torch.device("meta")


def dense_init(shape, dtype: torch.dtype,
               generator: Optional[torch.Generator], *,
               fan_in: Optional[int] = None, lead: tuple = ()) -> torch.Tensor:
    """Normal weights scaled by ``1/sqrt(fan_in)`` (default ``shape[0]``),
    drawn in fp32 from ``generator`` on its device, then cast. ``lead``
    prepends stacked dimensions (a stage's repeats) that the fan ignores."""
    fan = fan_in if fan_in is not None else shape[0]
    w = torch.randn(tuple(lead) + tuple(shape), generator=generator,
                    device=init_device(generator), dtype=torch.float32)
    w = w.mul_(1.0 / max(1, fan) ** 0.5).to(dtype)      # one fp32 transient
    hook = _INIT_HOOK.get()
    return w if hook is None else hook(w)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
