"""Shared LM primitives: norms, RoPE, initializers, softcap (the port's copy
of ``repro.nn.common``).

The reference's sharding hooks (``shard``, ``mesh_ctx``) are not copied:
on one device they do nothing. They belong to the model axis
(``ROADMAP.md`` §1, partitioning), which the data-parallel slice
(``repro_torch.dist``) did not need.
"""
from __future__ import annotations

from typing import Optional

import torch


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
    return w.mul_(1.0 / max(1, fan) ** 0.5).to(dtype)   # one fp32 transient


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
