"""Gradient compression for a cross-group all-reduce: blockwise int8 with
error feedback (the port's copy of ``repro.optim.compression``).

``compressed_psum`` quantizes each block of 256 values to int8 against a
scale shared by every member of the group, sums the int8 payload widened
to int32 and dequantizes: 4x fewer bytes on the wire than fp32. The
shared scale is an all-reduce MAX (exact) and the payload an all-reduce
SUM of integers (exact, in any order), so the result is the same bits on
every member and in every order: the port's rule of no float all-reduce
holds. The collectives go through the caller's ``launch.mesh.RankMesh``
over its ``axes`` (the pods: ``("pod",)``), so gloo on a card gets the
host staging that every other collective of the mesh gets; without a mesh
(one member) nothing is exchanged. A failed collective raises.
``ErrorFeedback`` carries each step's quantization residual into
the next (EF-SGD), which removes the bias. Rounding is half-to-even, as
``jnp.round``'s.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.optim.adamw import tree_like, tree_leaves, tree_map


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` flattened, zero-padded to a multiple of ``block``, as fp32
    ``[n_blocks, block]``."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block).to(torch.float32)


def _scale(blocks: torch.Tensor) -> torch.Tensor:
    """Each block's ``max |x| / 127``, a true division (CUDA divides by a
    Python scalar as a product with its rounded reciprocal, which can
    differ from the quotient in the last bit)."""
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    return amax / torch.full_like(amax, 127.0)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor,
                  block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization: ``(q [n, block] int8,
    scales [n, 1] fp32)``."""
    blocks = _blocks(x, block)
    scale = _scale(blocks)
    scale = torch.clamp(scale, min=1e-12)
    return _quantize(blocks, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compressed_psum(x: torch.Tensor, mesh: Optional[Any] = None,
                    axes: Tuple[str, ...] = ("pod",),
                    block: int = 256) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh``'s ``axes`` (a
    ``launch.mesh.RankMesh``; ``None``: one member) in the int8 wire
    format: quantize against the per-block MAX of the members' scales,
    sum the int8 payload in int32, dequantize. Every member returns the
    same tensor, in ``x``'s shape and dtype."""
    blocks = _blocks(x, block)
    scale = _scale(blocks)
    if mesh is not None:
        scale = mesh.all_reduce(scale, axes, op="max")
    scale = torch.clamp(scale, min=1e-12)
    acc = _quantize(blocks, scale).to(torch.int32)
    if mesh is not None:
        acc = mesh.all_reduce(acc, axes, op="sum")
    out = (acc.to(torch.float32) * scale).reshape(-1)
    return out[:x.numel()].reshape(x.shape).to(x.dtype)


class ErrorFeedback:
    """e_{t+1} = g_t + e_t - C(g_t + e_t); apply C's output, carry the
    residual. Trees are the port's (``optim.adamw.tree_leaves``)."""

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    @staticmethod
    def compress(grads: Any, residual: Any, block: int = 256):
        comp, res = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(residual)):
            target = g.to(torch.float32) + e
            q, s = quantize_int8(target, block)
            deq = dequantize_int8(q, s, g.shape, torch.float32)
            comp.append(deq.to(g.dtype))
            res.append(target - deq)
        return tree_like(grads, comp), tree_like(residual, res)
