"""Segment reductions in torch, with the reference's empty-segment values.

``repro.compat`` wraps ``jax.ops.segment_sum`` / ``segment_max``. These are
their torch counterparts for the plain (CPU) paths and the oracles:

* ``segment_sum``: an empty segment sums to 0;
* ``segment_max``: an empty segment is ``-inf``, exactly as JAX gives it
  (the buffer starts at ``-inf`` and ``include_self=False`` keeps that
  value only where no row lands). Callers map non-finite values to 0
  where the reference does (``core/codegen.py``, ``kernels/ref.py``).

On a CUDA tensor both reduce with atomics. The forward never calls them
there (its per-destination reductions run in the traversal kernels); the
softmax VJP's ``segment_sum`` does, as the reference leaves it to XLA, so
that gradient is deterministic on the card only to the ulp.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows per segment id -> [num_segments, ...]."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data`` rows per segment id; empty segments -> -inf."""
    shape = (num_segments,) + tuple(data.shape[1:])
    out = data.new_full(shape, -float("inf"))
    idx = segment_ids.long()
    if data.dim() > 1:
        idx = idx.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)
