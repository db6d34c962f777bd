"""LR schedules (pure functions of the step counter), as in
``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor_frac: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup_steps``, then a cosine decay
    to ``floor_frac * peak`` at ``total_steps``; ``lr(step)`` takes and
    returns a tensor (fp32), on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(1, warmup_steps)
        frac = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor_frac * peak + (1 - floor_frac) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
