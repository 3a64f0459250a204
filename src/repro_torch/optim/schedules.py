"""Learning-rate schedules as functions of the step counter."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup_steps: int = 100,
                    total_steps: int = 10000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_ratio``: the multiplier
    of the optimizer's base lr, a float32 0-d tensor on ``step``'s device.
    Computed in float32 with the JAX package's op order, so it rounds as
    ``repro.optim.schedules.cosine_schedule`` does (but where the two
    ``cos`` differ, by an ulp)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, warmup_steps)
    t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)
