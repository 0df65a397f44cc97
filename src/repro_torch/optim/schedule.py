"""LR schedules: linear warmup + cosine decay (the production default).

The port of the reference's ``repro.optim.schedule``, in float32 as the
reference computes it.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 200, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    """Multiplier in [floor, 1]: linear warmup then cosine to floor.

    ``step`` is an int or a scalar tensor (the optimizer's step); the
    result is a float32 scalar on ``step``'s device.  Step 0 gives 0, so
    the first update of a run moves nothing."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
