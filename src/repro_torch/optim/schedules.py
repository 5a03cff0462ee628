"""Learning-rate schedules.

Port of ``src/repro/optim/schedules.py``.  A schedule maps the optimizer's
step, an int32 tensor on the device, to a float32 rate on the same
device: no host sync inside a train step.
"""

from __future__ import annotations

import math

import torch


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int,
                       floor: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, peak * cos)
    return fn
