"""Learning-rate schedules (``repro/optim/schedules.py``): functions of the
int32 step tensor that return an f32 0-d tensor on its device."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def constant(value: float):
    return lambda step: torch.full((), value, dtype=F32, device=step.device)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = step.to(F32)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)

    return fn


def cosine_decay(peak: float, warmup_steps: int, total_steps: int,
                 floor: float = 0.1):
    def fn(step):
        s = step.to(F32)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return fn
