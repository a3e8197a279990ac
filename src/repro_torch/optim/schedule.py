"""LR schedules, pure functions of the step counter (port of
``repro/optim/schedule.py``): a float32 scalar tensor, on the step's device
when the step is a tensor."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000, floor: float = 0.1):
    s = _f32(step)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def linear_warmup(step, *, warmup: int = 100):
    return torch.clamp(_f32(step) / max(warmup, 1), max=1.0)
