"""LR schedules as pure functions of the step counter (port of
``repro.optim.schedules``): float32 0-dim tensors, as the reference's."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_linear(base_lr: float, warmup: int, total: int):
    def f(step):
        step = _f32(step)
        wu = torch.clamp(step / max(warmup, 1), max=1.0)
        decay = torch.clamp(1.0 - step / max(total, 1), min=0.0)
        return base_lr * wu * decay
    return f


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def f(step):
        step = _f32(step)
        wu = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * wu * cos
    return f
