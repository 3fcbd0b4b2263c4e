"""Learning-rate schedules (callables: step -> lr), the port of
`repro/optim/schedules.py` with its formulas and clip points.

Each takes an integer step tensor (0-dim) and returns an f32 lr on the
step's device.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_decay(lr: float, decay_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.to(torch.float32), max=decay_steps) / decay_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                         final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac)
                    * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
