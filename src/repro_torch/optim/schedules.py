"""LR schedules as step -> lr callables, the reference's
``repro.optim.schedules`` in Python floats."""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[float], float]


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1) -> Schedule:
    def fn(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        if step < warmup_steps:
            return lr * min(step / max(warmup_steps, 1), 1.0)
        return cos(step - warmup_steps)
    return fn
