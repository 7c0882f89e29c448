"""Learning-rate schedules: functions of the integer step, evaluated in f32
as the reference's ``repro/optim/schedules.py`` evaluates them."""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda step: float(_f(value))


def linear_warmup_cosine_decay(peak: float, warmup_steps: int, total_steps: int,
                               end_factor: float = 0.1) -> Schedule:
    def fn(step):
        step = _f(step)
        if step < warmup_steps:
            return float(_f(peak) * step / _f(max(1.0, warmup_steps)))
        frac = (step - _f(warmup_steps)) / _f(max(1.0, total_steps - warmup_steps))
        frac = np.clip(frac, _f(0.0), _f(1.0))
        return float(_f(end_factor * peak) + _f((1 - end_factor) * peak) * _f(0.5)
                     * (_f(1) + np.cos(_f(np.pi) * frac)))

    return fn


def linear_decay(peak: float, total_steps: int, warmup_steps: int = 0) -> Schedule:
    def fn(step):
        step = _f(step)
        if step < warmup_steps:
            return float(_f(peak) * step / _f(max(1.0, warmup_steps)))
        frac = (step - _f(warmup_steps)) / _f(max(1.0, total_steps - warmup_steps))
        return float(_f(peak) * np.clip(_f(1.0) - frac, _f(0.0), _f(1.0)))

    return fn


def inverse_sqrt_schedule(peak: float, warmup_steps: int) -> Schedule:
    """The "Attention is All You Need" schedule."""

    def fn(step):
        step = _f(step) + _f(1.0)
        w = _f(max(1.0, warmup_steps))
        return float(_f(peak) * min(step / w ** _f(1.5), step ** _f(-0.5)) * np.sqrt(w))

    return fn
