"""Learning-rate schedules (port of ``repro.optim.schedule``): warmup plus
linear or cosine decay, as in You et al.  Each returns ``lr(step)``, a
Python float computed in f32 like the reference's jnp version."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

_F = np.float32


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0) -> Callable:
    def lr(step):
        step = _F(step)
        warm = _F(peak_lr) * step / _F(max(warmup_steps, 1))
        frac = np.clip((_F(total_steps) - step) / _F(max(total_steps - warmup_steps, 1)),
                       _F(0), _F(1))
        decay = _F(floor) + _F(peak_lr - floor) * frac
        return float(warm if step < warmup_steps else decay)

    return lr


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0) -> Callable:
    def lr(step):
        step = _F(step)
        warm = _F(peak_lr) * step / _F(max(warmup_steps, 1))
        t = np.clip((step - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1)),
                    _F(0), _F(1))
        decay = _F(floor) + _F(0.5) * _F(peak_lr - floor) * (_F(1) + np.cos(_F(math.pi) * t))
        return float(warm if step < warmup_steps else decay)

    return lr


def constant(lr_value: float) -> Callable:
    def lr(step):
        return float(_F(lr_value))

    return lr
