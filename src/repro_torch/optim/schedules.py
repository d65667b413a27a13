"""Learning-rate schedules: host functions of the integer step.

The port of the JAX package's ``optim/schedules.py``.  Each schedule returns
a Python float that is a float32 value, computed in float32 numpy on the
same expression as the JAX version, so the learning rate stays on the host
and no device scalar has to be read back.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr: float):
    return lambda step: float(_F(lr))


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step: int) -> float:
        t = np.minimum(_F(step), _F(total_steps)) / _F(total_steps)
        cos = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * t))
        return float(_F(lr) * (_F(final_frac) + (_F(1) - _F(final_frac)) * cos))
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cd = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step: int) -> float:
        s = _F(step)
        if s < warmup:
            return float(_F(lr) * s / _F(max(warmup, 1)))
        return cd(step - warmup)
    return f
