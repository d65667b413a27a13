"""Learning-rate schedules: host functions of the integer step.

The port of the JAX package's ``optim/schedules.py``.  The JAX runtime
evaluates a schedule inside its jitted step, so the value it trains with is
what XLA's CPU backend computes, not the expression as written.  Each
schedule here returns that float32 value as a Python float, computed on the
host so that no device scalar has to be read back:

* XLA folds constants first, in float32: a division by a constant ``k``
  becomes a product with ``1/k``, and the constants of a product chain
  fold into one, so ``lr * s / warmup`` is ``s * (lr * (1/warmup))``,
  ``pi * (m / T)`` is ``m * (pi * (1/T))`` and ``(1 - f) * (0.5 * c)`` is
  ``c * ((1 - f) * 0.5)``.
* It contracts ``c * k + f`` into one fused multiply-add (:func:`_fma32`).
* Its ``cos`` is the C library's float32 ``cosf``, which is not correctly
  rounded everywhere; :func:`_cosf` calls the same function.

``tests/test_torch_schedules.py`` holds every step of the defaults to the
jitted JAX schedules, bit for bit.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction

import numpy as np

_F = np.float32
_libc = ctypes.CDLL(None)
_libc.cosf.restype = ctypes.c_float
_libc.cosf.argtypes = [ctypes.c_float]


def _cosf(x) -> np.float32:
    return _F(_libc.cosf(float(x)))


def _fma32(a, b, c) -> np.float32:
    """``a*b + c`` rounded once to float32 (ties to even), as an FMA does."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    best = _F(float(exact))
    for nb in (np.nextafter(best, _F(np.inf)), np.nextafter(best, _F(-np.inf))):
        d_best, d_nb = abs(Fraction(float(best)) - exact), abs(Fraction(float(nb)) - exact)
        if d_nb < d_best or (d_nb == d_best and int(nb.view(np.int32)) & 1 == 0):
            best = nb
    return best


def constant(lr: float):
    return lambda step: float(_F(lr))


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    c_angle = _F(np.pi) * (_F(1) / _F(total_steps))
    c_half = _F(1 - final_frac) * _F(0.5)

    def f(step: int) -> float:
        angle = np.minimum(_F(step), _F(total_steps)) * c_angle
        return float(_fma32(_cosf(angle) + _F(1), c_half, _F(final_frac)) * _F(lr))
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cd = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)
    slope = _F(lr) * (_F(1) / _F(max(warmup, 1)))

    def f(step: int) -> float:
        s = _F(step)
        if s < warmup:
            return float(s * slope)
        return cd(step - warmup)
    return f


def inv_sqrt_decay(lr: float, warmup: int):
    """The paper's theory steplength shape: gamma ~ 1/(c + sqrt(T))."""
    w = _F(max(warmup, 1))
    inv_w = _F(1) / w

    def f(step: int) -> float:
        s = np.maximum(_F(step), _F(1))
        return float(np.minimum(s * inv_w, np.sqrt(_F(warmup) / s)) * _F(lr))
    return f
