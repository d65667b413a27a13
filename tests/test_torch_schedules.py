"""The port's learning-rate schedules against the JAX package's, jitted.

The JAX runtime evaluates its schedule inside the jitted step, so the
reference is ``jax.jit`` of the JAX schedule on the CPU.  Every step of the
training driver's defaults (lr 3e-3, warmup 20, 300 steps) must be the same
float32 value, bit for bit, warmup and cosine branch alike; so must a second
setting with another final fraction, and ``inv_sqrt_decay``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.optim import schedules as js
from repro_torch.optim import schedules as ts

CASES = [("linear_warmup_cosine", (3e-3, 20, 300), 300),     # the driver's defaults
         ("linear_warmup_cosine", (1e-3, 7, 131, 0.25), 140),
         ("cosine_decay", (2e-2, 97), 110),
         ("inv_sqrt_decay", (3e-3, 20), 300),
         ("inv_sqrt_decay", (1e-2, 3), 60),
         ("constant", (3e-3,), 4)]


def _jax_values(name, args, steps):
    f = jax.jit(getattr(js, name)(*args))
    return np.array([np.asarray(f(jnp.int32(s))) for s in range(steps)], np.float32)


@pytest.mark.parametrize("name,args,steps", CASES)
def test_schedule_bit_equal_to_jitted_jax(name, args, steps):
    want = _jax_values(name, args, steps)
    f = getattr(ts, name)(*args)
    got = np.array([f(s) for s in range(steps)], np.float32)
    bad = np.nonzero(got.view(np.int32) != want.view(np.int32))[0]
    assert bad.size == 0, [(int(s), float(got[s]), float(want[s])) for s in bad[:8]]
    assert all(isinstance(f(s), float) for s in range(3))


def test_fma32_rounds_once():
    # 1 + 2^-24 is a float32 tie: rounded once it goes to even (1.0); the
    # exact product term below pushes it just past the tie
    one, tiny = np.float32(1.0), np.float32(2.0 ** -12)
    assert ts._fma32(tiny, tiny, one) == np.float32(1.0)
    assert ts._fma32(np.float32(1 + 2 ** -23), tiny * tiny, one) == np.nextafter(one, np.float32(2))
