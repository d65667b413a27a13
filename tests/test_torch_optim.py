"""``global_norm`` and ``clip_by_global_norm`` of the port against the JAX
package's.  The norm is a float32 sum of squares over the leaves; the two
frameworks reduce in different orders, so the norms agree to rtol 1e-6 and
the clipped gradients to the same relative tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jo
from repro_torch.optim import optimizers as to

RTOL = 1e-6


def _grads(rng, scale):
    return {"blk": {"w": (scale * rng.standard_normal((3, 40, 17))).astype(np.float32),
                    "b": (scale * rng.standard_normal((3, 17))).astype(np.float32)},
            "emb": (scale * rng.standard_normal((50, 8))).astype(np.float32)}


@pytest.mark.parametrize("scale,max_norm", [(1e-3, 1.0), (1.0, 1.0), (10.0, 0.5), (0.0, 1.0)])
def test_global_norm_and_clip_match_jax(scale, max_norm):
    g = _grads(np.random.default_rng(int(scale * 10) + 1), scale)
    jg = jax.tree.map(jnp.asarray, g)
    tg = jax.tree.map(torch.from_numpy, g)
    jn = float(jo.global_norm(jg))
    tn = to.global_norm(tg)
    assert tn.dtype == torch.float32 and tn.dim() == 0
    np.testing.assert_allclose(float(tn), jn, rtol=RTOL)
    jc, jn2 = jo.clip_by_global_norm(jg, max_norm)
    tc, tn2 = to.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn2), float(jn2), rtol=RTOL)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tc)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jc)), strict=True):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    if scale == 0.0:
        assert float(tn) == 0.0 and all(bool((t == 0).all()) for t in jax.tree.leaves(tc))


def test_global_norm_of_bf16_leaves_is_float32():
    t = {"a": torch.full((4,), 3.0, dtype=torch.bfloat16), "b": torch.full((1,), 4.0)}
    assert float(to.global_norm(t)) == float(np.sqrt(np.float32(4 * 9 + 16)))
    assert to.global_norm(t).dtype == torch.float32
