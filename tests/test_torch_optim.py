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


# ------------------------------------------------------------ the AdamW kernel

ADAMW_KW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)


def _eager_adamw(g, m, v, p, *, b1, b2, eps, weight_decay, lr, t):
    """The optimizer's eager AdamW body before it became a kernel, verbatim."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    upd = m / bc1
    upd.div_(torch.sqrt(v / bc2).add_(eps))
    upd.add_(weight_decay * p)
    return upd.mul_(-lr)


def _adamw_leaf(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    g = (1e-2 * rng.standard_normal(shape)).astype(np.float32)
    g.reshape(-1)[:5] = [np.nan, np.inf, -np.inf, -0.0, 1e-40]
    m = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    v = (1e-4 * rng.random(shape)).astype(np.float32)
    m.reshape(-1)[5:9], v.reshape(-1)[5:9] = 0.0, 0.0
    p = rng.standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(g).to(dtype), torch.from_numpy(m), torch.from_numpy(v),
            torch.from_numpy(p).to(dtype))


@pytest.mark.parametrize("shape", [(8, 1000), (8, 1001), (4, 3, 257)], ids=str)
@pytest.mark.parametrize("t", [1, 2, 300])
@pytest.mark.parametrize("lr", [0.0, 3e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_adamw_update_cpu_path_equals_the_eager_body(shape, t, lr, dtype):
    """The wrapper's CPU path is the optimizer's pre-kernel eager body, bit
    for bit: the update, and ``m`` and ``v`` in place (NaN, +-inf, -0.0 and
    a subnormal in ``g``; the sign of a zero update at lr 0)."""
    from repro_torch.kernels import adamw as ak
    from repro_torch.kernels import ref

    g, m, v, p = _adamw_leaf(shape, dtype, seed=t)
    me, ve = m.clone(), v.clone()
    calls = ak.adamw_update.calls
    got = ak.adamw_update(g, m, v, p, lr=lr, t=t, **ADAMW_KW)
    want = _eager_adamw(g, me, ve, p, lr=lr, t=t, **ADAMW_KW)
    assert ak.adamw_update.calls == calls + 1
    assert got.dtype == torch.float32 and got.shape == g.shape
    for a, b in ((got, want), (m, me), (v, ve)):
        assert ref.same_bits(a, b)
    if lr == 0.0:                                   # -0.0 * upd: zeros of both signs
        zero = got[~got.isnan()]
        assert bool((zero == 0).all()) and bool(zero.signbit().any() & (~zero.signbit()).any())


def test_adamw_optimizer_takes_the_wrapper_once_a_leaf():
    """``adamw().update`` calls the wrapper once a leaf, and its moments and
    updates are the eager body's."""
    from repro_torch.kernels import adamw as ak
    from repro_torch.kernels import ref

    leaves = {"a": _adamw_leaf((4, 33), torch.float32, 1), "b": _adamw_leaf((7,), torch.float32, 2)}
    params = {k: l[3] for k, l in leaves.items()}
    opt = to.adamw(weight_decay=0.01)
    state = opt.init(params)
    grads = {k: l[0] for k, l in leaves.items()}
    calls = ak.adamw_update.calls
    upd, state = opt.update(grads, state, params, 3e-3)
    assert ak.adamw_update.calls == calls + 2 and state.step == 1
    for k, p in params.items():
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        want = _eager_adamw(grads[k], m, v, p, lr=3e-3, t=1, **ADAMW_KW)
        assert ref.same_bits(upd[k], want)
        assert ref.same_bits(state.m[k], m) and ref.same_bits(state.v[k], v)


def test_adamw_update_checks_its_inputs():
    from repro_torch.kernels import adamw as ak

    g, m, v, p = _adamw_leaf((8, 12), torch.float32, 0)
    kw = dict(lr=3e-3, t=1, **ADAMW_KW)
    calls = ak.adamw_update.calls
    with pytest.raises(ValueError):
        ak.adamw_update(g, m, v[:, :11].contiguous(), p, **kw)          # shapes
    with pytest.raises(TypeError):
        ak.adamw_update(g.double(), m, v, p.double(), **kw)              # leaf dtype
    with pytest.raises(TypeError):
        ak.adamw_update(g.bfloat16(), m, v, p, **kw)                    # g and p differ
    with pytest.raises(TypeError):
        ak.adamw_update(g, m.bfloat16(), v, p, **kw)                    # moments f32
    with pytest.raises(ValueError):
        ak.adamw_update(g.t(), m.t(), v.t(), p.t(), **kw)               # not contiguous
    with pytest.raises(ValueError):
        meta = [x.to("meta") for x in (g, m, v, p)]
        ak.adamw_update(*meta, **kw)                                    # device
    assert ak.adamw_update.calls == calls                              # refused: not counted
    assert ak.adamw_update.launches == 0                               # no kernel on the CPU


def test_adamw_scalars_are_torchs_float32_roundings():
    """The kernel's scalars: each Python scalar rounded to float32, ``1 - b``
    and ``-lr`` taken in Python first, the bias corrections as reciprocals."""
    from repro_torch.kernels import adamw as ak

    s = ak.adamw_scalars(lr=3e-3, t=7, **ADAMW_KW)
    f32 = np.float32
    bc1 = f32(1) - f32(0.9) ** f32(7)
    bc2 = f32(1) - f32(0.95) ** f32(7)
    assert s == (float(f32(0.9)), float(f32(1 - 0.9)), float(f32(0.95)), float(f32(1 - 0.95)),
                 float(f32(1) / bc1), float(f32(1) / bc2), float(f32(1e-8)), float(f32(0.01)),
                 float(f32(-3e-3)))
    assert all(float(f32(x)) == x for x in s)
    assert np.signbit(ak.adamw_scalars(lr=0.0, t=1, **ADAMW_KW)[-1])
