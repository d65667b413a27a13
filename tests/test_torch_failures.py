"""Edge drops in the port against the JAX package's failure injection.

The drop masks are bit-equal to JAX's over rates, salts, shifts, node
counts and encode counters up to 2^32 - 1; freshness, gated weights, the
gated mix, ``select_delivered`` and the realized mixing matrices are equal
to JAX's eager results.  Every realized matrix is row-stochastic as the JAX
tier pins it (``assert_allclose(..., atol=1e-12)`` at numpy's default rtol
1e-7: a float32 row of three 1/3 weights sums to 1 + 3e-8).  The runtime
under drops (rate 0.3, salt 7) is held to the JAX runtime step for every
gossip algorithm on every kind of plan with the cases of
``test_torch_runtime_plans.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import failures as jf
from repro.distributed import gossip as jg
from repro_torch.distributed import failures as tf
from repro_torch.distributed import gossip as tg
from test_torch_runtime_plans import DROP, GOSSIP, TOPOLOGIES, check_step_against_jax

STEPS = [0, 1, 2, 3, 17, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]


@pytest.mark.parametrize("n", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("spec", ["0.1", "0.3:7", "0.5:123456789:0.25", "0.99:4294967295"])
def test_edge_drop_mask_bit_equal_to_jax(n, spec):
    jspec, tspec = jf.make_drop_spec(spec), tf.make_drop_spec(spec)
    assert (tspec.rate, tspec.salt, tspec.decay) == (jspec.rate, jspec.salt, jspec.decay)
    shifts = sorted({jg._canon_shift(s, n) for s in range(-n, n + 1)}) if n > 1 else [0]
    for s in shifts:
        f = jax.jit(lambda st, s=s: jf.edge_drop_mask(n, s, st, jspec))
        for step in STEPS:
            want = np.asarray(f(np.uint32(step)))
            got = tf.edge_drop_mask(n, s, step, tspec)
            assert got.dtype == torch.float32 and got.shape == (n,)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"shift {s} step {step}")


def test_drop_spec_parsing_and_keys():
    assert tf.make_drop_spec(None) is None and tf.make_drop_spec(0.0) is None
    assert tf.make_drop_spec("0") is None and tf.make_drop_spec(tf.DropSpec(0.0)) is None
    d = tf.make_drop_spec(0.25, salt=3, decay=0.75)
    assert d == tf.DropSpec(0.25, 3, 0.75) and d.describe() == jf.DropSpec(0.25, 3, 0.75).describe()
    for bad in ({"rate": 1.0}, {"rate": -0.1}, {"rate": 0.1, "decay": 0.0}):
        with pytest.raises(ValueError):
            tf.DropSpec(**bad)
    assert tf.fresh_key(-2, 9) == jf.fresh_key(-2, 9) == "fresh-2@drop9"


def test_update_freshness_and_select_delivered_equal_jax():
    rng = np.random.default_rng(0)
    for decay in (0.5, 0.3, 1.0):
        fresh = rng.uniform(0.0, 1.0, 8).astype(np.float32)
        mask = (rng.uniform(size=8) > 0.4).astype(np.float32)
        want = np.asarray(jf.update_freshness(jnp.asarray(fresh), jnp.asarray(mask), decay))
        got = tf.update_freshness(torch.from_numpy(fresh), torch.from_numpy(mask), decay)
        np.testing.assert_array_equal(got.numpy(), want)
    new = {"a": rng.standard_normal((8, 3, 5)).astype(np.float32),
           "b": rng.standard_normal((8,)).astype(np.float32)}
    old = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in new.items()}
    want = jf.select_delivered(jnp.asarray(mask), jax.tree.map(jnp.asarray, new),
                               jax.tree.map(jnp.asarray, old))
    got = tf.select_delivered(torch.from_numpy(mask), jax.tree.map(torch.from_numpy, new),
                              jax.tree.map(torch.from_numpy, old))
    for k in new:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _rounds(plan):
    return getattr(plan, "rounds", (plan,))


@pytest.mark.parametrize("topo", ["ring", "chain", "torus", "torus2d", "star", "full",
                                  "full_logn", "exp", "exp_any"])
def test_gated_weights_and_realized_matrix_equal_jax(topo):
    """Gates ``mask * fresh`` (fractional) on every round of every plan:
    gated weights, the gated mix and the realized matrix equal JAX's, and
    every realized row sums to 1 as the JAX tier pins it."""
    n = 16 if topo in ("torus", "torus2d") else 8
    jplan, tplan = jg.make_gossip_plan(topo, n), tg.make_gossip_plan(topo, n)
    spec = jf.make_drop_spec("0.4:3")
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3, 7)).astype(np.float32)
    for step in range(4):
        for jr, tr in zip(_rounds(jplan), _rounds(tplan)):
            fresh = {s: rng.uniform(0.1, 1.0, n).astype(np.float32) for s in jr.shift_list}
            jg_ = {s: jf.edge_drop_mask(n, s, step, spec) * fresh[s] for s in jr.shift_list}
            tg_ = {s: tf.edge_drop_mask(n, s, step, tf.make_drop_spec("0.4:3"))
                   * torch.from_numpy(fresh[s]) for s in tr.shift_list}
            for s in jr.shift_list:
                np.testing.assert_array_equal(tg_[s].numpy(), np.asarray(jg_[s]))
            jsw, jws = jg.gated_weights(jr, jg_)
            tsw, tws = tg.gated_weights(tr, tg_)
            np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
            for s in jr.shift_list:
                np.testing.assert_array_equal(tws[s].numpy(), np.asarray(jws[s]))
            jW = np.asarray(jg.realized_mixing_matrix(jr, jg_))
            tW = tg.realized_mixing_matrix(tr, tg_).numpy()
            np.testing.assert_array_equal(tW, jW)
            np.testing.assert_allclose(tW.astype(np.float64).sum(axis=1), 1.0, atol=1e-12)
            assert tW.min() >= 0.0
            nb = {s: np.roll(x, s, axis=0) for s in jr.shift_list}
            want = jg.plan_mix_gated(jr, {"x": jnp.asarray(x)},
                                     {s: {"x": jnp.asarray(v)} for s, v in nb.items()}, jg_)
            got = tg.plan_mix_gated(tr, {"x": torch.from_numpy(x)},
                                    {s: {"x": torch.from_numpy(v)} for s, v in nb.items()}, tg_)
            np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))


@pytest.mark.parametrize("algo,topo", [(a, t) for a in GOSSIP for t in TOPOLOGIES])
def test_step_under_drops_matches_jax_runtime(algo, topo, monkeypatch):
    check_step_against_jax(algo, topo, DROP, monkeypatch)
