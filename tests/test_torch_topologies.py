"""Every gossip topology of the port against the JAX package's.

Each name of JAX's ``GOSSIP_TOPOLOGIES`` at n 1, 2, 3, 4, 5, 6, 8, 9 and 16
(where JAX accepts the n): plan or schedule, shifts, scalar or per-node
weights, rounds, ``time_varying``, ``degree``, ``replica_payloads``, the
shift union, the mixing matrices and the spectral constants, all equal to
JAX's exactly.  ``exp`` refuses n 6 in both.  The matrix builders the plans
rest on (``core/topology.py``: the 2-D torus and Metropolis weights) are
equal too, and so are ``from_mixing_matrix``'s factorizations.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import topology as jtopo
from repro.distributed import gossip as jg
from repro_torch.core import topology as ttopo
from repro_torch.distributed import gossip as tg

SIZES = [1, 2, 3, 4, 5, 6, 8, 9, 16]


def _same_weight(a, b):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
    else:
        assert not isinstance(a, np.ndarray) and a == b and type(a) is type(b)


def _same_plan(tp, jp):
    assert type(tp).__name__ == type(jp).__name__ == "GossipPlan"
    assert (tp.n, tp.name, tp.degree, tp.replica_payloads, tp.shift_list, tp.uniform) == \
        (jp.n, jp.name, jp.degree, jp.replica_payloads, jp.shift_list, jp.uniform)
    _same_weight(tp.self_weight, jp.self_weight)
    for (ts, tw), (js, jw) in zip(tp.shifts, jp.shifts, strict=True):
        assert ts == js
        _same_weight(tw, jw)
    np.testing.assert_array_equal(tp.mixing_matrix(), jp.mixing_matrix())
    if jp.spectral is None:
        assert tp.spectral is None
    else:
        assert dataclasses.astuple(tp.spectral) == dataclasses.astuple(jp.spectral)


def _same(t, j):
    if isinstance(j, jg.GossipSchedule):
        assert isinstance(t, tg.GossipSchedule)
        assert (t.n, t.name, t.period, t.time_varying, t.degree, t.replica_payloads,
                t.shift_union, t.round_degrees, t.uniform) == \
            (j.n, j.name, j.period, j.time_varying, j.degree, j.replica_payloads,
             j.shift_union, j.round_degrees, j.uniform)
        for tr, jr in zip(t.rounds, j.rounds, strict=True):
            _same_plan(tr, jr)
        np.testing.assert_array_equal(t.effective_mixing_matrix(), j.effective_mixing_matrix())
        np.testing.assert_array_equal(t.mixing_matrix(), j.mixing_matrix())
        js, ts = j.spectral, t.spectral
        assert (ts is None) == (js is None)
        if js is not None:
            assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    else:
        _same_plan(t, j)


@pytest.mark.parametrize("name", jg.GOSSIP_TOPOLOGIES)
def test_every_topology_matches_jax(name):
    assert tg.GOSSIP_TOPOLOGIES == jg.GOSSIP_TOPOLOGIES
    for n in SIZES:
        try:
            j = jg.make_gossip_plan(name, n)
        except ValueError:
            with pytest.raises(ValueError):
                tg.make_gossip_plan(name, n)
            continue
        t = tg.make_gossip_plan(name, n)
        _same(t, j)
        _same(tg.as_schedule(t), jg.as_schedule(j))
        assert tg.make_gossip_plan(t, n) is t


def test_exp_refuses_n_that_is_not_a_power_of_two():
    for n in (1, 3, 6, 12):
        with pytest.raises(ValueError):
            jg.make_gossip_plan("exp", n)
        with pytest.raises(ValueError, match="power-of-two"):
            tg.make_gossip_plan("exp", n)
    with pytest.raises(ValueError):
        tg.make_gossip_plan("no-such-graph", 8)
    with pytest.raises(ValueError):
        tg.make_gossip_plan(tg.GossipPlan.ring(4), 8)


@pytest.mark.parametrize("n", SIZES)
def test_matrix_builders_match_jax(n):
    np.testing.assert_array_equal(ttopo.make_topology("torus", n), jtopo.make_topology("torus", n))
    for r, c in ((1, n), (n, 1), (2, max(n // 2, 1)), (3, 3), (4, 4)):
        np.testing.assert_array_equal(ttopo.torus2d(r, c), jtopo.torus2d(r, c))
    rng = np.random.default_rng(n)
    adj = rng.uniform(size=(n, n)) < 0.4
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    np.testing.assert_array_equal(ttopo.metropolis(adj), jtopo.metropolis(adj))
    for name in ("ring", "chain", "full", "star"):
        np.testing.assert_array_equal(ttopo.make_topology(name, n), jtopo.make_topology(name, n))


@pytest.mark.parametrize("n", [4, 6, 8, 9, 16])
def test_from_mixing_matrix_matches_jax(n):
    """The flat decomposition (refusing dense W at the default budget), its
    widened budget, and the schedule factorization of full and star."""
    for name in ("full", "star"):
        W = jtopo.make_topology(name, n)
        if n > 9:
            with pytest.raises(ValueError):
                jg.GossipPlan.from_mixing_matrix(W)
            with pytest.raises(ValueError):
                tg.GossipPlan.from_mixing_matrix(W)
        _same(tg.GossipPlan.from_mixing_matrix(W, max_shifts=n),
              jg.GossipPlan.from_mixing_matrix(W, max_shifts=n))
        _same(tg.GossipPlan.from_mixing_matrix(W, schedule=True, max_shifts=2),
              jg.GossipPlan.from_mixing_matrix(W, schedule=True, max_shifts=2))
    chain = jtopo.chain(n)
    _same(tg.GossipSchedule.from_mixing_matrix(chain), jg.GossipSchedule.from_mixing_matrix(chain))
    _same(tg.make_gossip_plan(chain), jg.make_gossip_plan(chain))
    bad = np.full((n, n), 1.0 / n)
    bad[0, 0], bad[0, 1], bad[1, 0], bad[1, 1] = 0.5 / n, 1.5 / n, 1.5 / n, 0.5 / n
    with pytest.raises(ValueError):
        jg.GossipSchedule.from_mixing_matrix(bad, max_shifts=2)
    with pytest.raises(ValueError):
        tg.GossipSchedule.from_mixing_matrix(bad, max_shifts=2)
    assert tg._mixed_radix(n) == jg._mixed_radix(n)
    assert [tg._canon_shift(s, n) for s in range(-2 * n, 2 * n)] == \
        [jg._canon_shift(s, n) for s in range(-2 * n, 2 * n)]


def test_mix_leaf_broadcasts_per_node_weights_like_jax():
    """``mix_leaf`` with (n,) weight vectors (chain, star) against JAX's
    ``plan_mix`` on leaves of several ranks."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(1)
    for name, n in (("chain", 8), ("star", 8), ("torus2d", 9)):
        jp, tp = jg.make_gossip_plan(name, n), tg.make_gossip_plan(name, n)
        assert not tp.uniform
        for shape in ((n,), (n, 5), (n, 3, 4)):
            x = rng.standard_normal(shape).astype(np.float32)
            nb = {s: np.roll(x, s, axis=0) for s in jp.shift_list}
            want = jg.plan_mix(jp, {"x": jnp.asarray(x)},
                               {s: {"x": jnp.asarray(v)} for s, v in nb.items()})
            got = tg.plan_mix(tp, {"x": torch.from_numpy(x)},
                              {s: {"x": torch.from_numpy(v)} for s, v in nb.items()})
            np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
