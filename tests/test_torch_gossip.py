"""The port's ring plan, mixing and topology against the JAX package's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.distributed import gossip as jg
from repro_torch.core import topology as ttopo
from repro_torch.distributed import gossip as tg


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_plan_matches_jax(n):
    jp, tp = jg.GossipPlan.ring(n), tg.GossipPlan.ring(n)
    assert tp.shifts == tuple((s, float(w)) for s, w in jp.shifts)
    assert tp.self_weight == jp.self_weight and tp.degree == jp.degree
    assert tp.shift_list == jp.shift_list
    np.testing.assert_array_equal(tp.mixing_matrix(), jp.mixing_matrix())
    if n > 1:
        assert dataclasses.astuple(tp.spectral) == \
            dataclasses.astuple(jtopo.spectral_info(jtopo.ring(n)))
    assert tg.make_gossip_plan("ring", n).shifts == tp.shifts


def test_topology_copy_matches_jax():
    for n in (1, 2, 5, 8):
        np.testing.assert_array_equal(ttopo.ring(n), jtopo.ring(n))
    ttopo.check_mixing_matrix(ttopo.ring(8))
    with pytest.raises(ValueError):
        ttopo.check_mixing_matrix(np.eye(4))          # disconnected
    with pytest.raises(ValueError):
        tg.make_gossip_plan("hypercube", 9)           # no such topology


def test_plan_mix_and_roll_match_jax():
    rng = np.random.default_rng(0)
    n = 8
    plan_j, plan_t = jg.GossipPlan.ring(n), tg.GossipPlan.ring(n)
    x = {"a": rng.standard_normal((n, 5, 7)).astype(np.float32),
         "b": rng.standard_normal((n, 3)).astype(np.float32)}
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    want = jg.plan_mix(plan_j, xj, {s: jg.roll_tree(xj, s) for s in plan_j.shift_list})
    got = tg.plan_mix(plan_t, xt, {s: tg.roll_tree(xt, s) for s in plan_t.shift_list})
    for k in x:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(tg.roll_tree(xt, -1)[k].numpy(),
                                      np.asarray(jg.roll_tree(xj, -1)[k]))
