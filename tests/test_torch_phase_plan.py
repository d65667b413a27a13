"""Phase plans: the port's ``PhasePlan`` and ``rekey_dist_state`` against
the JAX package's, and a two-phase CPU run resumed across its boundary.

``parse``, ``describe``, ``phase_at``, ``segments`` and ``records`` agree
with JAX's on every plan below.  The rekey of every algorithm, onto a new
plan and wire (and under drops), gives the same aux keys and values as
JAX's, bit for bit: rolled params, zero residuals, ones for freshness and
the lowrank wire's initial factors.  A 4-step run whose plan switches at
step 2 equals, bit for bit, the same run resumed from its step-2
checkpoint (taken under the first phase, restored under it, then rekeyed).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import decentralized as jd
from repro.distributed import gossip as jg
from repro.netsim import controller as jc
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs import get_config
from repro_torch.convert import dist_state_from_jax
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import gossip as tg
from repro_torch.launch.train import TrainConfig, run_training
from repro_torch.netsim import controller as tc_
from repro_torch.tree import leaf_items

PLANS = ["0@ring@quant:8", "0@exp@sign;400@full_logn@quant:8",
         " 0@ring@adaptive:4096:small=fp16:large=quant:4 ; 7@chain@fp16;3@torus@sparse:0.25:topk;",
         "5@star@quant:4;0@full@quant:2"]


@pytest.mark.parametrize("text", PLANS)
def test_phase_plan_matches_jax(text):
    j, t = jc.PhasePlan.parse(text), tc_.PhasePlan.parse(text)
    assert t.describe() == j.describe()
    assert t.records() == j.records()
    assert tc_.PhasePlan.parse(t.describe()) == t
    for step in range(0, 12):
        assert t.phase_at(step).describe() == j.phase_at(step).describe()
    for total in (1, 3, 5, 8, 500):
        assert [(a, b, p.describe()) for a, b, p in t.segments(total)] == \
            [(a, b, p.describe()) for a, b, p in j.segments(total)]


def test_phase_plan_refuses_bad_plans():
    for text in ("", "3@ring@quant:8", "0@ring@quant:8;0@chain@fp16", "0@ring"):
        with pytest.raises(ValueError):
            tc_.PhasePlan.parse(text)

# granite's reduced config cut further, so that a run of a few steps takes
# well under a second on the CPU: one layer, width 64, vocabulary 128
TINY = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=1, d_model=64,
                           n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128, vocab=128)


@pytest.fixture
def one_thread():
    """One intra-op thread for the tiny training runs: under the test
    workers that share the cores, a thread pool's barriers cost more than
    its threads win on tensors this small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 8
SHAPES = {"w": (2, 256), "b": (96,)}


@pytest.mark.parametrize("algo", td.ALGOS)
def test_rekey_matches_jax(algo):
    rng = np.random.default_rng(len(algo))
    params = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32)) for k, s in SHAPES.items()}
    jstate = jd.init_dist_state(algo, params, jg.GossipPlan.ring(N), jsgd(), drop="0.2:1")
    # params that differ node by node, so that the rolls are seen
    jstate = jstate._replace(params=jax.tree.map(
        lambda l: l + jnp.asarray(rng.standard_normal(l.shape).astype(np.float32)),
        jstate.params))
    tstate = dist_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    wire = "lowrank:2:warm" if algo in td.WIRE_ALGOS else None
    jnew = jd.rekey_dist_state(jstate, algo, jg.make_gossip_plan("full_logn", N), drop="0.2:4",
                               wire=wire)
    tnew = td.rekey_dist_state(tstate, algo, tg.make_gossip_plan("full_logn", N), drop="0.2:4",
                               wire=wire)
    assert tnew is tstate and sorted(tnew.aux) == sorted(jnew.aux)
    if algo in td.REPLICA_ALGOS:
        assert {f"fresh{s:+d}@drop4" for s in (1, 2, 4)} <= set(tnew.aux)
    for key, jt in jnew.aux.items():
        got = jax.tree.map(lambda t: t.numpy(), tnew.aux[key])
        want = jax.tree.map(np.asarray, jt)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
            np.testing.assert_array_equal(g, w, err_msg=key)
    for k in SHAPES:
        np.testing.assert_array_equal(tnew.params[k].numpy(), np.asarray(jnew.params[k]))
    # every replica or estimate is its own buffer, not a view of the params
    for key, tree in tnew.aux.items():
        if isinstance(tree, dict) and key != "wire_lowrank:2":
            for k in SHAPES:
                assert tree[k].data_ptr() != tnew.params[k].data_ptr()


@pytest.mark.parametrize("algo,drop_rate", [("dcd", 0.2), ("deepsqueeze", 0.0)])
def test_two_phase_run_resumed_across_the_boundary(tmp_path, one_thread, algo, drop_rate):
    cfg = TINY
    plan = "0@ring@quant:8;2@full_logn@quant:4"
    tc = TrainConfig(algo=algo, phase_plan=plan, n_nodes=N, seq_len=8, global_batch=8,
                     steps=4, log_every=1, drop_rate=drop_rate,
                     ckpt_dir=str(tmp_path / "through"), ckpt_every=2)
    through = run_training(cfg, tc, device="cpu")
    assert through["phases"] == jc.PhasePlan.parse(plan).records()
    (tmp_path / "resumed").mkdir()
    for suffix in (".npz", ".npz.json"):
        shutil.copy(tmp_path / "through" / f"ckpt_00000002{suffix}", tmp_path / "resumed")
    resumed = run_training(cfg, dataclasses.replace(tc, ckpt_dir=str(tmp_path / "resumed")),
                           device="cpu")
    assert resumed["losses"] == through["losses"][2:]
    a = dict(tck._items(through["state"]))
    b = dict(tck._items(resumed["state"]))
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(tck._to_numpy(a[k]), tck._to_numpy(b[k])), k
    if algo == "dcd":
        paths = [p for p, _ in leaf_items(through["state"].params)]
        assert sorted(k for k in a if k.startswith(".aux/rep")) == \
            sorted(f".aux/rep{s:+d}/{p}" for s in (1, 2, 4) for p in paths)
