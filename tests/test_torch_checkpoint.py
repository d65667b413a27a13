"""Checkpoints: the port and the JAX package read each other's files.

A ``DistState`` with freshness vectors (drops), the ``wire_lowrank:2`` codec
state and a bfloat16 leaf goes JAX save -> port restore and port save -> JAX
restore, every leaf bit-equal.  The port keeps the last 3 checkpoints and
leaves no temporary file; a template at another lowrank rank or under
another drop salt raises ``KeyError``.  A CPU run of 4 steps equals, bit for
bit, a run of 2 steps resumed for 2 more from its checkpoint.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.distributed import decentralized as jd
from repro.distributed import gossip as jg
from repro.optim import make_optimizer as jmake
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs import get_config
from repro_torch.distributed import decentralized as td
from repro_torch.launch.train import TrainConfig, run_training
from repro_torch.optim import make_optimizer as tmake
from repro_torch.tree import tree_leaves

N = 4
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


def _jax_state(rng, salt=0, rank=2):
    p = {"blk": {"w": jnp.asarray(rng.standard_normal((6, 256)).astype(np.float32))},
         "ln": jnp.asarray(rng.standard_normal((256,)).astype(np.float32)).astype(jnp.bfloat16)}
    st = jd.init_dist_state("dcd", p, jg.GossipPlan.ring(N), jmake("adamw"),
                            drop=f"0.2:{salt}", wire=f"lowrank:{rank}:warm")
    # make every leaf distinct from its neighbours' and from zero
    leaves, tdef = jax.tree.flatten(st)
    leaves = [l if l.ndim == 0 else
              (l + jnp.asarray(rng.standard_normal(l.shape), l.dtype)).astype(l.dtype)
              for l in leaves]
    st = jax.tree.unflatten(tdef, leaves)
    return st._replace(step=jnp.int32(7), opt=st.opt._replace(step=jnp.int32(7)))


def _torch_template(salt=0, rank=2):
    p = {"blk": {"w": torch.zeros((6, 256))}, "ln": torch.zeros((256,), dtype=torch.bfloat16)}
    return td.init_dist_state("dcd", p, N, tmake("adamw"), drop=f"0.2:{salt}",
                              wire=f"lowrank:{rank}:warm")


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat_jax(st):
    return {k: _np(v) for k, v in jck._flatten(st)[0].items()}


def _flat_torch(st):
    """What the port writes for each leaf: bfloat16 as its uint16 bits, a
    Python int as int32."""
    return {k: tck._to_numpy(v) for k, v in tck._items(st)}


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    rng = np.random.default_rng(0)
    jst = _jax_state(rng)
    jck.save(str(tmp_path), 7, jst, metadata={"loss": 1.5})
    tst, manifest = tck.restore(str(tmp_path), _torch_template())
    assert manifest["metadata"] == {"loss": 1.5} and manifest["step"] == 7
    assert tst.step == 7 and tst.opt.step == 7
    assert tst.params["ln"].dtype == torch.bfloat16
    want, got = _flat_jax(jst), _flat_torch(tst)
    assert sorted(got) == sorted(want)
    assert ".aux/wire_lowrank:2/0" in got and ".aux/fresh+1@drop0" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k

    # the port writes, JAX reads: the same manifest keys and dtype names
    tck.save(str(tmp_path), 8, tst, metadata={"loss": 2.5})
    back, man = jck.restore(str(tmp_path), jst, 8)
    assert man["dtypes"] == manifest["dtypes"] and man["keys"] == manifest["keys"]
    for k, v in _flat_jax(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert jck.latest_step(str(tmp_path)) == tck.latest_step(str(tmp_path)) == 8


def test_restore_puts_leaves_on_the_template_and_checks_shapes(tmp_path):
    tst = _torch_template()
    tck.save(str(tmp_path), 1, tst)
    like = dataclasses.replace(tst, params={"blk": {"w": torch.zeros((N, 6, 256),
                                                                      dtype=torch.float64)},
                                            "ln": tst.params["ln"]})
    out, _ = tck.restore(str(tmp_path), like)
    assert out.params["blk"]["w"].dtype == torch.float64
    bad = dataclasses.replace(tst, params={"blk": {"w": torch.zeros((N, 6, 128))},
                                           "ln": tst.params["ln"]})
    with pytest.raises(ValueError):
        tck.restore(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "empty"), tst)


def test_gc_keeps_three_and_leaves_no_temporary(tmp_path):
    tst = _torch_template()
    for step in range(1, 7):
        tck.save(str(tmp_path), step * 10, tst)
    names = sorted(os.listdir(tmp_path))
    assert names == [f"ckpt_{s:08d}{x}" for s in (40, 50, 60) for x in (".npz", ".npz.json")]
    assert tck.latest_step(str(tmp_path)) == 60 and tck.latest_step(str(tmp_path / "no")) is None
    tck.save(str(tmp_path), 70, tst, keep=1)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000070.npz", "ckpt_00000070.npz.json"]


def test_config_keyed_state_refuses_another_rank_or_drop_salt(tmp_path):
    rng = np.random.default_rng(1)
    jck.save(str(tmp_path), 3, _jax_state(rng, salt=5, rank=2))
    tck.restore(str(tmp_path), _torch_template(salt=5, rank=2))
    with pytest.raises(KeyError, match="wire_lowrank:4"):
        tck.restore(str(tmp_path), _torch_template(salt=5, rank=4))
    with pytest.raises(KeyError, match="drop6"):
        tck.restore(str(tmp_path), _torch_template(salt=6, rank=2))


@pytest.mark.parametrize("algo,wire,drop_rate", [("dcd", "quant:4", 0.3),
                                                 ("choco", "lowrank:2:warm", 0.0)])
def test_resumed_run_equals_run_through(tmp_path, one_thread, algo, wire, drop_rate):
    cfg = TINY
    tc = TrainConfig(algo=algo, wire=wire, n_nodes=N, seq_len=8, global_batch=8, steps=4,
                     log_every=1, drop_rate=drop_rate, drop_salt=3,
                     ckpt_dir=str(tmp_path / "through"), ckpt_every=2)
    through = run_training(cfg, tc, device="cpu")
    assert tck.latest_step(tc.ckpt_dir) == 4
    (tmp_path / "resumed").mkdir()
    for suffix in (".npz", ".npz.json"):
        shutil.copy(tmp_path / "through" / f"ckpt_00000002{suffix}", tmp_path / "resumed")
    resumed = run_training(cfg, dataclasses.replace(tc, ckpt_dir=str(tmp_path / "resumed")),
                           device="cpu")
    assert resumed["losses"] == through["losses"][2:]
    a, b = _flat_torch(through["state"]), _flat_torch(resumed["state"])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(tree_leaves(through["state"].params)) == 12
