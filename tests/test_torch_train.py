"""The slice as a whole: two train steps of the port against the JAX runtime.

Reduced granite-3-2b (2 layers, d 256, vocab 512), 4 nodes on a ring,
``quant:4``: the same initial params (JAX ``lm_init``) and the same batches
(numpy) go through JAX's jitted ``make_dist_train_step`` and the port's.
Losses agree to bf16 tolerance (2e-3).  The params cannot agree to the
last bit: the two frameworks round their bf16 gradients differently (~1%),
and 4-bit stochastic rounding turns a small difference in a payload value
into a one-level code flip with probability ~|difference| / level.  So the
parameter CHANGE over the two steps is held to 20% relative L2 error
(measured 8% DCD, 1% ECD) and at most 1% of the elements may differ by more
than 1e-4 (measured 0.6% and 0.03%).  Plain SGD keeps the update linear in
the gradient; AdamW, which would turn each near-zero bf16 gradient into a
+-lr step, is held to JAX's on identical inputs in ``test_adamw_matches_jax``.
The training entry point (``run_training``) and the data pipeline are checked
here too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import decentralized as jd
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro.optim.schedules import linear_warmup_cosine as jsched
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, sample_batch, stacked_node_batches
from repro_torch.distributed import decentralized as td
from repro_torch.launch.train import TrainConfig, run_training
from repro_torch.models.api import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.schedules import linear_warmup_cosine as tsched
from repro_torch.tree import tree_leaves
from test_torch_families import one_torch_thread  # noqa: F401

N, B, S, LR, STEPS = 4, 2, 16, 0.05, 2


@pytest.mark.parametrize("algo", ["dcd", "ecd"])
def test_two_train_steps_match_jax(algo):
    jcfg = jget_config("granite-3-2b").reduced()
    tcfg = tget_config("granite-3-2b").reduced()
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    params = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, (N, B, S)).astype(np.int32),
                "labels": rng.integers(0, jcfg.vocab, (N, B, S)).astype(np.int32)}
               for _ in range(STEPS)]

    jopt = jsgd()
    jstate = jd.init_dist_state(algo, params, N, jopt)
    jstep = jax.jit(jd.make_dist_train_step(lambda p, b: jmodel.loss(p, b), algo, jopt,
                                            "quant:4", N, jsched(LR, 0, 10)))
    topt = tsgd()
    tstate = td.init_dist_state(algo, params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
                                N, topt)
    tstep = td.make_dist_train_step(tmodel.loss, algo, topt, "quant:4", N, tsched(LR, 0, 10))
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-3
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])  # f32 cos: 1 ulp

    x0 = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    dj = np.concatenate([(np.asarray(j) - a[None]).ravel() for j, a in
                         zip(jax.tree_util.tree_leaves(jstate.params), x0)])
    dt = np.concatenate([(t.numpy() - a[None]).ravel() for t, a in
                         zip(tree_leaves(tstate.params), x0)])
    assert np.linalg.norm(dt - dj) <= 0.2 * np.linalg.norm(dj)
    assert (np.abs(dt - dj) > 1e-4).mean() <= 1e-2


def test_adamw_and_schedule_match_jax():
    """The slice's optimizer and schedule on identical inputs, two steps."""
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((4, 33)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
             for _ in range(2)]
    jopt, topt = jadamw(weight_decay=0.01), tadamw(weight_decay=0.01)
    js, ts = jopt.init(p), topt.init({k: torch.from_numpy(v) for k, v in p.items()})
    jlr, tlr = jsched(3e-3, 1, 10), tsched(3e-3, 1, 10)
    for t, g in enumerate(grads):
        lr = tlr(t)
        assert abs(lr - float(jlr(jnp.int32(t)))) <= 1e-6 * max(lr, 1e-12)
        ju, js = jopt.update(g, js, p, jnp.float32(lr))
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                             {k: torch.from_numpy(v) for k, v in p.items()}, lr)
        for k in p:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]), rtol=1e-6)
            np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]), rtol=1e-6)
    assert ts.step == 2


def test_run_training_on_cpu_keeps_invariants():
    cfg = tget_config("granite-3-2b").reduced()
    tc = TrainConfig(algo="dcd", wire="quant:4", n_nodes=4, seq_len=16, global_batch=8,
                     steps=2, log_every=1)
    hist = run_training(cfg, tc, device="cpu")
    assert len(hist["losses"]) == 2 and all(np.isfinite(hist["losses"]))
    assert hist["loss"] == hist["losses"] and len(hist["step_s"]) == 2
    state = hist["state"]
    for s in (-1, 1):
        for x, r in zip(tree_leaves(state.params), tree_leaves(state.aux[f"rep{s:+d}"])):
            assert torch.equal(torch.roll(x, s, dims=0), r)
    # edge drops run: the step keeps a freshness vector per shift
    dropped = run_training(cfg, dataclasses.replace(tc, drop_rate=0.1, steps=1), device="cpu")
    assert np.isfinite(dropped["losses"][0])
    assert sorted(k for k in dropped["state"].aux if k.startswith("fresh")) == \
        ["fresh+1@drop0", "fresh-1@drop0"]


def test_data_pipeline_is_deterministic_and_sharded():
    dc = DataConfig(vocab=512, seq_len=24, global_batch=8, n_shards=4, seed=1)
    a = stacked_node_batches(dc, 5, device="cpu")
    b = stacked_node_batches(dc, 5, device="cpu")
    assert a["tokens"].shape == (4, 2, 24) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, :, 1:], a["labels"][:, :, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512
    assert torch.equal(sample_batch(dc, 5, 2, device="cpu")["tokens"], a["tokens"][2])
    assert not torch.equal(a["tokens"][0], a["tokens"][1])          # shards differ
    assert not torch.equal(stacked_node_batches(dc, 6, device="cpu")["tokens"], a["tokens"])


def test_data_pipeline_has_markov_structure():
    """Next tokens follow the fixed transition logits: the empirical
    conditional entropy sits well below the uniform log(vocab)."""
    dc = DataConfig(vocab=32, seq_len=200, global_batch=16, n_shards=1, seed=0)
    toks = stacked_node_batches(dc, 0, device="cpu")["tokens"][0]
    pairs = torch.stack([toks[:, :-1].flatten(), toks[:, 1:].flatten()], 1).numpy()
    counts = np.zeros((32, 32))
    np.add.at(counts, (pairs[:, 0], pairs[:, 1]), 1)
    p = counts / np.maximum(counts.sum(1, keepdims=True), 1)
    h = -(counts * np.log(np.where(p > 0, p, 1))).sum() / counts.sum()
    assert h < 0.8 * np.log(32)
