"""The low-rank slice as a whole: two train steps of the port against the
JAX runtime.

Reduced granite-3-2b (2 layers, d 256, vocab 512), 4 nodes on a ring, from
the same initial params (JAX ``lm_init``, through ``convert.params_from_jax``)
and the same numpy batches: DCD over ``lowrank:2`` and ``lowrank:2:warm``
(the warm factors start from the JAX state's, checked bit-equal to the
port's own ``init_aux``, and are compared after the steps too) and CHOCO
(gamma 0.5) over ``adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4``.
The JAX step is jitted with ``fused=False`` (its jnp receive path; the
Pallas kernels are held to the port's plain versions in
``test_torch_lowrank.py``).  Losses agree to bf16 tolerance (2e-3).  The
two frameworks round their bf16 gradients differently (~1%), and the
factors follow the gradients they project, so parameters agree to atol
``PARAM_ATOL`` 2e-3 (measured 2.2e-4 for ``lowrank:2``, 1.2e-4 warm and
9.3e-4 under ``adaptive``, whose ``quant:4`` embed flips a code now and
then; the parameter change over two steps is up to 1.4e-2) and the warm
factors to atol ``FACTOR_ATOL`` 5e-3 (measured 3.6e-4).  The port's shared-state
invariants hold exactly: ``rep{s} == roll(X, s)`` (DCD) and ``hat{s} ==
roll(hat_self, s)`` (CHOCO).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import decentralized as jd
from repro.models.api import build_model as jbuild
from repro.optim import sgd as jsgd
from repro.optim.schedules import linear_warmup_cosine as jsched
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import decentralized as td
from repro_torch.models.api import build_model as tbuild
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.schedules import linear_warmup_cosine as tsched
from repro_torch.tree import tree_leaves
from test_torch_families import one_torch_thread  # noqa: F401

N, B, S, LR, STEPS, GAMMA = 4, 2, 16, 0.05, 2, 0.5
PARAM_ATOL = 2e-3
FACTOR_ATOL = 5e-3
ADAPTIVE = "adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4"
SHARED = {"dcd": (None, "rep"), "choco": ("hat_self", "hat")}


@pytest.mark.parametrize("algo,spec", [("dcd", "lowrank:2"), ("dcd", "lowrank:2:warm"),
                                       ("choco", ADAPTIVE)])
def test_two_train_steps_match_jax(algo, spec):
    jcfg = jget_config("granite-3-2b").reduced()
    tcfg = tget_config("granite-3-2b").reduced()
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    params = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, (N, B, S)).astype(np.int32),
                "labels": rng.integers(0, jcfg.vocab, (N, B, S)).astype(np.int32)}
               for _ in range(STEPS)]

    jopt = jsgd()
    jstate = jd.init_dist_state(algo, params, N, jopt, wire=spec)
    jstep = jax.jit(jd.make_dist_train_step(lambda p, b: jmodel.loss(p, b), algo, jopt, spec, N,
                                            jsched(LR, 0, 10), gamma=GAMMA, fused=False))
    topt = tsgd()
    tstate = td.init_dist_state(algo, params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
                                N, topt, wire=spec)
    key = "wire_lowrank:2"
    warm = spec.endswith(":warm")
    assert (key in tstate.aux) == (key in jstate.aux) == warm
    if warm:      # carried across: the port starts from the JAX factors, equal to its own
        jaux = {k: torch.from_numpy(np.array(v)) for k, v in jstate.aux[key].items()}
        assert sorted(jaux) == sorted(tstate.aux[key]) and len(jaux) == 11
        assert all(torch.equal(jaux[k], tstate.aux[key][k]) for k in jaux)
        tstate.aux[key] = jaux
    tstep = td.make_dist_train_step(tmodel.loss, algo, topt, spec, N, tsched(LR, 0, 10),
                                    gamma=GAMMA)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-3
        assert np.isfinite(float(tm["consensus"]))

    gap = max(np.abs(t.numpy() - np.asarray(j)).max() for t, j in
              zip(tree_leaves(tstate.params), jax.tree_util.tree_leaves(jstate.params)))
    x0 = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    moved = max(np.abs(np.asarray(j) - a[None]).max() for j, a in
                zip(jax.tree_util.tree_leaves(jstate.params), x0))
    print(f"{algo}+{spec}: max |param gap| {gap:.3e}, max |param change| {moved:.3e}")
    assert gap <= PARAM_ATOL
    if warm:
        fgap = max(np.abs(tstate.aux[key][k].numpy() - np.asarray(jstate.aux[key][k])).max()
                   for k in tstate.aux[key])
        print(f"{algo}+{spec}: max |warm factor gap| {fgap:.3e}")
        assert fgap <= FACTOR_ATOL
    base_key, prefix = SHARED[algo]
    base = tstate.params if base_key is None else tstate.aux[base_key]
    for s in (-1, 1):
        for b, o in zip(tree_leaves(base), tree_leaves(tstate.aux[f"{prefix}{s:+d}"])):
            assert torch.equal(torch.roll(b, s, dims=0), o)
