"""The error-feedback slice as a whole: two train steps of the port against
the JAX runtime.

Reduced granite-3-2b (2 layers, d 256, vocab 512), 4 nodes on a ring, from
the same initial params (JAX ``lm_init``, through ``convert.params_from_jax``)
and the same numpy batches: ``choco`` over ``sign`` and ``deepsqueeze`` over
``sparse:0.25``.  The JAX step is jitted with ``fused=False``, its jnp
reference receive path (the Pallas receive kernels are held to the port in
``test_torch_codecs.py`` and, inside the runtime, in
``test_torch_error_feedback.py``; compiling them into this model's step would
take most of a minute).  Losses agree to bf16 tolerance (2e-3).  The
parameters cannot agree to the last bit: the two frameworks round their bf16
gradients differently (~1%).  Over ``sign`` that flips the sign of
near-zero differences, each flip moving its element by twice the block's
scale, so the parameter CHANGE over the two steps is held to 15% relative L2
error (measured 6.3%); over ``sparse:0.25`` (randk, whose selection does not
depend on the values) to 1% (measured 0.08%).
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


@pytest.mark.parametrize("algo,spec,rel_l2", [("choco", "sign", 0.15),
                                              ("deepsqueeze", "sparse:0.25", 0.01)])
def test_two_train_steps_match_jax(algo, spec, rel_l2):
    jcfg = jget_config("granite-3-2b").reduced()
    tcfg = tget_config("granite-3-2b").reduced()
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    params = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, (N, B, S)).astype(np.int32),
                "labels": rng.integers(0, jcfg.vocab, (N, B, S)).astype(np.int32)}
               for _ in range(STEPS)]

    jopt = jsgd()
    jstate = jd.init_dist_state(algo, params, N, jopt)
    jstep = jax.jit(jd.make_dist_train_step(lambda p, b: jmodel.loss(p, b), algo, jopt, spec, N,
                                            jsched(LR, 0, 10), gamma=GAMMA, fused=False))
    topt = tsgd()
    tstate = td.init_dist_state(algo, params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
                                N, topt)
    tstep = td.make_dist_train_step(tmodel.loss, algo, topt, spec, N, tsched(LR, 0, 10),
                                    gamma=GAMMA)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-3
        assert np.isfinite(float(tm["consensus"]))

    x0 = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    dj = np.concatenate([(np.asarray(j) - a[None]).ravel() for j, a in
                         zip(jax.tree_util.tree_leaves(jstate.params), x0)])
    dt = np.concatenate([(t.numpy() - a[None]).ravel() for t, a in
                         zip(tree_leaves(tstate.params), x0)])
    rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
    print(f"{algo}+{spec}: relative L2 error of the parameter change {rel:.3e}")   # pytest -s
    assert rel <= rel_l2
