"""The port's runtime (``make_dist_train_step``) against the port's
``GossipReference`` on the CPU, over the grid of
``test_torch_gossip_reference*.py``: DCD, ECD and D-PSGD at drop {0, 0.2,
0.5}; DCD and ECD on ``full_logn``, ``exp`` and ``exp_any`` at drop 0.3:5;
CHOCO and DeepSqueeze over sign, quant:4 and top-5% on ring and full_logn at
drop {0, 0.2}; naive under drops; DCD over lowrank, cold and warm; DCD and
ECD over the adaptive wire.

The per-node loss ``0.5 ||p - c_i||^2 + <p, e_t>`` gives the runtime the
gradient ``p - c_i + e_t`` through autograd; the reference gets the same
expression from its own params.  With SGD the two take the same update.
The runtime decodes through the fused receives (``decode_axpy_``) and
advances the replicas in place; the reference decodes densely, then rolls.
Params, replicas, estimates and residuals agree to atol 1e-5 after every
step, freshness vectors exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import GossipReference
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import gossip as tg
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from test_torch_families import one_torch_thread  # noqa: F401

N, LR, ATOL = 8, 0.05, 1e-5
SHAPES = {"b": (256,), "w": (4, 256)}
AD_SPEC = "adaptive:128:small=fp16:large=quant:4:32"

CASES = (
    [(a, w, "ring", r, 0.5) for a, w in (("dcd", "quant:4:128"), ("dcd", "sparse:0.25:randk:128"),
                                         ("ecd", "quant:4:128"), ("ecd", "sparse:0.25:randk:128"),
                                         ("dpsgd", None))
     for r in (None, "0.2:4", "0.5:4")]
    + [(a, "quant:4:128", t, "0.3:5", 0.5) for a in ("dcd", "ecd")
       for t in ("full_logn", "exp", "exp_any")]
    + [(a, w, t, r, 0.7) for a in ("choco", "deepsqueeze")
       for w in ("sign", "quant:4", "sparse:0.05:topk") for t in ("ring", "full_logn")
       for r in (None, "0.2:4")]
    + [("naive", "quant:4", "ring", "0.2:4", 0.5)]
    + [("dcd", w, "ring", None, 0.5) for w in ("lowrank:2", "lowrank:2:warm")]
    + [(a, AD_SPEC, "ring", None, 0.5) for a in ("dcd", "ecd")]
)


def _loss(p, batch):
    total = sum(0.5 * torch.sum((p[k] - batch[f"c{k}"]) ** 2) + torch.sum(p[k] * batch[f"e{k}"])
                for k in p)
    return total, {}


@pytest.mark.parametrize("algo,wire,topo,drop,gamma", CASES,
                         ids=[f"{a}-{w}-{t}-{r}" for a, w, t, r, _ in CASES])
def test_runtime_matches_reference(algo, wire, topo, drop, gamma):
    shapes = dict(SHAPES, s=(32,)) if wire == AD_SPEC else SHAPES
    rng = np.random.default_rng(sum(map(ord, f"{algo}{wire}{topo}{drop}")))
    p0 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    c = {k: torch.from_numpy(rng.standard_normal((N,) + s).astype(np.float32))
         for k, s in shapes.items()}
    plan = tg.make_gossip_plan(topo, N)
    ref = GossipReference(name=algo, plan=plan, wire=wire, drop=drop, gamma=gamma)
    rs, rstep = ref.init(p0), ref.step_fn()
    ds = td.init_dist_state(algo, p0, plan, sgd(), drop=drop, wire=wire)
    dstep = td.make_dist_train_step(_loss, algo, sgd(), wire, plan, constant(LR), gamma=gamma,
                                    drop=drop)
    assert sorted(ds.aux) == sorted(rs.aux)
    sched = ref.plan
    for t in range(2 * sched.period if sched.time_varying else 3):
        e = {k: torch.from_numpy((0.1 * rng.standard_normal((N,) + s)).astype(np.float32))
             for k, s in shapes.items()}
        rs = rstep(rs, {k: rs.params[k] - c[k] + e[k] for k in shapes}, None, LR)
        ds, _ = dstep(ds, {**{f"c{k}": c[k] for k in shapes}, **{f"e{k}": e[k] for k in shapes}})
        for k in shapes:
            np.testing.assert_allclose(ds.params[k].numpy(), rs.params[k].numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"step {t} {k}")
    assert ds.step == rs.step
    for a, rt in rs.aux.items():
        if a.startswith("fresh"):
            assert torch.equal(ds.aux[a], rt), a
        elif a.startswith("wire_"):
            for k in rt:
                np.testing.assert_allclose(ds.aux[a][k].numpy(), rt[k].numpy(), rtol=0,
                                           atol=ATOL, err_msg=f"{a}/{k}")
        else:
            for k in shapes:
                np.testing.assert_allclose(ds.aux[a][k].numpy(), rt[k].numpy(), rtol=0,
                                           atol=ATOL, err_msg=f"{a}/{k}")
