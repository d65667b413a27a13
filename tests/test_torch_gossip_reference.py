"""The port's ``GossipReference`` against the JAX package's, on the CPU.

The same initial params and the same per-node gradients (numpy: each node
pulled toward its own target, ``g = p - c_i + e_t``, computed on each side
from its own params) go through both references for three steps (two
periods on a time-varying schedule).  Every payload each side decodes is
recorded, round by round and leaf by leaf: integer words bit-equal, float
scales and factors to 1e-5.  Params, replicas, estimates and residuals agree
to atol 1e-5, freshness vectors exactly.

The JAX reference runs eagerly: jit contracts its float32 mixing into FMAs
on the CPU, which moves last bits and, through them, later stochastic codes.
Its time-varying ``lax.switch`` is replaced by picking the branch in Python,
which is what the switch computes.

The grid mirrors the JAX package's acceptance tests of its runtime against
its reference (``test_failures.py``, ``test_error_feedback.py``,
``test_adaptive.py``, ``test_lowrank.py``).  Here: DCD, ECD and D-PSGD under
drops, naive; the schedules, lowrank and adaptive wires are in
``test_torch_gossip_reference_plans.py``, CHOCO and DeepSqueeze in
``test_torch_gossip_reference_ef.py``, the port's runtime against the port's
reference in ``test_torch_gossip_reference_runtime.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import GossipReference as JRef
from repro.distributed import gossip as jg
from repro.distributed import wire as jw
from repro_torch.core import GossipReference as TRef
from repro_torch.core import make_algorithm
from repro_torch.core.testbed import make_problem, run
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import gossip as tg
from repro_torch.distributed import wire as tw
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.schedules import constant as tconstant
from test_torch_families import one_torch_thread  # noqa: F401

N, LR, ATOL = 8, 0.05, 1e-5
# a 128-lane vector and a matrix leaf (lowrank's); the adaptive cases add a
# small vector, off every kernel gate
SHAPES = {"b": (256,), "w": (4, 256)}
LEAF_CLASSES = ("QuantWire", "SparseWire", "SignWire", "Fp16Wire", "IdentityWire",
                "LowRankWire")

# {dcd, ecd} x {quant:4, sparse:0.25} + dpsgd, drop {0, 0.2, 0.5} (salt 4)
DROP_CASES = [(a, w) for a in ("dcd", "ecd") for w in ("quant:4:128", "sparse:0.25:randk:128")] \
    + [("dpsgd", None)]


def _eager_switch(index, branches, *operands):
    return branches[int(index)](*operands)


def _record(monkeypatch, module, log):
    """Append every payload a concrete wire class of ``module`` decodes to
    ``log`` as numpy arrays (int32 words viewed as uint32)."""
    for name in LEAF_CLASSES:
        cls = getattr(module, name)
        orig = cls.decode

        def decode(self, payload, like, orig=orig):
            log.append({k: _np(v) for k, v in payload.items()})
            return orig(self, payload, like)
        monkeypatch.setattr(cls, "decode", decode)


def _np(v):
    a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _targets(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    c = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in shapes.items()}
    return rng, p0, c


def _grads(params, c, e):
    """``p - c + e`` per leaf, in numpy, from one side's stacked params."""
    return {k: (np.asarray(params[k]) - c[k] + e[k]).astype(np.float32) for k in c}


def check_reference_against_jax(monkeypatch, algo, wire, topo, drop, gamma=0.5,
                                shapes=SHAPES):
    """Both references from the same params; words bit-equal, floats to ATOL."""
    monkeypatch.setattr(jax.lax, "switch", _eager_switch)
    jlog, tlog = [], []
    _record(monkeypatch, jw, jlog)
    _record(monkeypatch, tw, tlog)
    rng, p0, c = _targets(sum(map(ord, f"{algo}{wire}{topo}{drop}")), shapes)
    jref = JRef(name=algo, plan=jg.make_gossip_plan(topo, N), wire=wire, drop=drop,
                gamma=gamma)
    tref = TRef(name=algo, plan=tg.make_gossip_plan(topo, N), wire=wire, drop=drop,
                gamma=gamma)
    assert tref.n_nodes == jref.n_nodes == N
    js = jref.init({k: jnp.asarray(v) for k, v in p0.items()})
    ts = tref.init({k: torch.from_numpy(v) for k, v in p0.items()})
    assert sorted(ts.aux) == sorted(js.aux) and ts.step == int(js.step) == 0
    jstep, tstep = jref.step_fn(), tref.step_fn()
    sched = tref.plan
    rounds = 1 if sched.time_varying and sched.period > 1 else sched.period
    L = len(shapes)
    for t in range(2 * sched.period if sched.time_varying else 3):
        e = {k: (0.1 * rng.standard_normal((N,) + s)).astype(np.float32)
             for k, s in shapes.items()}
        del jlog[:], tlog[:]
        js = jstep(js, {k: jnp.asarray(v) for k, v in _grads(js.params, c, e).items()},
                   jnp.asarray(t), jnp.float32(LR))
        ts = tstep(ts, {k: torch.from_numpy(v) for k, v in _grads(
            {k: v.numpy() for k, v in ts.params.items()}, c, e).items()}, None, LR)
        if wire is not None:
            # JAX decodes round by round (a tree each), the port leaf by leaf
            assert len(jlog) == len(tlog) == rounds * L
            for r in range(rounds):
                for li in range(L):
                    jp, tp = jlog[r * L + li], tlog[li * rounds + r]
                    assert sorted(jp) == sorted(tp)
                    for k in jp:
                        if jp[k].dtype == np.uint32:
                            np.testing.assert_array_equal(tp[k], jp[k],
                                                          err_msg=f"t{t} r{r} leaf{li} {k}")
                        else:
                            np.testing.assert_allclose(tp[k].astype(np.float32),
                                                       jp[k].astype(np.float32), rtol=0,
                                                       atol=ATOL, err_msg=f"t{t} {k}")
        for k in shapes:
            np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]),
                                       rtol=0, atol=ATOL, err_msg=f"step {t} {k}")
    assert ts.step == int(js.step)
    for a, jt in js.aux.items():
        if a.startswith("fresh"):
            np.testing.assert_array_equal(ts.aux[a].numpy(), np.asarray(jt))
            continue
        for k in jt:
            np.testing.assert_allclose(ts.aux[a][k].numpy(), np.asarray(jt[k]), rtol=0,
                                       atol=ATOL, err_msg=f"{a}/{k}")


@pytest.mark.parametrize("rate", [0.0, 0.2, 0.5])
@pytest.mark.parametrize("algo,wire", DROP_CASES, ids=[f"{a}-{w}" for a, w in DROP_CASES])
def test_reference_matches_jax_under_drops(monkeypatch, algo, wire, rate):
    check_reference_against_jax(monkeypatch, algo, wire, "ring", f"{rate}:4" if rate else None)


def test_naive_reference_matches_jax_under_drops(monkeypatch):
    check_reference_against_jax(monkeypatch, "naive", "quant:4", "ring", "0.2:4")


def test_reference_validates_and_keeps_the_runtime_state_keys():
    ring = tg.make_gossip_plan("ring", N)
    with pytest.raises(ValueError):
        TRef(name="cpsgd", plan=ring, wire="quant:4")
    with pytest.raises(ValueError):
        TRef(name="dcd", plan=ring)
    with pytest.raises(ValueError):
        TRef(name="choco", plan=ring, wire="sign", gamma=0.0)
    assert TRef(name="dcd", plan=ring, wire="quant:4", drop=0.0).drop is None
    plan = tg.make_gossip_plan("full_logn", N)
    for algo, wire in (("choco", "sign"), ("dcd", "lowrank:2:warm"), ("deepsqueeze", "sign")):
        params = {"w": torch.zeros((4, 128))}
        ref = TRef(name=algo, plan=plan, wire=wire, drop="0.2:3").init(params)
        runtime = td.init_dist_state(algo, params, plan, tsgd(), drop="0.2:3", wire=wire)
        assert sorted(ref.aux) == sorted(runtime.aux), algo


def _linear_loss(p, batch):
    return sum(torch.sum(p[k] * batch[k]) for k in batch), {}


def _dcd_words(salt):
    """The words of one DCD step of the reference and of the runtime, with
    the runtime's salt table patched to ``salt``."""
    logs = {"ref": [], "runtime": []}
    side = ["ref"]
    orig = tw.QuantWire.encode

    def encode(self, leaf, seed, offset=0):
        payload = orig(self, leaf, seed, offset)
        logs[side[0]].append(_np(payload["codes"]))
        return payload
    _, p0, c = _targets(5)
    g = {k: torch.from_numpy(v) for k, v in c.items()}
    plan = tg.make_gossip_plan("ring", N)
    params = {k: torch.from_numpy(v) for k, v in p0.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(td._SALT, "dcd", salt)
        mp.setattr(tw.QuantWire, "encode", encode)
        ref = TRef(name="dcd", plan=plan, wire="quant:4:128")
        ref.step_fn()(ref.init(params), g, None, LR)
        side[0] = "runtime"
        step = td.make_dist_train_step(_linear_loss, "dcd", tsgd(), "quant:4:128", plan,
                                       tconstant(LR))
        step(td.init_dist_state("dcd", params, plan, tsgd()), g)
    return logs["ref"], logs["runtime"]


def test_reference_encodes_with_the_runtime_salts():
    """The reference reads its salts from the runtime's ``_SALT``: under the
    table as it is and under a patched one, its words equal the runtime's,
    and the patched salt changes them."""
    ref2, run2 = _dcd_words(td._SALT["dcd"])
    ref11, run11 = _dcd_words(11)
    assert len(ref2) == len(run2) == len(SHAPES)
    for a, b in zip(ref2 + ref11, run2 + run11):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(ref2, ref11))


def test_testbed_run_drives_the_reference():
    """``testbed.run`` drives the reference unchanged: D-PSGD through it
    follows the dense-W D-PSGD of :class:`Algorithm` (same minibatches, the
    mixing summed by shifts rather than by a matrix product), and DCD over
    8-bit words ends within 5% of it."""
    problem = make_problem(torch.Generator().manual_seed(1), n=N, m=64, d=16, hetero=0.2,
                           noise=0.1, device="cpu")
    plan = tg.make_gossip_plan("ring", N)
    dense = run(problem, make_algorithm("dpsgd", N, "ring"), T=100, lr=0.05, eval_every=20)
    ref = run(problem, TRef(name="dpsgd", plan=plan), T=100, lr=0.05, eval_every=20)
    np.testing.assert_allclose(ref["loss"], dense["loss"], rtol=1e-4)
    dcd = run(problem, TRef(name="dcd", plan=plan, wire="quant:8:32"), T=100, lr=0.05,
              eval_every=20)
    assert dcd["loss"][-1] < 0.01 * dcd["loss"][0]
    assert abs(dcd["final_loss"] - dense["final_loss"]) < 0.05 * dense["final_loss"]
