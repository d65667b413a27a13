"""CHOCO-SGD and DeepSqueeze in the port against the JAX runtime, on the CPU.

One round: both runtimes get the same params X, the same estimates (CHOCO;
not equal to roll(hat_self), so the round's mixing is exercised) or
residuals (DeepSqueeze), and the same optimizer update: the per-node loss is
linear, ``sum(p * g)``, so SGD turns the numpy tree ``g`` into ``-lr * g`` in
both frameworks.  The port's payloads are recorded and held to the JAX
wire's eager encode of the JAX-side Z (CHOCO) or V (DeepSqueeze): integer
containers and sparse values bit-equal, sign scales to rtol 1e-5 (the port
sums them in its kernel's order; see test_torch_codecs.py).  Params and aux
agree with the jitted JAX step to atol 1e-6: XLA's CPU backend contracts
the f32 mixing and decode into FMAs, which moves the last bits.

Each algorithm runs both sign scale modes and both sparse selection modes
between its cases, and the identity wire, where CHOCO and DeepSqueeze reduce
to their uncompressed forms.  The slice as a whole (reduced granite, two
steps) is in ``test_torch_ef_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import decentralized as jd
from repro.distributed import gossip as jg
from repro.distributed import wire as jw
from repro.optim import sgd as jsgd
from repro.optim.optimizers import apply_updates as japply
from repro.optim.schedules import constant as jconstant
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import wire as tw
from repro_torch.distributed.gossip import GossipPlan as TorchPlan
from repro_torch.launch.train import TrainConfig, run_training
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.optimizers import OptState
from repro_torch.optim.schedules import constant as tconstant
from repro_torch.tree import tree_leaves
from test_torch_families import one_torch_thread  # noqa: F401

N, LR, STEP, GAMMA = 8, 0.05, 3, 0.5
SHAPES = {"w": (N, 4, 300), "b": (N, 96)}   # ragged block fold; off-gate 96-wide leaf
SALT = {"choco": 4, "deepsqueeze": 5}
SIGN_SCALE_RTOL = 1e-5
ROUND_CASES = [("choco", "sign:mean:128"), ("choco", "sparse:0.25:topk:128"),
               ("choco", "identity"), ("deepsqueeze", "sign:l2:128"),
               ("deepsqueeze", "sparse:0.25:randk:128"), ("deepsqueeze", "identity")]


def _recording(spec: str):
    """The port's wire for ``spec``, keeping a copy of every payload it
    encodes (an identity payload is the encoded buffer itself, which
    DeepSqueeze turns into its residual afterwards)."""
    wire = tw.make_wire_format(spec)
    base = type(wire)

    @dataclasses.dataclass(frozen=True)
    class Recording(base):
        log: list = dataclasses.field(default_factory=list, compare=False, hash=False)

        def encode(self, leaf, seed, offset=0):
            payload = super().encode(leaf, seed, offset)
            self.log.append({k: v.clone() for k, v in payload.items()})
            return payload

    return Recording(**{f.name: getattr(wire, f.name) for f in dataclasses.fields(base)})


def _linear_loss_jax(p, batch):
    return jnp.sum(p["w"] * batch["gw"]) + jnp.sum(p["b"] * batch["gb"]), {}


def _linear_loss_torch(p, batch):
    return torch.sum(p["w"] * batch["gw"]) + torch.sum(p["b"] * batch["gb"]), {}


def _tree(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _state(rng, algo):
    X = _tree(rng)
    aux = {k: _tree(rng) for k in ("hat_self", "hat-1", "hat+1")} if algo == "choco" \
        else {"err_self": jax.tree.map(lambda a: 0.1 * a, _tree(rng))}
    grads = {"gw": rng.standard_normal(SHAPES["w"]).astype(np.float32),
             "gb": rng.standard_normal(SHAPES["b"]).astype(np.float32)}
    return X, aux, grads


def _jax_encoded(algo, X, aux, grads):
    """What the round encodes on the JAX side: Z = X_half - hat_self (CHOCO)
    or V = X_half + err_self (DeepSqueeze), from the JAX package's own
    functions, run eagerly."""
    upd = {"w": -jnp.float32(LR) * grads["gw"], "b": -jnp.float32(LR) * grads["gb"]}
    x_half = japply(X, upd)
    if algo == "choco":
        return jax.tree.map(lambda a, b: a - b, x_half, aux["hat_self"])
    return jax.tree.map(lambda a, b: a + b, x_half, aux["err_self"])


def _assert_payload_matches(tp: dict, jp: dict) -> None:
    """Integer containers and values bit-equal; the sign codec's ``scale``
    (the only scale among these wires) to ``SIGN_SCALE_RTOL``."""
    assert sorted(tp) == sorted(jp)
    for key in jp:
        want = np.asarray(jp[key])
        got = tp[key].numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape and got.dtype == want.dtype, (key, got.dtype, want.dtype)
        if key == "scale":
            np.testing.assert_allclose(got, want, rtol=SIGN_SCALE_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, want)


def _run_port_round(algo, spec, X, aux, grads):
    twire = _recording(spec)
    tstate = td.DistState(params={k: torch.from_numpy(v.copy()) for k, v in X.items()},
                          opt=OptState(step=STEP),
                          aux={k: {kk: torch.from_numpy(vv.copy()) for kk, vv in t.items()}
                               for k, t in aux.items()},
                          step=STEP)
    tstep = td.make_dist_train_step(_linear_loss_torch, algo, tsgd(), twire, TorchPlan.ring(N),
                                    tconstant(LR), gamma=GAMMA)
    tnew, metrics = tstep(tstate, {k: torch.from_numpy(v) for k, v in grads.items()})
    return twire, tnew, metrics


@pytest.mark.parametrize("algo,spec", ROUND_CASES)
def test_one_round_matches_jax(algo, spec):
    rng = np.random.default_rng(sum(map(ord, algo + spec)))
    X, aux, grads = _state(rng, algo)

    jwire = jw.make_wire_format(spec)
    jstate = jd.DistState(params={k: jnp.asarray(v) for k, v in X.items()}, opt=jsgd().init(X),
                          aux={k: {kk: jnp.asarray(vv) for kk, vv in t.items()}
                               for k, t in aux.items()},
                          step=jnp.int32(STEP))
    jbatch = {k: jnp.asarray(v) for k, v in grads.items()}
    jstep = jax.jit(jd.make_dist_train_step(_linear_loss_jax, algo, jsgd(), jwire,
                                            jg.GossipPlan.ring(N), jconstant(LR), gamma=GAMMA))
    jnew, _ = jstep(jstate, jbatch)

    twire, tnew, metrics = _run_port_round(algo, spec, X, aux, grads)

    enc = _jax_encoded(algo, jstate.params, jstate.aux, jbatch)
    _, jpays = jwire.encode_tree(enc, jnp.int32(STEP), SALT[algo])
    assert len(twire.log) == len(jpays) == 2
    for tp, jp in zip(twire.log, jpays):
        _assert_payload_matches(tp, jp)

    for k in SHAPES:
        np.testing.assert_allclose(tnew.params[k].numpy(), np.asarray(jnew.params[k]),
                                   rtol=0, atol=1e-6)
        for a in aux:
            np.testing.assert_allclose(tnew.aux[a][k].numpy(), np.asarray(jnew.aux[a][k]),
                                       rtol=0, atol=1e-6)
    assert tnew.step == STEP + 1
    consensus = sum(jnp.sum((l - jnp.mean(l, axis=0, keepdims=True)) ** 2)
                    for l in jax.tree.leaves(jnew.params))
    np.testing.assert_allclose(float(metrics["consensus"]), float(consensus), rtol=1e-5)


@pytest.mark.parametrize("spec", ["sign", "sparse:0.25:topk", "sparse:0.05:randk:128"])
def test_choco_shared_estimate_invariant_holds_exactly(spec):
    """From ``init_dist_state`` the port keeps ``hat{s} == roll(hat_self, s)``
    exactly: both are advanced by the same decode of the same words."""
    rng = np.random.default_rng(7)
    params = {k: torch.from_numpy(rng.standard_normal(s[1:]).astype(np.float32))
              for k, s in SHAPES.items()}
    state = td.init_dist_state("choco", params, N, tsgd())
    assert sorted(state.aux) == ["hat+1", "hat-1", "hat_self"]
    step = td.make_dist_train_step(_linear_loss_torch, "choco", tsgd(), spec, N,
                                   tconstant(LR), gamma=GAMMA)
    for _ in range(3):
        batch = {"gw": torch.from_numpy(rng.standard_normal(SHAPES["w"]).astype(np.float32)),
                 "gb": torch.from_numpy(rng.standard_normal(SHAPES["b"]).astype(np.float32))}
        state, _ = step(state, batch)
    for s in (-1, 1):
        for k in SHAPES:
            assert torch.equal(state.aux[f"hat{s:+d}"][k],
                               torch.roll(state.aux["hat_self"][k], s, dims=0))


def test_deepsqueeze_state_and_gamma_checks():
    params = {"w": torch.ones((3, 128))}
    state = td.init_dist_state("deepsqueeze", params, 4, tsgd())
    assert list(state.aux) == ["err_self"]
    assert state.aux["err_self"]["w"].shape == (4, 3, 128)
    assert not state.aux["err_self"]["w"].any()
    for gamma in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            td.make_dist_train_step(_linear_loss_torch, "choco", tsgd(), "sign", 4,
                                    tconstant(LR), gamma=gamma)
    td.make_dist_train_step(_linear_loss_torch, "choco", tsgd(), "sign", 4, tconstant(LR),
                            gamma=1.0)


def test_run_training_choco_on_cpu():
    cfg = tget_config("granite-3-2b").reduced()
    tc = TrainConfig(algo="choco", wire="sign", gamma=0.5, n_nodes=4, seq_len=16,
                     global_batch=8, steps=2, log_every=1)
    hist = run_training(cfg, tc, device="cpu")
    assert len(hist["losses"]) == 2 and all(np.isfinite(hist["losses"]))
    assert all(np.isfinite(hist["consensus"]))
    aux = hist["state"].aux
    for s in (-1, 1):
        for h, r in zip(tree_leaves(aux["hat_self"]), tree_leaves(aux[f"hat{s:+d}"])):
            assert torch.equal(torch.roll(h, s, dims=0), r)
    with pytest.raises(ValueError):
        run_training(cfg, dataclasses.replace(tc, gamma=0.0), device="cpu")
