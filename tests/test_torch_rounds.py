"""One DCD round and one ECD round of the port against the JAX runtime.

Both runtimes get the same params X, the same replicas / estimates (not
equal to roll(X), so the round's mixing is exercised) and the same optimizer
update: the per-node loss is linear, ``sum(p * g)``, so its gradient is
exactly the numpy tree ``g`` in both frameworks, and SGD turns it into
``-lr * g`` in both.  The port's payload words are recorded and held
bit-equal to the JAX wire's encode of the JAX-side Z; params, replicas and
estimates agree to atol 1e-6 (the jitted JAX step may fuse the f32 mixing
and decode into FMAs, which moves the last bits).
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
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import wire as tw
from repro_torch.distributed.gossip import GossipPlan as TorchPlan
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.optimizers import OptState
from repro_torch.optim.schedules import constant as tconstant

N, LR, STEP = 8, 0.05, 3
SHAPES = {"w": (N, 4, 300), "b": (N, 96)}   # ragged block fold; off-gate 96-wide leaf


@dataclasses.dataclass(frozen=True)
class RecordingWire(tw.QuantWire):
    """The port's quant wire, keeping every payload it encodes."""
    log: list = dataclasses.field(default_factory=list, compare=False, hash=False)

    def encode(self, leaf, seed, offset=0):
        payload = super().encode(leaf, seed, offset)
        self.log.append(payload)
        return payload


def _linear_loss_jax(p, batch):
    loss = jnp.sum(p["w"] * batch["gw"]) + jnp.sum(p["b"] * batch["gb"])
    return loss, {}


def _linear_loss_torch(p, batch):
    loss = torch.sum(p["w"] * batch["gw"]) + torch.sum(p["b"] * batch["gb"])
    return loss, {}


def _state(rng, algo):
    def tree():
        return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    X = tree()
    aux = {f"rep{s:+d}": tree() for s in (-1, 1)} if algo == "dcd" else \
        {k: tree() for k in ("tilde_self", "tilde-1", "tilde+1")}
    grads = {"gw": rng.standard_normal(SHAPES["w"]).astype(np.float32),
             "gb": rng.standard_normal(SHAPES["b"]).astype(np.float32)}
    return X, aux, grads


def _jax_z(algo, X, aux, grads):
    """The round's Z on the JAX side, from the JAX package's own functions."""
    plan = jg.GossipPlan.ring(N)
    upd = {"w": -jnp.float32(LR) * grads["gw"], "b": -jnp.float32(LR) * grads["gb"]}
    if algo == "dcd":
        reps = {s: aux[f"rep{s:+d}"] for s in plan.shift_list}
        x_half = japply(jg.plan_mix(plan, X, reps), upd)
        return jax.tree.map(lambda a, b: a - b, x_half, X)
    s_t = jnp.float32(STEP + 1)
    tildes = {s: aux[f"tilde{s:+d}"] for s in plan.shift_list}
    x_next = japply(jg.plan_mix(plan, aux["tilde_self"], tildes), upd)
    return jax.tree.map(lambda a, b: (1.0 - 0.5 * s_t) * a + 0.5 * s_t * b, X, x_next)


@pytest.mark.parametrize("algo", ["dcd", "ecd"])
def test_one_round_matches_jax(algo):
    rng = np.random.default_rng(11 if algo == "dcd" else 12)
    X, aux, grads = _state(rng, algo)
    salt = {"dcd": 2, "ecd": 3}[algo]

    jwire = jw.QuantWire(bits=4, block=128)
    jstate = jd.DistState(params={k: jnp.asarray(v) for k, v in X.items()}, opt=jsgd().init(X),
                          aux={k: {kk: jnp.asarray(vv) for kk, vv in t.items()}
                               for k, t in aux.items()},
                          step=jnp.int32(STEP))
    jbatch = {k: jnp.asarray(v) for k, v in grads.items()}
    jstep = jax.jit(jd.make_dist_train_step(_linear_loss_jax, algo, jsgd(), jwire,
                                            jg.GossipPlan.ring(N), jconstant(LR)))
    jnew, _ = jstep(jstate, jbatch)

    twire = RecordingWire(bits=4, block=128)
    tstate = td.DistState(params={k: torch.from_numpy(v.copy()) for k, v in X.items()},
                          opt=OptState(step=STEP),
                          aux={k: {kk: torch.from_numpy(vv.copy()) for kk, vv in t.items()}
                               for k, t in aux.items()},
                          step=STEP)
    tstep = td.make_dist_train_step(_linear_loss_torch, algo, tsgd(), twire,
                                    TorchPlan.ring(N), tconstant(LR))
    tnew, metrics = tstep(tstate, {k: torch.from_numpy(v) for k, v in grads.items()})

    # payload words: bit-equal to the JAX wire's encode of the JAX-side Z
    Z = _jax_z(algo, jstate.params, jstate.aux, jbatch)
    _, jpays = jwire.encode_tree(Z, jnp.int32(STEP), salt)
    assert len(twire.log) == len(jpays) == 2
    for tp, jp in zip(twire.log, jpays):
        np.testing.assert_array_equal(tp["codes"].numpy().view(np.uint32), np.asarray(jp["codes"]))
        np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(jp["scale"]))

    for k in SHAPES:
        np.testing.assert_allclose(tnew.params[k].numpy(), np.asarray(jnew.params[k]),
                                   rtol=0, atol=1e-6)
        for a in aux:
            np.testing.assert_allclose(tnew.aux[a][k].numpy(), np.asarray(jnew.aux[a][k]),
                                       rtol=0, atol=1e-6)
    assert tnew.step == STEP + 1
    np.testing.assert_allclose(float(metrics["consensus"]), float(_consensus(jnew.params)),
                               rtol=1e-5)


def _consensus(params):
    return sum(jnp.sum((l - jnp.mean(l, axis=0, keepdims=True)) ** 2)
               for l in jax.tree.leaves(params))


@pytest.mark.parametrize("algo", ["dcd", "ecd"])
def test_shift_invariant_holds_exactly(algo):
    """From ``init_dist_state`` the port keeps ``rep{s} == roll(X, s)`` (DCD)
    and ``tilde{s} == roll(tilde_self, s)`` (ECD) exactly: both sides are
    advanced by the same decode of the same words."""
    rng = np.random.default_rng(5)
    params = {k: torch.from_numpy(rng.standard_normal(s[1:]).astype(np.float32))
              for k, s in SHAPES.items()}
    state = td.init_dist_state(algo, params, N, tsgd())
    step = td.make_dist_train_step(_linear_loss_torch, algo, tsgd(), "quant:3:128", N,
                                   tconstant(LR))
    for t in range(3):
        batch = {"gw": torch.from_numpy(rng.standard_normal(SHAPES["w"]).astype(np.float32)),
                 "gb": torch.from_numpy(rng.standard_normal(SHAPES["b"]).astype(np.float32))}
        state, _ = step(state, batch)
    base = state.params if algo == "dcd" else state.aux["tilde_self"]
    prefix = "rep" if algo == "dcd" else "tilde"
    for s in (-1, 1):
        for k in SHAPES:
            assert torch.equal(state.aux[f"{prefix}{s:+d}"][k], torch.roll(base[k], s, dims=0))
