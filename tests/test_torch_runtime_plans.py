"""One step of the port's runtime against the JAX runtime's, on every kind
of gossip plan, with and without edge drops, for all seven algorithms.

Plans: ``chain`` (per-node weight vectors), ``full_logn`` (three rounds in
one step, encode counters ``t*3 + r``) and ``exp`` (time-varying, one round
a step; two steps, so two different rounds run).  Drops: none, or rate 0.3
with salt 7, from freshness vectors below one, so that the gates
``mask * fresh`` are fractional.  Both runtimes start from the same state
(random params, replicas, estimates and residuals, carried across with
``convert.dist_state_from_jax``) and take the same update: the per-node loss
is linear, ``sum(p * g)``, so SGD turns the numpy tree ``g`` into ``-lr * g``
in both.

The JAX step runs eagerly (not jitted): XLA's CPU backend contracts the
jitted float32 mixing into FMAs, which moves last bits and, through them,
stochastic codes of later rounds.  Eagerly, ``lax.switch`` still traces its
branches, so the time-varying step's round is picked by the (concrete)
index in Python instead, which is what the switch computes.  Each wire's
payloads are recorded on both sides, round by round, and held bit-equal:
codes, words and scales.  Params, aux trees and freshness vectors agree to
atol 1e-5.

One difference sits below the runtime, in the receive kernel: at an
accumulator weight other than +-1 (ECD's estimate decay ``1 - 2/s_t``) the
interpret-mode Pallas K2 contracts ``aw*acc + code*inv`` into an FMA, while
the port's K2 (CUDA and plain) rounds ``aw*acc`` first.  A later round would
then encode estimates a last bit apart.  So the JAX wire here scales the
accumulator by ``aw`` in its own float32 op and lets the kernel add at
weight 1, which is the port's association; everything else is the JAX
package's own code.
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
from repro.optim.schedules import constant as jconstant
from repro_torch.convert import dist_state_from_jax
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import gossip as tg
from repro_torch.distributed import wire as tw
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.schedules import constant as tconstant

N, LR, STEP, GAMMA, ATOL = 8, 0.05, 3, 0.5, 1e-5
SHAPES = {"w": (N, 2, 300), "b": (N, 96)}   # ragged block fold; off-gate 96-wide leaf
WIRE = dict(bits=4, block=128)
DROP = "0.3:7"
PREFIX = {"dcd": "rep", "ecd": "tilde", "choco": "hat"}
GOSSIP = ("dpsgd", "naive", "dcd", "ecd", "choco", "deepsqueeze")
TOPOLOGIES = ("chain", "full_logn", "exp")
# the cases under drops run from tests/test_torch_failures.py
CASES = [(algo, topo) for algo in GOSSIP for topo in TOPOLOGIES] + \
    [("cpsgd", topo) for topo in ("chain", "exp")]


@dataclasses.dataclass(frozen=True)
class JaxRecording(jw.QuantWire):
    """The JAX quant wire, keeping every tree of payloads it encodes."""
    log: list = dataclasses.field(default_factory=list, compare=False, hash=False)

    def encode_tree(self, tree, step, salt):
        tdef, payloads = super().encode_tree(tree, step, salt)
        self.log.append([{k: np.asarray(v) for k, v in p.items()} for p in payloads])
        return tdef, payloads

    def decode_axpy(self, payload, acc, weight, acc_weight=1.0):
        return super().decode_axpy(payload, jnp.float32(acc_weight) * acc, weight, 1.0)


@dataclasses.dataclass(frozen=True)
class TorchRecording(tw.QuantWire):
    """The port's quant wire, keeping a copy of every payload it encodes."""
    log: list = dataclasses.field(default_factory=list, compare=False, hash=False)

    def encode(self, leaf, seed, offset=0):
        payload = super().encode(leaf, seed, offset)
        self.log.append({k: v.clone() for k, v in payload.items()})
        return payload


def _linear_loss_jax(p, batch):
    return jnp.sum(p["w"] * batch["gw"]) + jnp.sum(p["b"] * batch["gb"]), {}


def _linear_loss_torch(p, batch):
    return torch.sum(p["w"] * batch["gw"]) + torch.sum(p["b"] * batch["gb"]), {}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _jax_state(rng, algo, sched, drop):
    aux = {}
    if algo in PREFIX:
        keys = [f"{PREFIX[algo]}{s:+d}" for s in sched.shift_union]
        if algo != "dcd":
            keys.append(f"{PREFIX[algo]}_self")
        aux = {k: _tree(rng) for k in keys}
    elif algo == "deepsqueeze":
        aux = {"err_self": _tree(rng, 0.1)}
    if drop is not None and algo in PREFIX:
        d = jd.make_drop_spec(drop)
        for s in sched.shift_union:
            aux[jd.fresh_key(s, d.salt)] = rng.uniform(0.2, 1.0, N).astype(np.float32)
    X = _tree(rng)
    return jd.DistState(params=jax.tree.map(jnp.asarray, X), opt=jsgd().init(X),
                        aux=jax.tree.map(jnp.asarray, aux), step=jnp.int32(STEP))


def _eager_switch(index, branches, *operands):
    return branches[int(index)](*operands)


def _words(payload):
    return {k: (v.numpy().view(np.uint32) if v.dtype == torch.int32 else v.numpy())
            for k, v in payload.items()}


@pytest.mark.parametrize("algo,topo", CASES)
def test_step_matches_jax_runtime(algo, topo, monkeypatch):
    check_step_against_jax(algo, topo, None, monkeypatch)


def check_step_against_jax(algo, topo, drop, monkeypatch):
    """One step (two on ``exp``) of both runtimes from the same state;
    words bit-equal, floats to ``ATOL``."""
    monkeypatch.setattr(jax.lax, "switch", _eager_switch)
    rng = np.random.default_rng(sum(map(ord, f"{algo}{topo}{drop}")))
    jplan, tplan = jg.make_gossip_plan(topo, N), tg.make_gossip_plan(topo, N)
    sched = jg.as_schedule(jplan)
    jstate = _jax_state(rng, algo, sched, drop)
    tstate = dist_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    uses_wire = algo in td.WIRE_ALGOS
    jwire = JaxRecording(**WIRE) if uses_wire else None
    twire = TorchRecording(**WIRE) if uses_wire else None
    jstep = jd.make_dist_train_step(_linear_loss_jax, algo, jsgd(), jwire, jplan,
                                    jconstant(LR), drop=drop, gamma=GAMMA)
    tstep = td.make_dist_train_step(_linear_loss_torch, algo, tsgd(), twire, tplan,
                                    tconstant(LR), drop=drop, gamma=GAMMA)
    for _ in range(2 if sched.time_varying else 1):
        grads = {"gw": rng.standard_normal(SHAPES["w"]).astype(np.float32),
                 "gb": rng.standard_normal(SHAPES["b"]).astype(np.float32)}
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, grads))
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in grads.items()})

    if uses_wire:
        # the port encodes leaf by leaf with the rounds inside; JAX round by
        # round, each a tree of the two leaves
        rounds = len(jwire.log)
        assert rounds == (2 if sched.time_varying else sched.period)
        assert len(twire.log) == 2 * rounds
        for r, jpays in enumerate(jwire.log):
            for li, jp in enumerate(jpays):
                step_r, rr = divmod(r, 1 if sched.time_varying else rounds)
                tp = twire.log[step_r * 2 * (1 if sched.time_varying else rounds)
                               + li * (1 if sched.time_varying else rounds) + rr]
                got = _words(tp)
                assert sorted(got) == sorted(jp)
                for k in jp:
                    np.testing.assert_array_equal(got[k], jp[k], err_msg=f"round {r} leaf {li} {k}")

    for k in SHAPES:
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(jstate.params[k]),
                                   rtol=0, atol=ATOL)
    assert sorted(tstate.aux) == sorted(jstate.aux)
    for a, jt in jstate.aux.items():
        if a.startswith("fresh"):
            np.testing.assert_array_equal(tstate.aux[a].numpy(), np.asarray(jt))
            continue
        for k in SHAPES:
            np.testing.assert_allclose(tstate.aux[a][k].numpy(), np.asarray(jt[k]),
                                       rtol=0, atol=ATOL, err_msg=a)
    assert tstate.step == int(jstate.step) and tstate.opt.step == int(jstate.opt.step)
    np.testing.assert_allclose(float(tmet["consensus"]), float(jmet["consensus"]), rtol=1e-5)


def test_cpsgd_refuses_drops_and_wire_algos_need_a_wire():
    with pytest.raises(ValueError):
        td.make_dist_train_step(_linear_loss_torch, "cpsgd", tsgd(), None, N, tconstant(LR),
                                drop=0.1)
    with pytest.raises(ValueError):
        td.make_dist_train_step(_linear_loss_torch, "naive", tsgd(), None, N, tconstant(LR))
    # a zero rate is no drop at all: the state needs no freshness vectors
    params = {"w": torch.ones((2, 128))}
    state = td.init_dist_state("dcd", params, N, tsgd(), drop=0.0)
    assert sorted(state.aux) == ["rep+1", "rep-1"]


@pytest.mark.parametrize("algo", ["dcd", "ecd", "choco"])
def test_replicas_track_neighbours_exactly_without_drops(algo):
    """From ``init_dist_state`` on ``full_logn`` (three rounds a step) and
    ``exp`` (one round a step), every union replica or estimate equals the
    rolled tree it tracks, bit for bit, after three steps."""
    rng = np.random.default_rng(3)
    params = {k: torch.from_numpy(rng.standard_normal(s[1:]).astype(np.float32))
              for k, s in SHAPES.items()}
    for topo in ("full_logn", "exp"):
        plan = tg.make_gossip_plan(topo, N)
        state = td.init_dist_state(algo, params, plan, tsgd())
        step = td.make_dist_train_step(_linear_loss_torch, algo, tsgd(), "quant:3:128", plan,
                                       tconstant(LR))
        for _ in range(3):
            batch = {"gw": torch.from_numpy(rng.standard_normal(SHAPES["w"]).astype(np.float32)),
                     "gb": torch.from_numpy(rng.standard_normal(SHAPES["b"]).astype(np.float32))}
            state, _ = step(state, batch)
        base = state.params if algo == "dcd" else state.aux[f"{PREFIX[algo]}_self"]
        for s in plan.shift_union:
            for k in SHAPES:
                assert torch.equal(state.aux[f"{PREFIX[algo]}{s:+d}"][k],
                                   torch.roll(base[k], s, dims=0)), (topo, s, k)
