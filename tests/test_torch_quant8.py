"""The runtime's default wire, ``quant:8``, against the JAX package, and the
quant wire's NaN semantics.

One DCD round and one ECD round at 8 bits, as tests/test_torch_rounds.py
runs them at 4: the port's int8 payloads are bit-equal to the JAX wire's
encode of the JAX-side Z, and the round goes through the K3 and K4a
wrappers (the send behind the 128-lane gate, every receive a K4a decode and
the axpy in torch, the JAX base path).  Params and estimates agree to atol
1e-6 (the jitted JAX step may fuse the axpy into FMAs).

A block holding a NaN: the JAX wire stores a NaN scale and decodes the whole
block to NaN, at bits 4 and 8, and so must the port.
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
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import wire as tw
from repro_torch.distributed.gossip import GossipPlan as TorchPlan
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref
from repro_torch.optim import sgd as tsgd
from repro_torch.optim.optimizers import OptState
from repro_torch.optim.schedules import constant as tconstant

N, LR, STEP = 8, 0.05, 3
SHAPES = {"w": (N, 4, 300), "b": (N, 96)}   # ragged 128-block fold; off-gate 96-wide leaf


@dataclasses.dataclass(frozen=True)
class RecordingWire(tw.QuantWire):
    """The port's quant wire, keeping every payload it encodes."""
    log: list = dataclasses.field(default_factory=list, compare=False, hash=False)

    def encode(self, leaf, seed, offset=0):
        payload = super().encode(leaf, seed, offset)
        self.log.append(payload)
        return payload


def _linear_loss_jax(p, batch):
    return jnp.sum(p["w"] * batch["gw"]) + jnp.sum(p["b"] * batch["gb"]), {}


def _linear_loss_torch(p, batch):
    return torch.sum(p["w"] * batch["gw"]) + torch.sum(p["b"] * batch["gb"]), {}


def _counting(monkeypatch, names):
    """Count the wire's calls of the kernel wrappers ``names`` (on the CPU
    they run the plain versions, so their launch counters stay 0)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tw, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tw, name, counted)
    return calls


@pytest.mark.parametrize("algo", ["dcd", "ecd"])
def test_quant8_round_matches_jax_through_k3_and_k4a(algo, monkeypatch):
    rng = np.random.default_rng(21 if algo == "dcd" else 22)

    def tree():
        return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    X = tree()
    aux = {f"rep{s:+d}": tree() for s in (-1, 1)} if algo == "dcd" else \
        {k: tree() for k in ("tilde_self", "tilde-1", "tilde+1")}
    grads = {"gw": rng.standard_normal(SHAPES["w"]).astype(np.float32),
             "gb": rng.standard_normal(SHAPES["b"]).astype(np.float32)}
    salt = {"dcd": 2, "ecd": 3}[algo]

    jwire = jw.QuantWire(bits=8, block=128)
    jstate = jd.DistState(params={k: jnp.asarray(v) for k, v in X.items()}, opt=jsgd().init(X),
                          aux={k: {kk: jnp.asarray(vv) for kk, vv in t.items()}
                               for k, t in aux.items()},
                          step=jnp.int32(STEP))
    jstep = jax.jit(jd.make_dist_train_step(_linear_loss_jax, algo, jsgd(), jwire,
                                            jg.GossipPlan.ring(N), jconstant(LR)))
    jnew, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in grads.items()})

    calls = _counting(monkeypatch, ("quantize_2d", "dequantize_2d", "quantize_pack_2d",
                                    "unpack_dequant_2d", "unpack_dequant_axpy_2d"))
    twire = RecordingWire(bits=8, block=128)
    tstate = td.DistState(params={k: torch.from_numpy(v.copy()) for k, v in X.items()},
                          opt=OptState(step=STEP),
                          aux={k: {kk: torch.from_numpy(vv.copy()) for kk, vv in t.items()}
                               for k, t in aux.items()},
                          step=STEP)
    tstep = td.make_dist_train_step(_linear_loss_torch, algo, tsgd(), twire,
                                    TorchPlan.ring(N), tconstant(LR))
    tnew, _ = tstep(tstate, {k: torch.from_numpy(v) for k, v in grads.items()})

    # one K3 send for the 128-block leaf (the 96-wide one is off the gate),
    # a K4a decode for each of the 3 receives of both leaves
    assert calls == {"quantize_2d": 1, "dequantize_2d": 6, "quantize_pack_2d": 0,
                     "unpack_dequant_2d": 0, "unpack_dequant_axpy_2d": 0}
    upd = {"w": -jnp.float32(LR) * grads["gw"], "b": -jnp.float32(LR) * grads["gb"]}
    plan = jg.GossipPlan.ring(N)
    if algo == "dcd":
        x_half = jax.tree.map(lambda a, u: a + u, jg.plan_mix(
            plan, jstate.params, {s: jstate.aux[f"rep{s:+d}"] for s in plan.shift_list}), upd)
        Z = jax.tree.map(lambda a, b: a - b, x_half, jstate.params)
    else:
        s_t = jnp.float32(STEP + 1)
        x_next = jax.tree.map(lambda a, u: a + u, jg.plan_mix(
            plan, jstate.aux["tilde_self"],
            {s: jstate.aux[f"tilde{s:+d}"] for s in plan.shift_list}), upd)
        Z = jax.tree.map(lambda a, b: (1.0 - 0.5 * s_t) * a + 0.5 * s_t * b,
                         jstate.params, x_next)
    _, jpays = jwire.encode_tree(Z, jnp.int32(STEP), salt)
    assert len(twire.log) == len(jpays) == 2
    for tp, jp in zip(twire.log, jpays):
        assert tp["codes"].dtype == torch.int8
        np.testing.assert_array_equal(tp["codes"].numpy(), np.asarray(jp["codes"]))
        np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(jp["scale"]))
    for k in SHAPES:
        np.testing.assert_allclose(tnew.params[k].numpy(), np.asarray(jnew.params[k]),
                                   rtol=0, atol=1e-6)
        for a in aux:
            np.testing.assert_allclose(tnew.aux[a][k].numpy(), np.asarray(jnew.aux[a][k]),
                                       rtol=0, atol=1e-6)


def test_quant8_replica_invariant_holds_exactly():
    rng = np.random.default_rng(6)
    params = {k: torch.from_numpy(rng.standard_normal(s[1:]).astype(np.float32))
              for k, s in SHAPES.items()}
    state = td.init_dist_state("dcd", params, N, tsgd())
    step = td.make_dist_train_step(_linear_loss_torch, "dcd", tsgd(), "quant:8:128", N,
                                   tconstant(LR))
    for _ in range(3):
        batch = {k: torch.from_numpy(rng.standard_normal(SHAPES[s]).astype(np.float32))
                 for k, s in (("gw", "w"), ("gb", "b"))}
        state, _ = step(state, batch)
    for s in (-1, 1):
        for k in SHAPES:
            assert torch.equal(state.aux[f"rep{s:+d}"][k], torch.roll(state.params[k], s, dims=0))


@pytest.mark.parametrize("bits", [4, 8])
def test_nan_block_decodes_to_nan_like_jax(bits):
    """A NaN anywhere in a block: the scale is NaN and the whole block
    decodes to NaN, in the JAX wire and in the port's (the K1/K3 plain
    versions, K4b/K4a); the other blocks' codes, scales and values are
    bit-equal.  The NaN element's own code is a NaN cast to an integer,
    implementation-defined in both."""
    x = np.random.default_rng(bits).standard_normal((3, 2, 1024)).astype(np.float32) * 0.1
    x[1, 0, 700] = np.nan                       # block (1, 0, 0) of (3, 2, 1, 1024)
    seed = 0xBADF00D
    jwire, twire = jw.QuantWire(bits=bits, block=1024), tw.QuantWire(bits=bits, block=1024)
    jp = jax.jit(lambda a: jwire.encode(a, jnp.uint32(seed)))(jnp.asarray(x))
    tp = twire.encode(torch.from_numpy(x), seed)
    jd_ = np.asarray(jax.jit(lambda p: jwire.decode(p, jnp.zeros(x.shape)))(jp))
    td_ = twire.decode(tp, torch.from_numpy(x)).numpy()
    js, ts = np.asarray(jp["scale"]), tp["scale"].numpy()
    assert np.isnan(js[1, 0, 0, 0]) and np.isnan(ts[1, 0, 0, 0])
    assert np.isnan(jd_[1, 0]).all() and np.isnan(td_[1, 0]).all()
    other = np.ones(x.shape[:2], bool)
    other[1, 0] = False
    np.testing.assert_array_equal(ts[other], js[other])
    jc = np.asarray(jp["codes"])
    tc = tp["codes"].numpy().view(np.uint32) if bits < 8 else tp["codes"].numpy()
    np.testing.assert_array_equal(tc[other], jc[other])
    np.testing.assert_array_equal(td_[other], jd_[other])
    # the block's other codes are the unnormalised x * L (safe scale 1),
    # stochastically rounded and clipped
    tcodes = tref.unpack_codes(tp["codes"][1, 0], bits=bits) if bits < 8 else tp["codes"][1, 0]
    levels = 2 ** (bits - 1) - 1
    lanes = np.arange(1024) != 700
    raw = np.clip(x[1, 0, lanes] * np.float32(levels), -levels, levels)
    assert np.abs(tcodes.numpy()[0, lanes] - raw).max() <= 1.0
    # the 2-D wrapper on the fold: the block is its row 2
    _, scale = tq.quantize_2d(torch.from_numpy(x.reshape(6, 1024)), seed, bits=bits)
    assert torch.isnan(scale[2]).all() and not torch.isnan(scale[[0, 1, 3, 4, 5]]).any()
