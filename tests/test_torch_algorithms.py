"""The port's stacked algorithms (``repro_torch.core.algorithms``) held
against the JAX package's on the CPU.

Each step starts both packages from the same state — the JAX state,
carried over with ``convert.algo_state_from_jax`` — with the same numpy
gradients and the same integer step key, and compares the states after the
step; three steps in a row.  The JAX step runs eagerly, op by op (under
jit XLA fuses the f32 arithmetic into FMAs).  Tolerances: 1e-6 with the
identity compressor.  A compressor rounds its input, and the mixing
``tensordot`` may sum in another order in each package, so an input that
lands within an ulp of a rounding boundary may round the other way: the
tolerance is one step of the compressor's grid at the largest input it saw
that step (``scale/L`` for the quantizer, ``2^-10 |z|`` for fp16), plus
1e-6, and at most one element in a thousand may use it.  That the payloads
themselves are bit-equal on equal input is tested on its own below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core import compression as jc
from repro_torch.convert import algo_state_from_jax
from repro_torch.core import algorithms as ta
from repro_torch.core import compression as tc

N, LR = 8, 0.05
SHAPES = {"w": (3, 200), "b": (96,)}


class Seen:
    """The largest |input| a port compressor saw, and its grid step there."""

    def __init__(self):
        self.max_abs = 0.0


@dataclasses.dataclass(frozen=True)
class SeenQuantizer(tc.RandomQuantizer):
    seen: Seen = dataclasses.field(default_factory=Seen, compare=False, hash=False)

    def apply_leaf(self, key, leaf, leaf_index=0, path=""):
        self.seen.max_abs = max(self.seen.max_abs, float(leaf.abs().max()))
        return super().apply_leaf(key, leaf, leaf_index, path)

    def grid(self) -> float:
        return self.seen.max_abs / self.levels


@dataclasses.dataclass(frozen=True)
class SeenHalf(tc.HalfPrecisionCompressor):
    seen: Seen = dataclasses.field(default_factory=Seen, compare=False, hash=False)

    def apply_leaf(self, key, leaf, leaf_index=0, path=""):
        self.seen.max_abs = max(self.seen.max_abs, float(leaf.abs().max()))
        return super().apply_leaf(key, leaf, leaf_index, path)

    def grid(self) -> float:
        return self.seen.max_abs * 2.0 ** -10


def _compressors(kind):
    if kind == "identity":
        return jc.IdentityCompressor(), tc.IdentityCompressor()
    if kind == "fp16":
        return jc.HalfPrecisionCompressor(), SeenHalf()
    return jc.RandomQuantizer(bits=8, block_size=128), SeenQuantizer(bits=8, block_size=128)


CASES = [(algo, "identity") for algo in ja.ALGORITHMS] + \
    [(algo, "quant8") for algo in ("naive", "dcd", "ecd", "choco", "deepsqueeze")] + \
    [(algo, "fp16") for algo in ("dcd", "choco")]


@pytest.mark.parametrize("algo,kind", CASES)
def test_three_steps_match_jax(algo, kind):
    rng = np.random.default_rng(len(algo) * 10 + len(kind))
    jcomp, tcomp = _compressors(kind)
    jalg = ja.make_algorithm(algo, N, "ring", jcomp, gamma=0.4)
    talg = ta.make_algorithm(algo, N, "ring", tcomp, gamma=0.4)
    np.testing.assert_array_equal(talg.W, jalg.W)
    single = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jstate = jalg.init(jax.tree.map(jnp.asarray, single))
    tinit = talg.init({k: torch.from_numpy(v) for k, v in single.items()})
    jstep, tstep = jalg.step_fn(), talg.step_fn()
    for k, leaf in tinit.params.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jstate.params[k]))
    for t in range(3):
        grads = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in SHAPES.items()}
        tstate = algo_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        if kind != "identity":
            tcomp.seen.max_abs = 0.0
        jstate = jstep(jstate, jax.tree.map(jnp.asarray, grads), jnp.int32(t), jnp.float32(LR))
        out = tstep(tstate, {k: torch.from_numpy(v) for k, v in grads.items()}, t, LR)
        assert out is tstate and tstate.step == int(jstate.step) == t + 2
        tol = 1e-6 + (0.0 if kind == "identity" else tcomp.grid())
        pairs = [(tstate.params, jstate.params)]
        if jstate.aux is not None:
            pairs.append((tstate.aux, jstate.aux))
        for got, want in pairs:
            for k in SHAPES:
                g, w = got[k].numpy(), np.asarray(want[k])
                np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                           err_msg=f"{algo} {kind} step {t} {k}")
                assert (np.abs(g - w) > 1e-6).sum() <= g.size // 1000, (algo, kind, t, k)


def test_compressed_payloads_on_the_same_z_are_bit_equal():
    """The tolerance above is for rounding boundaries only: on equal input
    the quantizer's ``tree_apply`` at an integer step is bit-equal."""
    rng = np.random.default_rng(0)
    z = {k: rng.standard_normal((N,) + s).astype(np.float32) * 0.01 for k, s in SHAPES.items()}
    jcomp, tcomp = jc.RandomQuantizer(bits=8, block_size=128), tc.RandomQuantizer(
        bits=8, block_size=128)
    jout = jcomp.tree_apply(3, jax.tree.map(jnp.asarray, z))
    tout = tcomp.tree_apply(3, {k: torch.from_numpy(v) for k, v in z.items()})
    for k in SHAPES:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))


def test_mix_consensus_and_average_match_jax():
    W = ta.make_algorithm("dpsgd", 5, "torus").W
    X = {"a": np.arange(15, dtype=np.float32).reshape(5, 3),
         "b": np.random.default_rng(1).standard_normal((5, 2, 2)).astype(np.float32)}
    tX = {k: torch.from_numpy(v) for k, v in X.items()}
    jX = jax.tree.map(jnp.asarray, X)
    for k, leaf in ta.mix(W, tX).items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ja.mix(W, jX)[k]), rtol=1e-6)
    np.testing.assert_allclose(float(ta.consensus_distance(tX)),
                               float(ja.consensus_distance(jX)), rtol=1e-6)
    np.testing.assert_allclose(ta.average_model(tX)["b"].numpy(),
                               np.asarray(ja.average_model(jX)["b"]), rtol=1e-6)


@pytest.mark.parametrize("topology", ["ring", "chain", "full", "star", "torus"])
@pytest.mark.parametrize("n", [1, 2, 6, 9])
def test_topologies_match_jax(topology, n):
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    np.testing.assert_array_equal(tt.make_topology(topology, n), jt.make_topology(topology, n))
    tt.check_mixing_matrix(tt.make_topology(topology, n))


def test_algorithm_checks():
    assert ta.ALGORITHMS == ja.ALGORITHMS
    with pytest.raises(ValueError, match="gamma"):
        ta.make_algorithm("choco", 4, gamma=0.0)
    with pytest.raises(ValueError, match="algorithms"):
        ta.make_algorithm("gossip", 4)
    with pytest.raises(ValueError, match="topology"):
        ta.make_algorithm("dcd", 4, "hypercube")
    state = ta.make_algorithm("deepsqueeze", 4).init(torch.ones(3))
    assert state.step == 1 and torch.equal(state.aux, torch.zeros(4, 3))
    ecd = ta.make_algorithm("ecd", 4).init({"x": torch.ones(3)})
    assert ecd.aux["x"] is not ecd.params["x"]       # its own copy, updated in place
