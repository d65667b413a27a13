"""The port's ``GossipReference`` against the JAX package's on the
multi-round and time-varying schedules, and over the lowrank (cold and
warm) and adaptive wires; the method is ``test_torch_gossip_reference.py``'s.
"""
import pytest

from test_torch_families import one_torch_thread  # noqa: F401
from test_torch_gossip_reference import SHAPES, check_reference_against_jax

# {dcd, ecd} on the multi-round and time-varying schedules at drop 0.3:5
SCHED_CASES = [(a, t) for a in ("dcd", "ecd") for t in ("full_logn", "exp", "exp_any")]
AD_SPEC = "adaptive:128:small=fp16:large=quant:4:32"
# a leaf of 32 elements a node goes small (fp16), the others large (quant:4:32)
AD_SHAPES = {**SHAPES, "s": (32,)}


@pytest.mark.parametrize("algo,topo", SCHED_CASES)
def test_reference_matches_jax_on_schedules(monkeypatch, algo, topo):
    """Per-round counters ``t*period + r`` (full_logn) and the time-varying
    round ``t % period`` with counter ``t`` (exp, exp_any)."""
    check_reference_against_jax(monkeypatch, algo, "quant:4:128", topo, "0.3:5")


@pytest.mark.parametrize("spec", ["lowrank:2", "lowrank:2:warm"])
def test_lowrank_reference_matches_jax(monkeypatch, spec):
    """The warm wire threads its codec state through ``aux``."""
    check_reference_against_jax(monkeypatch, "dcd", spec, "ring", None)


@pytest.mark.parametrize("algo", ["dcd", "ecd"])
def test_adaptive_reference_matches_jax(monkeypatch, algo):
    check_reference_against_jax(monkeypatch, algo, AD_SPEC, "ring", None, shapes=AD_SHAPES)
