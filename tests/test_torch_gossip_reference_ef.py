"""The port's ``GossipReference`` against the JAX package's for CHOCO and
DeepSqueeze: {sign, quant:4, sparse:0.05:topk} x {ring, full_logn} x drop
{0, 0.2} (salt 4), gamma 0.7, as the JAX package's error-feedback acceptance
test; the method is ``test_torch_gossip_reference.py``'s.
"""
import pytest

from test_torch_families import one_torch_thread  # noqa: F401
from test_torch_gossip_reference import check_reference_against_jax

EF_CASES = [(a, w, t) for a in ("choco", "deepsqueeze")
            for w in ("sign", "quant:4", "sparse:0.05:topk") for t in ("ring", "full_logn")]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("algo,wire,topo", EF_CASES)
def test_error_feedback_reference_matches_jax(monkeypatch, algo, wire, topo, rate):
    check_reference_against_jax(monkeypatch, algo, wire, topo, f"{rate}:4" if rate else None,
                                gamma=0.7)
