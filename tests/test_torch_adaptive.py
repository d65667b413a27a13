"""The port's ``adaptive`` per-leaf combinator against the JAX package's.

On the reduced granite-3-2b tree stacked over 4 nodes: the routing of every
leaf (path and sub-format) equals JAX ``AdaptiveWire.leaf_wires`` exactly;
the spec grammar, ``wire_spec`` round-trips and the refusals (nesting, a
negative threshold, a second positional) match; ``wire_nbytes`` and
``wire_bits_per_element`` are equal to the byte.  The tree-level encode
through the routed sub-formats gives the JAX payloads: ``quant`` words and
``fp16`` values bit-equal, ``lowrank`` factors to rtol 1e-4 / atol 1e-5
(their sums run in the port's fixed order), and so do the decoded sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import wire as jw
from repro.models.api import build_model as jbuild
from repro_torch.convert import params_from_jax
from repro_torch.distributed import wire as tw
from repro_torch.tree import tree_leaves
from test_torch_families import one_torch_thread  # noqa: F401

N = 4
MIXED_SPEC = "adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4"
SPECS = [MIXED_SPEC,
         "adaptive:4096:small=fp16:large=quant:4",
         "adaptive:8192:large=sparse:0.25:topk:leaf.embed*=quant:bits=3,block=1024",
         "adaptive:0:large=lowrank:2:warm:leaf.blocks/attn/*=sign:leaf.lm_head=fp16",
         "adaptive:1000000:small=quant:3:256:leaf.*ln*=identity",
         "adaptive:threshold=600:small=identity:large=sign:l2:256"]


@pytest.fixture(scope="module")
def trees():
    cfg = jget_config("granite-3-2b").reduced()
    params = jbuild(cfg).init(jax.random.key(0))
    jtree = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (N,) + p.shape) * 1.0, params)
    ttree = params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")
    return jtree, ttree


def _leaf_wires(jwire, jtree):
    return [(path, jw.wire_spec(sub)) for path, sub in jwire.leaf_wires(jtree)]


@pytest.mark.parametrize("spec", SPECS)
def test_routing_matches_jax_leaf_for_leaf(spec, trees):
    jtree, ttree = trees
    jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
    want = _leaf_wires(jwire, jtree)
    got = [(path, tw.wire_spec(sub)) for path, sub in twire.leaf_wires(ttree)]
    assert got == want
    assert len(got) == 12
    # the port's paths are the JAX package's leaf_path_str of each key path
    jpaths = [jw.leaf_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [tw.leaf_path_str(p.split("/")) for p, _ in got] == jpaths


def test_mixed_spec_routes_embed_quant_norms_fp16_matrices_lowrank(trees):
    _, ttree = trees
    routed = {p: tw.wire_spec(w) for p, w in tw.make_wire_format(MIXED_SPEC).leaf_wires(ttree)}
    assert routed.pop("embed") == "quant:4:1024"
    assert {routed.pop(k) for k in ("final_ln", "blocks/ln1", "blocks/ln2")} == {"fp16"}
    assert set(routed.values()) == {"lowrank:2"} and len(routed) == 8


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_round_trips_match_jax(spec):
    jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
    assert tw.wire_spec(twire) == jw.wire_spec(jwire)
    assert tw.make_wire_format(tw.wire_spec(twire)) == twire
    assert twire.wire_format == jwire.wire_format and twire.packed == jwire.packed
    assert twire.threshold == jwire.threshold
    assert [p for p, _ in twire.overrides] == [p for p, _ in jwire.overrides]
    assert not twire.stateful and twire.init_aux({"a": torch.zeros((4, 8, 128))}) == {}
    for shape in (None, (4, 64), (4, 256, 512), (4, 1, 256), (7,)):
        assert twire.wire_bits_per_element(shape) == jwire.wire_bits_per_element(shape)


@pytest.mark.parametrize("spec", ["adaptive:4096:large=adaptive:10",
                                  "adaptive:4096:leaf.embed=adaptive:1:small=fp16",
                                  "adaptive:-1", "adaptive:4096:77"])
def test_refusals_match_jax(spec):
    with pytest.raises((AssertionError, ValueError)):
        jw.make_wire_format(spec)
    with pytest.raises(ValueError):
        tw.make_wire_format(spec)


@pytest.mark.parametrize("spec", SPECS)
def test_wire_nbytes_matches_jax(spec, trees):
    jtree, ttree = trees
    jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
    assert twire.wire_nbytes(ttree) == jwire.wire_nbytes(jtree)


def test_tree_encode_and_receive_match_jax(trees):
    """One tree-level encode through the routed sub-formats and one
    decode-axpy of it, against the JAX wire's eager tree methods."""
    jtree, ttree = trees
    jwire, twire = jw.make_wire_format(MIXED_SPEC), tw.make_wire_format(MIXED_SPEC)
    rng = np.random.default_rng(13)
    delta = jax.tree.map(lambda l: rng.standard_normal(l.shape).astype(np.float32) * 0.01,
                         jtree)
    jdelta = jax.tree.map(jnp.asarray, delta)
    tdelta = params_from_jax(delta, "cpu")
    jdef, jpay = jwire.encode_tree(jdelta, jnp.int32(7), 4)
    paths, tpay = twire.encode_tree(tdelta, 7, 4)
    for path, jp, tp, (_, sub) in zip(paths, jpay, tpay, twire.leaf_wires(ttree)):
        assert sorted(jp) == sorted(tp), path
        for key in tp:
            want = np.asarray(jp[key])
            got = tp[key].numpy()
            if isinstance(sub, tw.LowRankWire):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=path)
            else:
                np.testing.assert_array_equal(got.view(want.dtype) if got.dtype == np.int32
                                              and want.dtype == np.uint32 else got, want,
                                              err_msg=path)
    jpay_t = [{k: torch.from_numpy(np.array(v).view(np.int32) if v.dtype == jnp.uint32
                                   else np.array(v)) for k, v in p.items()} for p in jpay]
    want = jwire.decode_axpy_tree(jdef, jpay, jtree, 0.5, 1.0)
    got = twire.decode_axpy_tree(paths, jpay_t, ttree, 0.5, 1.0)
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
