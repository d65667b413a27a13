"""The port's wires against the JAX package's, on the CPU.

Stacked (n, ...) leaves with ragged last dims, made with numpy from a seed:
payload words, indices, values and scales must be bit-equal for the same
(step, salt, leaf) counter, on and off the 128-lane kernel gate, and decodes
must agree.  The sign, sparse, fp16 and identity payloads and decodes are
held to the JAX wires in ``test_torch_ef_wire.py``; their specs and measured
bits are here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import wire as jw
from repro_torch.distributed import wire as tw


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _assert_payload_equal(tp: dict, jp: dict) -> None:
    assert tp["codes"].shape == tuple(jp["codes"].shape)
    codes = np.asarray(jp["codes"])
    got = _u32(tp["codes"]) if codes.dtype == np.uint32 else tp["codes"].numpy()
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(jp["scale"]))


LEAF_SHAPES = [(4, 300), (4, 3, 1000), (8, 2, 256), (4, 40)]


@pytest.mark.parametrize("bits,block", [(4, 1024), (3, 256), (7, 128), (5, 32), (8, 128)])
def test_quant_wire_payloads_bit_equal(bits, block):
    """Stacked leaves with ragged last dims; block 32 and the 40-wide leaf sit
    off the kernel gate (plain encode), 8 bits is the int8 container."""
    rng = np.random.default_rng(bits * 1000 + block)
    jwire, twire = jw.QuantWire(bits=bits, block=block), tw.QuantWire(bits=bits, block=block)
    tree = {f"l{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(LEAF_SHAPES)}
    step, salt = 7, 2

    @jax.jit
    def jax_side(t):
        tdef, payloads = jwire.encode_tree(t, jnp.int32(step), salt)
        return payloads, jax.tree_util.tree_leaves(jwire.decode_tree(tdef, payloads, t))

    jps, jdecs = jax_side({k: jnp.asarray(v) for k, v in tree.items()})
    _, tps = twire.encode_tree({k: torch.from_numpy(v) for k, v in tree.items()}, step, salt)
    for tp, jp in zip(tps, jps):
        _assert_payload_equal(tp, jp)
    for (k, leaf), tp, jd in zip(sorted(tree.items()), tps, jdecs):
        np.testing.assert_array_equal(twire.decode(tp, torch.from_numpy(leaf)).numpy(),
                                      np.asarray(jd))


@pytest.mark.parametrize("bits,block,weight,acc_weight", [
    (4, 1024, 1.0, 1.0), (3, 128, 2.0, -1.0), (4, 32, 2.0, -1.0), (8, 256, 1.0, 1.0)])
def test_quant_wire_decode_axpy_matches_jax(bits, block, weight, acc_weight):
    """Fused receive (K2's plain version behind the gate) and the off-gate
    decode-then-axpy agree bit for bit with the JAX wire run eagerly; the
    port updates in place.  (Under ``jax.jit`` XLA's CPU backend contracts
    ``aw*acc + code*inv`` into an FMA and moves the last bits, so the JAX
    decode is deliberately not jitted here.)"""
    rng = np.random.default_rng(bits + block)
    leaf = rng.standard_normal((4, 3, 300)).astype(np.float32)
    acc = rng.standard_normal((4, 3, 300)).astype(np.float32)
    jwire, twire = jw.QuantWire(bits=bits, block=block), tw.QuantWire(bits=bits, block=block)
    jp = jax.jit(lambda x: jwire.encode(x, jnp.uint32(99)))(jnp.asarray(leaf))
    tp = twire.encode(torch.from_numpy(leaf), 99)
    _assert_payload_equal(tp, jp)
    want = np.asarray(jwire.decode_axpy(jp, jnp.asarray(acc), weight, acc_weight))
    acc_t = torch.from_numpy(acc.copy())
    got = twire.decode_axpy_(tp, acc_t, weight, acc_weight)
    assert got is acc_t
    np.testing.assert_array_equal(got.numpy(), want)


def test_leaf_seed_and_block_counters_match_jax():
    for step in (0, 1, 7, 2**31 + 5):
        for salt in (2, 3):
            for li in (0, 11):
                assert tw.leaf_seed(step, salt, li) == int(jw.leaf_seed(jnp.uint32(step), salt, li))
    shape = (3, 5, 128)
    got = tw._block_counters(shape, "cpu").numpy()
    want = np.asarray(jw._block_counters(jnp.zeros(shape)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # the 2-D fold's counter row*cols + lane is the same flat index
    from repro_torch.kernels.ref import block_counters_2d
    np.testing.assert_array_equal(block_counters_2d(15, 128, "cpu").numpy(), got.reshape(15, 128))


@pytest.mark.parametrize("spec", ["quant:4", "quant:3:256", "quant:8", "quant:bits=2,block=128",
                                  "quant:4:32", "sign", "sign:l2:256", "sparse:0.25",
                                  "sparse:0.05:topk", "sparse:0.25:randk:128:value_dtype=float16",
                                  "fp16", "identity"])
def test_wire_spec_and_measured_bits_match_jax(spec):
    jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
    assert tw.wire_spec(twire) == jw.wire_spec(jwire)
    assert tw.make_wire_format(tw.wire_spec(twire)) == twire
    assert twire.packed == jwire.packed and twire.wire_format == jwire.wire_format
    for shape in (None, (1000,), (3, 517)):
        assert twire.wire_bits_per_element(shape) == jwire.wire_bits_per_element(shape)


def test_unported_specs_raise():
    # lowrank is ported: its spec parses and round-trips like the JAX package's
    assert tw.wire_spec(tw.make_wire_format("lowrank:2")) == "lowrank:2"
    assert tw.make_wire_format("lowrank:2") == tw.LowRankWire(rank=2)
    with pytest.raises(ValueError):
        tw.make_wire_format("quant:4:1024:9")


def test_wire_rejects_bad_args():
    for spec in ("sign:max", "sign:mean:100", "sparse:0", "sparse:0.5:best",
                 "sparse:0.5:topk:128:value_dtype=bfloat16"):
        with pytest.raises(ValueError):
            tw.make_wire_format(spec)
