"""The port's plain kernel versions held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
Words are compared as uint32 (the port carries them in int32 containers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.wire import QuantWire as JaxQuantWire
from repro.kernels import quant as jq
from repro.kernels import ref as jref
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _inputs(rows: int, cols: int, seed: int) -> np.ndarray:
    """Random rows plus the edge cases: an all-zero row, -0.0 entries, a row
    whose max is hit with both signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    x[0] = 0.0
    x[1, :5] = -0.0
    x[2, 7], x[2, 9] = 2.5, -2.5
    return x


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
def test_quantize_pack_plain_bit_equal_to_pallas(bits):
    """K1's plain version: words and scales bit-equal to the interpret-mode
    Pallas kernel, on rows that are not a multiple of 8."""
    rows, cols = 13, 256
    x = _inputs(rows, cols, seed=bits * 100 + rows)
    seed = 0xDEADBEEF ^ bits
    jw, js = jq.quantize_pack_2d(jnp.asarray(x), jnp.asarray([seed], jnp.uint32),
                                 bits=bits, interpret=True)
    tw, ts = tq.quantize_pack_2d(torch.from_numpy(x), seed, bits=bits)
    assert tw.dtype == torch.int32 and tw.shape == (rows, cols * bits // 32)
    np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
def test_quantize_pack_plain_matches_quant_wire_encode(bits):
    """The 2-D fold of K1's plain version gives the JAX runtime's encode words:
    counter ``row*cols + lane`` is the flat index of the blocked view."""
    x = _inputs(24, 256, seed=bits).reshape(3, 8, 256)
    wire = JaxQuantWire(bits=bits, block=128)
    seed = 12345 + bits
    payload = jax.jit(lambda a: wire.encode(a, jnp.uint32(seed)))(jnp.asarray(x))
    tw, ts = tq.quantize_pack_2d(torch.from_numpy(x.reshape(-1, 128)), seed, bits=bits)
    np.testing.assert_array_equal(_u32(tw), np.asarray(payload["codes"]).reshape(-1, tw.shape[1]))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(payload["scale"]).reshape(-1, 1))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0 / 3.0), (-1.0, 2.0)])
def test_unpack_dequant_axpy_plain_bit_equal_to_pallas(bits, acc_weight, weight):
    """K2's plain version against the interpret-mode Pallas kernel with the
    kernel's association ``aw*acc + code*(scale*(w*(1/L)))``.  Bit-equal:
    interpret mode runs the kernel body op by op, every product and the sum
    a separately rounded f32 operation, as in the plain version (under
    ``jax.jit`` XLA would contract to an FMA; see test_torch_wire.py)."""
    rows, cols = 11, 256
    x = _inputs(rows, cols, seed=bits)
    acc = np.random.default_rng(bits + 7).standard_normal((rows, cols)).astype(np.float32)
    tw, ts = tq.quantize_pack_2d(torch.from_numpy(x), 77, bits=bits)   # = JAX's words (above)
    jo = jq.unpack_dequant_axpy_2d(jnp.asarray(_u32(tw)), jnp.asarray(ts.numpy()),
                                   jnp.asarray(acc), bits=bits, weight=weight,
                                   acc_weight=acc_weight, interpret=True)
    to = tq.unpack_dequant_axpy_2d(tw, ts, torch.from_numpy(acc), bits=bits, weight=weight,
                                   acc_weight=acc_weight)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("bits", [1, 3, 5, 11, 16])
def test_pack_uint_roundtrip_matches_jax(bits):
    cpg, _ = tref.stream_geometry(bits)
    u = np.random.default_rng(bits).integers(0, 1 << bits, size=(3, 4 * cpg), dtype=np.uint32)
    jw = np.asarray(jref.pack_uint(jnp.asarray(u), bits=bits))
    tw = tref.pack_uint(torch.from_numpy(u.astype(np.int64)), bits=bits)
    np.testing.assert_array_equal(_u32(tw), jw)
    np.testing.assert_array_equal(tref.unpack_uint(tw, bits=bits).numpy(), u.astype(np.int64))


def test_pcg_hash_matches_jax():
    x = np.array([0, 1, 2, 0xFFFFFFFF, 0x80000000, 123456789], dtype=np.uint32)
    want = np.asarray(jq.pcg_hash(jnp.asarray(x)))
    got = tref.pcg_hash(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_packing_geometry_helpers_match_jax():
    for bits in range(2, 8):
        assert tref.stream_geometry(bits) == jq.stream_geometry(bits)
        for block in (32, 96, 128, 1000, 1024):
            assert tref.packed_auto(bits, block) == jref.packed_auto(bits, block)
            for n in (1, 7, 100, 512, 49408):
                assert tref.aligned_block(block, n, bits=bits) == \
                    jref.aligned_block(block, n, bits=bits)


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    x = torch.zeros((4, 256))
    tq.reset_launch_counts()
    words, scale = tq.quantize_pack_2d(x, 1, bits=4)
    tq.unpack_dequant_axpy_2d(words, scale, x, bits=4, weight=1.0)
    signs, sign_scale = tq.sign_pack_2d(x)
    tq.unpack_sign_axpy_2d(signs, sign_scale, x, weight=1.0)
    vals, idx = tq.sparse_select_pack_2d(x, 1, p=0.25, mode="topk")
    tq.sparse_scatter_axpy_2d(vals, idx, x, weight=1.0)
    p = tq.lowrank_project_2d(x, torch.zeros((256, 2)))
    tq.lowrank_axpy_2d(p, torch.zeros((256, 2)), x, weight=1.0)
    codes, scale8 = tq.quantize_2d(x, 1, bits=8)
    tq.dequantize_2d(codes, scale8, bits=8)
    tq.unpack_dequant_2d(words, scale, bits=4)
    tq.sparse_unpack_scatter_2d(vals, idx, cols=256)
    xb = x.to(torch.bfloat16)                                     # the bf16-accumulator receives
    tq.unpack_dequant_axpy_2d(words, scale, xb, bits=4, weight=1.0)
    tq.unpack_sign_axpy_2d(signs, sign_scale, xb, weight=1.0)
    tq.sparse_scatter_axpy_2d(vals, idx, xb, weight=1.0)
    tq.lowrank_axpy_2d(p, torch.zeros((256, 2)), xb, weight=1.0)
    tq.markov_walk(torch.zeros((2, 1), dtype=torch.int64), vocab=7, length=3, seed=1,
                   concentration=0.3)                             # the data's Markov walk
    tq.adamw_update(x, torch.zeros_like(x), torch.zeros_like(x), x, b1=0.9, b2=0.95, eps=1e-8,
                    weight_decay=0.01, lr=1e-3, t=1)              # the optim layer's AdamW
    assert tq.launch_counts() == {"quantize_pack_2d": 0, "unpack_dequant_axpy_2d": 0,
                                  "quantize_2d": 0, "dequantize_2d": 0,
                                  "unpack_dequant_2d": 0,
                                  "sign_pack_2d": 0, "unpack_sign_axpy_2d": 0,
                                  "sparse_select_pack_2d": 0, "sparse_unpack_scatter_2d": 0,
                                  "sparse_scatter_axpy_2d": 0,
                                  "lowrank_project_2d": 0, "lowrank_axpy_2d": 0,
                                  "unpack_dequant_axpy_2d_bf16": 0,
                                  "unpack_sign_axpy_2d_bf16": 0,
                                  "sparse_scatter_axpy_2d_bf16": 0,
                                  "lowrank_axpy_2d_bf16": 0, "markov_walk": 0,
                                  "adamw_update": 0}
    for fn in tq.KERNEL_WRAPPERS:                                 # the counter is the wrapper's
        fn.launches = 3
    assert set(tq.launch_counts().values()) == {3}
    tq.reset_launch_counts()
    assert set(tq.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        tq.quantize_pack_2d(torch.zeros((4, 96)), 1, bits=4)        # off the 128-lane contract
    with pytest.raises(TypeError):
        tq.quantize_pack_2d(x.double(), 1, bits=4)
    with pytest.raises(ValueError):
        tq.quantize_pack_2d(torch.zeros((256, 4)).t(), 1, bits=4)   # not contiguous
    with pytest.raises(ValueError):
        tq.unpack_dequant_axpy_2d(words, scale, torch.zeros((4, 128)), bits=4, weight=1.0)
    with pytest.raises(ValueError):
        tq.quantize_pack_2d(torch.empty((4, 256), device="meta"), 1, bits=4)


def test_in_place_axpy_equals_out_of_place():
    x = torch.from_numpy(_inputs(8, 128, seed=3))
    words, scale = tq.quantize_pack_2d(x, 9, bits=3)
    acc = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 128)).astype(np.float32))
    want = tq.unpack_dequant_axpy_2d(words, scale, acc, bits=3, weight=2.0, acc_weight=-1.0)
    got = tq.unpack_dequant_axpy_2d(words, scale, acc, bits=3, weight=2.0, acc_weight=-1.0,
                                    out=acc)
    assert got is acc
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _division_sensitive_row(bits: int, seed: int, cols: int = 128) -> np.ndarray:
    """A row whose lane-1 code differs between ``x * (L / scale)`` and
    ``x * ((1 / scale) * L)``: the scale makes the two multipliers differ by
    an ulp, and lane 1's value puts its fraction between them at the
    row's hashed uniform."""
    levels = 2 ** (bits - 1) - 1
    u = tref.uniform_from_hash(torch.tensor([1]), seed).numpy()[0]
    for s in np.random.default_rng(0).uniform(0.5, 4.0, 200).astype(np.float32):
        m_div = np.float32(levels) / s
        m_rec = (np.float32(1) / s) * np.float32(levels)
        if m_div == m_rec:
            continue
        y = np.float32((levels - 1 + u) / m_div)
        for _ in range(200):
            vd, vr = y * m_div, y * m_rec
            if (u < vd - np.floor(vd)) != (u < vr - np.floor(vr)):
                x = np.zeros((1, cols), np.float32)
                x[0, 0], x[0, 1] = s, y
                return x
            y = np.nextafter(y, np.float32(10))
    raise AssertionError("no division-sensitive value found")


@pytest.mark.parametrize("bits", [3, 4])
def test_quantize_divides_like_jax_not_reciprocal(bits):
    """``L / scale`` is a true f32 division in the JAX package (and in K1,
    ``__fdiv_rn``); a reciprocal multiply flips a code on this row."""
    x = _division_sensitive_row(bits, seed=5)
    jw, _ = jq.quantize_pack_2d(jnp.asarray(x), jnp.asarray([5], jnp.uint32), bits=bits,
                                interpret=True)
    tw, _ = tq.quantize_pack_2d(torch.from_numpy(x), 5, bits=bits)
    np.testing.assert_array_equal(_u32(tw), np.asarray(jw))


def test_quantize_2d_plain_bit_equal_to_pallas_int8():
    """The unpacked plain quantizer (the 8-bit container's codes) against the
    interpret-mode ``quantize_2d``."""
    x = _inputs(13, 256, seed=8)
    jc, js = jq.quantize_2d(jnp.asarray(x), jnp.asarray([31], jnp.uint32), bits=8,
                            interpret=True)
    tc, ts = tref.quantize_2d_ref(torch.from_numpy(x), 31, bits=8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
