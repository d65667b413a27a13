"""K3, K4a, K4b and K6b's plain versions and ``kernels/ops.py`` held against
the JAX package on the CPU.

The Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them, where each op rounds on its own: codes, words, scales and floats are
bit-equal there.  ``repro.kernels.ops`` is jitted, and XLA may fuse its f32
arithmetic: floats against it agree to atol 1e-6, integer containers
bit-equal.  The ops take the seed that the JAX side draws from its key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _inputs(rows: int, cols: int, seed: int) -> np.ndarray:
    """Random rows with an all-zero row, -0.0 entries and a row whose max is
    hit with both signs."""
    x = np.random.default_rng(seed).standard_normal((rows, cols)).astype(np.float32)
    x[0] = 0.0
    x[1, :5] = -0.0
    x[2, 7], x[2, 9] = 2.5, -2.5
    return x


def _same_bits(a: np.ndarray, b: np.ndarray) -> None:
    """Equal bit patterns (so +0.0 and -0.0 differ), any NaN matching any NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype
    nan = np.isnan(a) & np.isnan(b)
    np.testing.assert_array_equal(a.view(np.int32)[~nan], b.view(np.int32)[~nan])


@pytest.mark.parametrize("bits", [2, 4, 5, 8])
def test_quantize_2d_plain_bit_equal_to_pallas(bits):
    """K3's plain version: int8 codes and scales, and a row holding a NaN
    (NaN scale; the NaN element's own code is implementation-defined)."""
    x = _inputs(13, 256, seed=bits)
    x[4, 30] = np.nan
    seed = 0xC0DE ^ bits
    jc, js = jq.quantize_2d(jnp.asarray(x), jnp.asarray([seed], jnp.uint32), bits=bits,
                            interpret=True)
    tc, ts = tq.quantize_2d(torch.from_numpy(x), seed, bits=bits)
    assert tc.dtype == torch.int8
    keep = np.ones(x.shape, bool)
    keep[4, 30] = False
    np.testing.assert_array_equal(tc.numpy()[keep], np.asarray(jc)[keep])
    _same_bits(ts.numpy(), np.asarray(js))
    assert np.isnan(ts.numpy()[4, 0])


@pytest.mark.parametrize("bits", [3, 8])
@pytest.mark.parametrize("cols", [32, 96, 256])
def test_dequantize_2d_plain_bit_equal_to_pallas(bits, cols):
    """K4a's plain version at any width, with a NaN and a zero scale."""
    x = _inputs(11, cols, seed=cols)
    codes, scale = tref.quantize_2d_ref(torch.from_numpy(x), 3, bits=bits)
    scale[3] = float("nan")
    scale[4] = 0.0
    jo = jq.dequantize_2d(jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy()), bits=bits,
                          interpret=True)
    _same_bits(tq.dequantize_2d(codes, scale, bits=bits).numpy(), np.asarray(jo))


@pytest.mark.parametrize("bits,cols", [(2, 128), (3, 96), (4, 32), (4, 256), (5, 128),
                                       (6, 256), (7, 224)])
def test_unpack_dequant_2d_plain_bit_equal_to_pallas(bits, cols):
    """K4b's plain version at any whole number of stream groups (block 32 at
    4 bits is the quickstart's), words from the interpret-mode K1 head."""
    x = _inputs(9, cols, seed=bits * cols)
    words, scale = tref.quantize_pack_2d_ref(torch.from_numpy(x), 11, bits=bits)
    scale[5] = float("nan")
    jo = jq.unpack_dequant_2d(jnp.asarray(_u32(words)), jnp.asarray(scale.numpy()), bits=bits,
                              interpret=True)
    _same_bits(tq.unpack_dequant_2d(words, scale, bits=bits).numpy(), np.asarray(jo))


@pytest.mark.parametrize("mode,p,value_dtype", [
    ("randk", 0.25, torch.float32), ("randk", 0.25, torch.float16),
    ("topk", 0.05, torch.float16), ("topk", 0.25, torch.float32),
    ("randk", 1.0, torch.float32)])
def test_sparse_unpack_scatter_2d_plain_bit_equal_to_pallas(mode, p, value_dtype):
    """K6b's plain version: the values added into zeros, so the kept -0.0 of
    an all -0.0 row decodes to +0.0 in both; a NaN stays NaN."""
    x = _inputs(10, 128, seed=17)
    x[3] = -0.0
    x[5, 2] = np.nan
    vals, idx = tref.sparse_select_pack_2d_ref(torch.from_numpy(x), 41, p=p, mode=mode,
                                               value_dtype=value_dtype)
    jvals = jnp.asarray(vals.numpy())
    jo = np.asarray(jq.sparse_unpack_scatter_2d(jvals, jnp.asarray(_u32(idx)), cols=128,
                                                interpret=True))
    to = tq.sparse_unpack_scatter_2d(vals, idx, cols=128).numpy()
    _same_bits(to, jo)
    assert not np.signbit(to[3]).any()


SHAPES = [(5, 7, 33), (1000,), (3, 300), ()]


def _seed_of(key) -> int:
    return int(jax.random.bits(key, (1,), dtype=jnp.uint32)[0])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bits", [3, 8])
def test_ops_quantize_and_dequantize_match_jax(shape, bits):
    key = jax.random.key(bits * 7 + len(shape))
    x = np.random.default_rng(bits).standard_normal(shape).astype(np.float32)
    jp = jops.quantize(key, jnp.asarray(x), bits=bits, block_size=128)
    tp = tops.quantize(_seed_of(key), torch.from_numpy(x), bits=bits, block_size=128)
    jc = np.asarray(jp["codes"])
    tc = _u32(tp["codes"]) if bits < 8 else tp["codes"].numpy()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(jp["scale"]))
    assert tops.payload_nbytes(tp) == jops.payload_nbytes(jp)
    jd = jops.dequantize(jp, bits=bits, shape=shape)
    td = tops.dequantize(tp, bits=bits, shape=shape)
    assert td.shape == shape and td.dtype == torch.float32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    acc = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ja = jops.dequant_axpy(jp, jnp.asarray(acc), bits=bits, weight=0.5)
    ta = tops.dequant_axpy(tp, torch.from_numpy(acc), bits=bits, weight=0.5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
@pytest.mark.parametrize("mode,p,block,value_dtype", [("randk", 0.25, 128, "float32"),
                                                      ("topk", 0.05, 256, "float16")])
def test_ops_sparse_compress_and_decompress_match_jax(shape, mode, p, block, value_dtype):
    key = jax.random.key(len(shape) + block)
    x = np.random.default_rng(block).standard_normal(shape).astype(np.float32)
    jp = jops.sparse_compress(key, jnp.asarray(x), p=p, block_size=block, mode=mode,
                              value_dtype=getattr(jnp, value_dtype))
    tp = tops.sparse_compress(_seed_of(key), torch.from_numpy(x), p=p, block_size=block,
                              mode=mode, value_dtype=getattr(torch, value_dtype))
    np.testing.assert_array_equal(_u32(tp["idx"]), np.asarray(jp["idx"]))
    np.testing.assert_array_equal(tp["values"].numpy(), np.asarray(jp["values"]))
    assert tops.payload_nbytes(tp) == jops.payload_nbytes(jp)
    jd = jops.sparse_decompress(jp, block_size=block, shape=shape)
    td = tops.sparse_decompress(tp, block_size=block, shape=shape)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    acc = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    ja = jops.sparse_axpy(jp, jnp.asarray(acc), block_size=block, weight=-1.5)
    ta = tops.sparse_axpy(tp, torch.from_numpy(acc), block_size=block, weight=-1.5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)


def test_ops_refuse_blocks_off_the_lane_contract():
    with pytest.raises(ValueError, match="multiple of 128"):
        tops.quantize(1, torch.zeros(64), block_size=96)
    with pytest.raises(ValueError, match="multiple of 128"):
        tops.sparse_compress(1, torch.zeros(64), block_size=32)
    with pytest.raises(ValueError, match="packable"):
        tops.quantize(1, torch.zeros(64), bits=8, block_size=128, pack=True)
