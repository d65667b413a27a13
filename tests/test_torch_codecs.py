"""The sign and sparse codecs of the port against the JAX package, on the CPU.

Kernel level: the plain versions of K5a (sign-pack), K5b (unpack-sign-axpy),
K6 (sparse select-pack) and K6c (sparse scatter-axpy) against the JAX
package's Pallas kernels in interpret mode (as tests/test_kernels.py runs
them) and its ``kernels/ref.py`` oracles.  Inputs are numpy-seeded rows plus
the edge cases: an all-zero row, -0.0 entries, a NaN, exact ties of both
signs.  Sign words, sparse values and index words are bit-equal; sign scales
agree to rtol 1e-5, because the port sums them in its CUDA kernel's fixed
order and ``jnp.mean`` in another (the test prints the worst relative
difference, measured 1.8e-7 at most; ``pytest -s`` shows it); given
the same payload, the receive kernels' outputs are bit-equal.  Words are
compared as uint32 (the port carries them in int32 containers).  The wires
built on these kernels are held to the JAX wires in ``test_torch_wire.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro.kernels import ref as jref
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref

SIGN_SCALE_RTOL = 1e-5
AXPY_WEIGHTS = [(1.0, 1.0), (1.0, -1.0), (0.5, 1.0 / 3.0)]   # (acc_weight, weight)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _inputs(rows: int, cols: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    x[0] = 0.0
    x[1, :9] = -0.0
    x[2, 5] = np.nan
    x[3] = 0.75
    x[3, 1::2] = -0.75
    x[4, 10:40] = 1.25           # ties inside a random row
    return x


# ------------------------------------------------------------------ kernels

@pytest.mark.parametrize("scale_mode", ["mean", "l2"])
@pytest.mark.parametrize("cols", [128, 384, 1024])
def test_sign_pack_plain_matches_pallas_and_oracle(scale_mode, cols):
    x = _inputs(13, cols, seed=cols)
    jw_, js = jq.sign_pack_2d(jnp.asarray(x), scale_mode=scale_mode, interpret=True)
    ow, os_ = jref.sign_pack_2d_ref(jnp.asarray(x), scale_mode=scale_mode)
    tw_, ts = tq.sign_pack_2d(torch.from_numpy(x), scale_mode=scale_mode)
    assert tw_.dtype == torch.int32 and tw_.shape == (13, cols // 32) and ts.shape == (13, 1)
    np.testing.assert_array_equal(_u32(tw_), np.asarray(jw_))
    np.testing.assert_array_equal(_u32(tw_), np.asarray(ow))
    for want in (js, os_):
        np.testing.assert_allclose(ts.numpy(), np.asarray(want), rtol=SIGN_SCALE_RTOL, atol=0)
    finite = np.isfinite(np.asarray(js)) & (np.asarray(js) != 0)
    worst = np.max(np.abs(ts.numpy()[finite] / np.asarray(js)[finite] - 1.0))
    print(f"sign scale {scale_mode} cols={cols}: worst relative difference to JAX {worst:.3e}")
    assert np.isnan(ts.numpy()[2, 0]) and ts.numpy()[0, 0] == 0.0


@pytest.mark.parametrize("acc_weight,weight", AXPY_WEIGHTS)
def test_unpack_sign_axpy_plain_bit_equal_to_pallas(acc_weight, weight):
    """Same words and scales (the JAX oracle's) in both: outputs bit-equal."""
    x = _inputs(11, 256, seed=1)
    acc = np.random.default_rng(2).standard_normal((11, 256)).astype(np.float32)
    jw_, js = jref.sign_pack_2d_ref(jnp.asarray(x))
    jo = jq.unpack_sign_axpy_2d(jw_, js, jnp.asarray(acc), weight=weight,
                                acc_weight=acc_weight, interpret=True)
    oo = jref.unpack_sign_axpy_2d_ref(jw_, js, jnp.asarray(acc), weight=weight,
                                      acc_weight=acc_weight)
    words = torch.from_numpy(np.asarray(jw_).view(np.int32).copy())
    to = tq.unpack_sign_axpy_2d(words, torch.from_numpy(np.asarray(js).copy()),
                                torch.from_numpy(acc), weight=weight, acc_weight=acc_weight)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy(), np.asarray(oo))


@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("p", [0.05, 0.25])
@pytest.mark.parametrize("value_dtype", ["float32", "float16"])
def test_sparse_select_pack_plain_bit_equal_to_pallas(mode, p, value_dtype):
    """Canonical order (descending key, ties to the smaller index, NaN last,
    -0.0 tying +0.0), gathered values and packed index words."""
    rows, cols = 13, 128
    x = _inputs(rows, cols, seed=int(p * 100))
    seed = 0xBEEF ^ int(p * 100)
    jdt, tdt = getattr(jnp, value_dtype), getattr(torch, value_dtype)
    jv, ji = jq.sparse_select_pack_2d(jnp.asarray(x), jnp.asarray([seed], jnp.uint32), p=p,
                                      mode=mode, value_dtype=jdt, interpret=True)
    ov, oi = jref.sparse_select_pack_2d_ref(jnp.asarray(x), jnp.uint32(seed), p=p, mode=mode,
                                            value_dtype=jdt)
    tv, ti = tq.sparse_select_pack_2d(torch.from_numpy(x), seed, p=p, mode=mode,
                                      value_dtype=tdt)
    k, _, _, words = tref.sparse_geometry(cols, p)
    assert tv.dtype == tdt and tv.shape == (rows, k)
    assert ti.dtype == torch.int32 and ti.shape == (rows, words)
    for want_v, want_i in ((jv, ji), (ov, oi)):
        np.testing.assert_array_equal(_u32(ti), np.asarray(want_i))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("value_dtype", ["float32", "float16"])
@pytest.mark.parametrize("acc_weight,weight", AXPY_WEIGHTS)
def test_sparse_scatter_axpy_plain_bit_equal_to_pallas(value_dtype, acc_weight, weight):
    """Same values and index words (the JAX oracle's) in both: outputs
    bit-equal (up to the sign of a zero, which the comparison does not see)."""
    x = _inputs(11, 256, seed=4)
    acc = np.random.default_rng(5).standard_normal((11, 256)).astype(np.float32)
    jv, ji = jref.sparse_select_pack_2d_ref(jnp.asarray(x), jnp.uint32(3), p=0.25, mode="topk",
                                            value_dtype=getattr(jnp, value_dtype))
    jo = jq.sparse_scatter_axpy_2d(jv, ji, jnp.asarray(acc), weight=weight,
                                   acc_weight=acc_weight, interpret=True)
    oo = jref.sparse_scatter_axpy_2d_ref(jv, ji, jnp.asarray(acc), k=jv.shape[1], weight=weight,
                                         acc_weight=acc_weight)
    to = tq.sparse_scatter_axpy_2d(torch.from_numpy(np.asarray(jv).copy()),
                                   torch.from_numpy(np.asarray(ji).view(np.int32).copy()),
                                   torch.from_numpy(acc), weight=weight, acc_weight=acc_weight)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy(), np.asarray(oo))


def test_sparse_geometry_and_index_stream_match_jax():
    for block in (1, 2, 96, 127, 128, 129, 384, 1000, 1024, 4096):
        assert tref.idx_bits_for(block) == jq.idx_bits_for(block)
        for p in (0.01, 0.05, 0.25, 0.5, 1.0):
            assert tref.sparse_geometry(block, p) == jq.sparse_geometry(block, p)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(384)[:20] for _ in range(3)]).astype(np.uint32)
    k, _, kpad, _ = tref.sparse_geometry(384, 0.05)
    jpk = np.asarray(jref.sparse_pack_idx(jnp.asarray(idx), block=384, kpad=kpad))
    tpk = tref.sparse_pack_idx(torch.from_numpy(idx.astype(np.int64)), block=384, kpad=kpad)
    np.testing.assert_array_equal(_u32(tpk), jpk)
    np.testing.assert_array_equal(tref.sparse_unpack_idx(tpk, block=384, k=k).numpy(), idx)


def test_new_wrappers_check_inputs():
    x = torch.zeros((4, 256))
    with pytest.raises(ValueError):
        tq.sign_pack_2d(torch.zeros((4, 96)))                  # off the 128-lane contract
    with pytest.raises(ValueError):
        tq.sign_pack_2d(x, scale_mode="max")
    with pytest.raises(ValueError):
        tq.sparse_select_pack_2d(torch.zeros((4, 200)), 1, p=0.1, mode="topk")    # off 128
    wide = torch.from_numpy(_inputs(5, 16384, seed=8))     # wider than the kernels: plain
    for got, want in zip(tq.sparse_select_pack_2d(wide, 1, p=0.01, mode="topk"),
                         tref.sparse_select_pack_2d_ref(wide, 1, p=0.01, mode="topk")):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        tq.sparse_select_pack_2d(x, 1, p=0.0, mode="topk")
    with pytest.raises(TypeError):
        tq.sparse_select_pack_2d(x, 1, p=0.1, mode="topk", value_dtype=torch.bfloat16)
    vals, idx = tq.sparse_select_pack_2d(x, 1, p=0.25, mode="randk")
    with pytest.raises(ValueError):
        tq.sparse_scatter_axpy_2d(vals, idx[:, :-1].contiguous(), x, weight=1.0)
    words, scale = tq.sign_pack_2d(x)
    with pytest.raises(ValueError):
        tq.unpack_sign_axpy_2d(words, scale, torch.zeros((4, 128)), weight=1.0)
    with pytest.raises(ValueError):
        tq.sign_pack_2d(torch.empty((4, 256), device="meta"))


def test_new_axpys_in_place_equal_out_of_place():
    x = torch.from_numpy(_inputs(8, 128, seed=6))
    acc = torch.from_numpy(np.random.default_rng(7).standard_normal((8, 128)).astype(np.float32))
    words, scale = tq.sign_pack_2d(x, scale_mode="l2")
    vals, idx = tq.sparse_select_pack_2d(x, 9, p=0.05, mode="randk")
    for fn, args in ((tq.unpack_sign_axpy_2d, (words, scale)),
                     (tq.sparse_scatter_axpy_2d, (vals, idx))):
        a = acc.clone()
        want = fn(*args, a, weight=2.0, acc_weight=-1.0)
        got = fn(*args, a, weight=2.0, acc_weight=-1.0, out=a)
        assert got is a
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
