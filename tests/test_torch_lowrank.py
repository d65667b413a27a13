"""The port's low-rank (PowerGossip) wire against the JAX package's.

Kernel level: the plain versions of K7a (``lowrank_project_2d_ref``, the sum
over n in the CUDA kernel's fixed order) and K7b (``lowrank_axpy_2d_ref``,
the rank sum in k order) against the JAX Pallas kernels in interpret mode
and the JAX oracles, at ranks 1, 2, 4 and a ragged row count.  They are not
bit-equal to XLA's dot, which sums in its own order and may contract to an
FMA, so each comparison carries a tolerance scaled by the sum of the
magnitudes it adds: ``|port - jax| <= 1e-6 * (|M| @ |V|)`` for K7a and
``<= 1e-6 * (|aw*acc| + |w| * |P| @ |V|^T)`` for K7b (measured below 6e-8
and 4e-7 of those scales).  MGS is held to rtol 1e-5 on full-rank input.

Wire level: ``_factor_init`` and ``init_aux`` bit-equal; cold and warm
``encode`` / ``decode`` / ``decode_axpy`` and ``encode_tree_stateful``
against the JAX wire (eager) at rtol 1e-4, atol 1e-5 on full-rank inputs
(factors of a rank-deficient input may differ wholly while ``P @ V^T``
agrees, so factors are compared only where the input has full rank); the
fp16 fallthrough bit-equal; ``wire_bits_per_element`` equal; specs and
``wire_spec`` round-trips.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import wire as jw
from repro.kernels import ref as jref
from repro.kernels.lowrank import lowrank_axpy_2d, lowrank_project_2d
from repro_torch.distributed import wire as tw
from repro_torch.kernels import lowrank as tl
from repro_torch.kernels import ref as tref

PROJECT_RTOL = 1e-6       # of |M| @ |V|
AXPY_RTOL = 1e-6          # of |aw*acc| + |w| * |P| @ |V|^T
RTOL, ATOL = 1e-4, 1e-5   # the wire's factors and decoded values


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.mark.parametrize("rank", [1, 2, 4])
@pytest.mark.parametrize("rows,n", [(37, 256), (8, 384), (5, 100)])
def test_project_plain_version_matches_jax_kernel(rank, rows, n):
    rng = _rng("project", rank, rows, n)
    m = rng.standard_normal((rows, n)).astype(np.float32)
    v = rng.standard_normal((n, rank)).astype(np.float32)
    got = tl.lowrank_project_2d(torch.from_numpy(m), torch.from_numpy(v)).numpy()
    scale = np.abs(m) @ np.abs(v)
    for want in (lowrank_project_2d(jnp.asarray(m), jnp.asarray(v), interpret=True),
                 jref.lowrank_project_2d_ref(jnp.asarray(m), jnp.asarray(v))):
        assert np.all(np.abs(got - np.asarray(want)) <= PROJECT_RTOL * scale)


@pytest.mark.parametrize("rank", [1, 2, 4])
@pytest.mark.parametrize("rows,n", [(37, 256), (8, 384)])
def test_axpy_plain_version_matches_jax_kernel(rank, rows, n):
    rng = _rng("axpy", rank, rows, n)
    p = rng.standard_normal((rows, rank)).astype(np.float32)
    v = rng.standard_normal((n, rank)).astype(np.float32)
    acc = rng.standard_normal((rows, n)).astype(np.float32)
    aw, w = 0.9, 0.7
    got = tl.lowrank_axpy_2d(torch.from_numpy(p), torch.from_numpy(v), torch.from_numpy(acc),
                             weight=w, acc_weight=aw).numpy()
    scale = np.abs(aw * acc) + abs(w) * (np.abs(p) @ np.abs(v).T)
    for want in (lowrank_axpy_2d(jnp.asarray(p), jnp.asarray(v), jnp.asarray(acc), weight=w,
                                 acc_weight=aw, interpret=True),
                 jref.lowrank_axpy_2d_ref(jnp.asarray(p), jnp.asarray(v), jnp.asarray(acc),
                                          weight=w, acc_weight=aw)):
        assert np.all(np.abs(got - np.asarray(want)) <= AXPY_RTOL * scale)


def test_plain_versions_spell_out_the_kernel_order():
    """K7a: lane sums in k order, then the halving tree; K7b: the rank sum
    in k order, each product rounded — written out by hand in numpy f32."""
    rng = _rng("order")
    m = rng.standard_normal((3, 96)).astype(np.float32)
    v = rng.standard_normal((96, 2)).astype(np.float32)
    lanes = np.zeros((3, 32, 2), np.float32)
    for k in range(3):
        lanes = lanes + m[:, 32 * k:32 * k + 32, None] * v[None, 32 * k:32 * k + 32]
    for h in (16, 8, 4, 2, 1):
        lanes = lanes[:, :h] + lanes[:, h:2 * h]
    got = tref.lowrank_project_2d_ref(torch.from_numpy(m), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, lanes[:, 0])
    p = rng.standard_normal((3, 3)).astype(np.float32)
    w3 = rng.standard_normal((128, 3)).astype(np.float32)
    acc = rng.standard_normal((3, 128)).astype(np.float32)
    dot = p[:, None, 0] * w3[None, :, 0]
    for k in (1, 2):
        dot = dot + p[:, None, k] * w3[None, :, k]
    want = np.float32(0.5) * acc + np.float32(-2.0) * dot
    got = tref.lowrank_axpy_2d_ref(torch.from_numpy(p), torch.from_numpy(w3),
                                   torch.from_numpy(acc), weight=-2.0, acc_weight=0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_wrappers_take_shared_and_per_slab_factors():
    """A (batch, rows, n) call equals its slabs one by one, with the factor
    shared at batch stride 0 or one per slab; the wrappers check strides."""
    rng = _rng("batched")
    m = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal((256, 2)).astype(np.float32))
    vw = torch.from_numpy(rng.standard_normal((3, 256, 2)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32))
    for v in (v0.expand(3, 256, 2), vw):
        p = tl.lowrank_project_2d(m, v)
        out = tl.lowrank_axpy_2d(p, v, acc, weight=0.5, acc_weight=1.0)
        for b in range(3):
            assert torch.equal(p[b], tl.lowrank_project_2d(m[b], v[b]))
            assert torch.equal(out[b], tl.lowrank_axpy_2d(p[b], v[b], acc[b], weight=0.5))
    with pytest.raises(ValueError, match="rank"):
        tl.lowrank_project_2d(m, torch.zeros((3, 256, 129)))
    with pytest.raises(ValueError, match="n % 128"):
        tl.lowrank_axpy_2d(torch.zeros((5, 2)), torch.zeros((100, 2)), torch.zeros((5, 100)),
                           weight=1.0)
    with pytest.raises(TypeError):
        tl.lowrank_project_2d(m.double(), vw.double())
    before = (tl.lowrank_project_2d.launches, tl.lowrank_axpy_2d.launches)
    meta = tl.lowrank_project_2d(torch.empty((8, 64, 512), device="meta"),
                                 torch.empty((512, 4), device="meta").expand(8, 512, 4))
    assert meta.shape == (8, 64, 4) and meta.device.type == "meta"
    tl.lowrank_axpy_2d(meta, torch.empty((8, 512, 4), device="meta"),
                       torch.empty((8, 64, 512), device="meta"), weight=1.0)
    assert (tl.lowrank_project_2d.launches, tl.lowrank_axpy_2d.launches) == before


def test_orthonormalize_matches_jax():
    x = _rng("mgs").standard_normal((3, 50, 4)).astype(np.float32)
    got = tref.lowrank_orthonormalize_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.lowrank_orthonormalize_ref(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    # a degenerate column keeps its residual over eps: exactly zero for m = 1
    one = tref.lowrank_orthonormalize_ref(torch.tensor([[[3.0, 5.0]]])).numpy()
    np.testing.assert_array_equal(one, np.asarray(
        jref.lowrank_orthonormalize_ref(jnp.asarray([[[3.0, 5.0]]]))))
    assert one[0, 0, 1] == 0.0


@pytest.mark.parametrize("rank", [1, 3, 8])
def test_factor_init_and_init_aux_bit_equal(rank):
    jwire, twire = jw.LowRankWire(rank=rank, warm=True), tw.LowRankWire(rank=rank, warm=True)
    for n, seed in ((300, 0), (128, 0xDEADBEEF), (7, 12345)):
        np.testing.assert_array_equal(twire._factor_init(n, seed, "cpu").numpy(),
                                      np.asarray(jwire._factor_init(n, np.uint32(seed))))
    tree = {"a": np.zeros((4, 3, 64), np.float32), "b": np.zeros((4, 10), np.float32),
            "c": np.zeros((4, 2, 5, 256), np.float32)}
    jaux = jwire.init_aux(jax.tree.map(jnp.asarray, tree))
    taux = twire.init_aux({k: torch.from_numpy(v) for k, v in tree.items()})
    assert sorted(jaux) == sorted(taux) == ["0", "2"]
    for k in jaux:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    assert tw.LowRankWire(rank=rank).init_aux({"a": torch.zeros((4, 3, 64))}) == {}


def _leaf(seed, shape):
    return _rng("leaf", seed, shape).standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rank", [1, 2, 4])
@pytest.mark.parametrize("shape", [(4, 16, 128), (4, 2, 24, 256), (3, 12, 100)])
def test_cold_encode_decode_match_jax(rank, shape):
    jwire, twire = jw.LowRankWire(rank=rank), tw.LowRankWire(rank=rank)
    leaf, acc = _leaf(1, shape), _leaf(2, shape)
    seed = 0xC0FFEE ^ rank
    jp = jwire.encode(jnp.asarray(leaf), jnp.uint32(seed))
    tp = twire.encode(torch.from_numpy(leaf), seed)
    assert sorted(tp) == ["p", "v"] and tp["p"].shape == jp["p"].shape
    for key in ("p", "v"):
        _close(tp[key], jp[key])
    _close(twire.decode(tp, torch.from_numpy(leaf)), jwire.decode(jp, jnp.asarray(leaf)))
    # the receive on the same factors: K7b's plain version (gated leaves) or
    # the plain decode-then-axpy (last dim off the 128-lane gate)
    jpay = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    want = jwire.decode_axpy(jpay, jnp.asarray(acc), 0.5, -1.0)
    got = twire.decode_axpy_(tp, torch.from_numpy(acc.copy()), 0.5, -1.0)
    _close(got, want)


def test_small_leaves_ride_fp16_bit_equal():
    jwire, twire = jw.LowRankWire(rank=2), tw.LowRankWire(rank=2)
    leaf = _leaf(3, (4, 77))
    tp = twire.encode(torch.from_numpy(leaf), 1)
    jp = jwire.encode(jnp.asarray(leaf), jnp.uint32(1))
    assert sorted(tp) == ["values"]
    np.testing.assert_array_equal(tp["values"].numpy(), np.asarray(jp["values"]))
    acc = _leaf(4, (4, 77))
    np.testing.assert_array_equal(
        twire.decode_axpy_(tp, torch.from_numpy(acc.copy()), 0.5).numpy(),
        np.asarray(jwire.decode_axpy(jp, jnp.asarray(acc), 0.5)))


def test_warm_encode_tree_stateful_matches_jax_over_rounds():
    """Two rounds of the warm channel: the payloads and the carried factors
    of the port follow the JAX wire's; the per-leaf form updates the state
    dict in place, the tree form leaves its argument alone."""
    jwire, twire = jw.LowRankWire(rank=2, warm=True), tw.LowRankWire(rank=2, warm=True)
    tree = {"bias": _leaf(5, (4, 128)), "proj": _leaf(6, (4, 32, 128)),
            "stack": _leaf(7, (4, 2, 16, 256))}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jaux, taux = jwire.init_aux(jtree), twire.init_aux(ttree)
    for step in range(2):
        _, jpay, jaux = jwire.encode_tree_stateful(jtree, jnp.int32(step), 2, jaux)
        before = {k: v.clone() for k, v in taux.items()}
        paths, tpay, taux_new = twire.encode_tree_stateful(ttree, step, 2, taux)
        assert paths == ["bias", "proj", "stack"]
        assert all(torch.equal(before[k], taux[k]) for k in taux)      # argument untouched
        taux = taux_new
        for jp, tp in zip(jpay, tpay):
            assert sorted(jp) == sorted(tp)
            for key in tp:
                if key == "values":
                    np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
                else:
                    _close(tp[key], jp[key])
        for k in jaux:
            _close(taux[k], jaux[k])
        # the next round sees a moved model
        ttree = {k: v * 0.9 + 0.01 for k, v in ttree.items()}
        jtree = jax.tree.map(lambda x: x * 0.9 + 0.01, jtree)
    state = {k: v.clone() for k, v in taux.items()}
    payload, same = twire.encode_leaf_stateful(ttree["proj"], 0, 1, state)
    assert same is state and torch.equal(state["1"], payload["v"])


def test_wire_bits_and_nbytes_match_jax():
    for spec in ("lowrank:1", "lowrank:2", "lowrank:4:warm", "lowrank:8"):
        jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
        for shape in (None, (1024, 1024), (3, 64, 256), (2048, 49408), (1000,), ()):
            assert twire.wire_bits_per_element(shape) == jwire.wire_bits_per_element(shape)
        tree = {"a": np.zeros((8, 1, 2048, 512), np.float32), "b": np.zeros((8, 2048), np.float32)}
        assert twire.wire_nbytes({k: torch.from_numpy(v) for k, v in tree.items()}) == \
            jwire.wire_nbytes(jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("spec", ["lowrank:2", "lowrank:2:warm", "lowrank:rank=3",
                                  "lowrank:4:warm=true", "lowrank:128", "lowrank"])
def test_spec_round_trips_match_jax(spec):
    jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
    assert tw.wire_spec(twire) == jw.wire_spec(jwire)
    assert tw.make_wire_format(tw.wire_spec(twire)) == twire
    assert (twire.rank, twire.warm, twire.stateful) == (jwire.rank, jwire.warm, jwire.stateful)
    assert twire.aux_name == jwire.aux_name and twire.wire_format == jwire.wire_format
    assert twire.packed == jwire.packed


@pytest.mark.parametrize("spec", ["lowrank:0", "lowrank:129", "lowrank:2:3", "lowrank:2:cold"])
def test_bad_specs_raise(spec):
    with pytest.raises((ValueError, TypeError)):
        tw.make_wire_format(spec)


def test_reprojection_ignores_the_global_tf32_flag():
    """The re-projection runs in full f32 whatever the global flag says, and
    leaves the flag as it found it."""
    twire = tw.LowRankWire(rank=2)
    leaf = torch.from_numpy(_leaf(8, (2, 16, 128)))
    want = twire.encode(leaf, 5)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = twire.encode(leaf, 5)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev)
    assert all(torch.equal(got[k], want[k]) for k in want)
