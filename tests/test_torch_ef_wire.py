"""The port's sign, sparse, fp16 and identity wires against the JAX
package's, on the CPU.

Stacked (n, ...) leaves with ragged last dims, made with numpy from a seed:
payload words, indices and values must be bit-equal for the same
(step, salt, leaf) counter, on and off the 128-lane kernel gate.  The one
tolerance: the sign codec's per-block scale is a sum, which the port takes in
its CUDA kernel's fixed order and ``jnp.mean`` in another, so it agrees to
rtol 1e-5 (see test_torch_codecs.py).  ``decode`` and ``decode_axpy``
of the same payload are bit-equal to the JAX wire run eagerly.
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


EF_LEAF_SHAPES = [(4, 3, 1000), (8, 2, 256), (4, 40)]
SIGN_SCALE_RTOL = 1e-5
ACC_WEIGHT, WEIGHT = 0.5, 1.0 / 3.0
WIRE_SPECS = ["sign", "sign:l2:256", "sign:mean:96", "sparse:0.25", "sparse:0.05:topk",
              "sparse:0.25:randk:128:value_dtype=float16", "sparse:0.1:topk:96", "fp16",
              "identity"]


def _to_torch(payload) -> dict:
    out = {}
    for k, v in payload.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())
    return out


@pytest.mark.parametrize("spec", WIRE_SPECS)
def test_wire_payloads_and_decodes_match_jax(spec):
    """Stacked leaves with ragged last dims; block 96 and the 40-wide leaf sit
    off the 128-lane gate (plain versions).  The receive side runs one
    general weight pair here; test_torch_codecs.py runs the kernels with more."""
    rng = np.random.default_rng(sum(map(ord, spec)))
    jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
    tree = {f"l{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(EF_LEAF_SHAPES)}
    tree["l0"][1, :7] = -0.0
    step, salt = 5, 4

    jps = jax.jit(lambda t: jwire.encode_tree(t, jnp.int32(step), salt)[1])(
        {k: jnp.asarray(v) for k, v in tree.items()})
    _, tps = twire.encode_tree({k: torch.from_numpy(v) for k, v in tree.items()}, step, salt)
    for (_, leaf), tp, jp in zip(sorted(tree.items()), tps, jps):
        assert sorted(tp) == sorted(jp)
        for key in jp:
            want = np.asarray(jp[key])
            got = _u32(tp[key]) if want.dtype == np.uint32 else tp[key].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            if key == "scale":
                np.testing.assert_allclose(got, want, rtol=SIGN_SCALE_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(got, want)
        # receive side from the same (JAX) payload, against the eager JAX wire
        same = _to_torch(jp)
        np.testing.assert_array_equal(twire.decode(same, torch.from_numpy(leaf)).numpy(),
                                      np.asarray(jwire.decode(jp, jnp.asarray(leaf))))
        acc = rng.standard_normal(leaf.shape).astype(np.float32)
        want = np.asarray(jwire.decode_axpy(jp, jnp.asarray(acc), WEIGHT, ACC_WEIGHT))
        acc_t = torch.from_numpy(acc.copy())
        got = twire.decode_axpy_(same, acc_t, WEIGHT, ACC_WEIGHT)
        assert got is acc_t
        np.testing.assert_array_equal(got.numpy(), want)


KERNEL_WRAPPERS = {"quant": ("quantize_pack_2d", "unpack_dequant_axpy_2d"),
                   "sign": ("sign_pack_2d", "unpack_sign_axpy_2d"),
                   "sparse": ("sparse_select_pack_2d", "sparse_scatter_axpy_2d")}


@pytest.mark.parametrize("spec", ["quant:4:16384", "sign:mean:16384", "sparse:0.05:topk:8192",
                                  "sparse:0.05:randk:16384"])
def test_gated_blocks_of_any_width_go_through_the_kernel_wrappers(spec, monkeypatch):
    """The wires gate on the JAX package's ``block % 128 == 0`` alone: a
    block wider than the kernels take still goes to the wrappers, which run
    the plain version on CPU tensors and launch or raise on CUDA ones, so the
    card never picks the plain version silently.  Payloads and the in-place
    receive stay equal to the JAX wire's."""
    calls = []
    for name in KERNEL_WRAPPERS[spec.split(":")[0]]:
        real = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, _real=real, _name=name, **kw: (
            calls.append(_name), _real(*a, **kw))[1])
    jwire, twire = jw.make_wire_format(spec), tw.make_wire_format(spec)
    rng = np.random.default_rng(len(spec))
    leaf = rng.standard_normal((2, 1, twire.block)).astype(np.float32)
    acc = rng.standard_normal(leaf.shape).astype(np.float32)
    jp = jax.jit(lambda x: jwire.encode(x, jnp.int32(3)))(jnp.asarray(leaf))
    tp = twire.encode(torch.from_numpy(leaf), 3)
    for key in jp:
        want = np.asarray(jp[key])
        got = _u32(tp[key]) if want.dtype == np.uint32 else tp[key].numpy()
        if key == "scale" and spec.startswith("sign"):
            np.testing.assert_allclose(got, want, rtol=SIGN_SCALE_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
    want = np.asarray(jwire.decode_axpy(jp, jnp.asarray(acc), WEIGHT, ACC_WEIGHT))
    got = twire.decode_axpy_(_to_torch(jp), torch.from_numpy(acc.copy()), WEIGHT, ACC_WEIGHT)
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == list(KERNEL_WRAPPERS[spec.split(":")[0]])
