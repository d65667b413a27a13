"""The port's compression operators (``repro_torch.core.compression``) held
against the JAX package's on the CPU.

With an integer step key both packages seed through ``leaf_seed(step, salt,
leaf)``, so every payload is bit-equal, and so are the decoded values (the
decodes are single products, which XLA's jit cannot fuse); the sign codec's
scale is a sum, taken in another order, and agrees to rtol 1e-5.  With a
generator (the port) or a PRNG key (JAX) the randomness differs, and the
statistics are held to the JAX tests' bounds.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch.core import compression as tc
from repro_torch.distributed import wire as tw

# (JAX operator, port operator), the same fields on both sides
PAIRS = {
    "identity": (jc.IdentityCompressor(), tc.IdentityCompressor()),
    "fp16": (jc.HalfPrecisionCompressor(salt=3), tc.HalfPrecisionCompressor(salt=3)),
    "quant8": (jc.RandomQuantizer(bits=8, block_size=128), tc.RandomQuantizer(bits=8,
                                                                             block_size=128)),
    "quant8-32": (jc.RandomQuantizer(bits=8, block_size=32), tc.RandomQuantizer(bits=8,
                                                                               block_size=32)),
    "quant4-32": (jc.RandomQuantizer(bits=4, block_size=32, salt=2),
                  tc.RandomQuantizer(bits=4, block_size=32, salt=2)),
    "quant3": (jc.RandomQuantizer(bits=3, block_size=256), tc.RandomQuantizer(bits=3,
                                                                             block_size=256)),
    "randk": (jc.RandomSparsifier(p=0.25, block_size=128),
              tc.RandomSparsifier(p=0.25, block_size=128)),
    "topk-f16": (jc.TopKSparsifier(p=0.1, block_size=256, value_dtype="float16"),
                 tc.TopKSparsifier(p=0.1, block_size=256, value_dtype="float16")),
    "sign": (jc.SignCompressor(block_size=128), tc.SignCompressor(block_size=128)),
    "sign-l2": (jc.SignCompressor(block_size=256, scale="l2"),
                tc.SignCompressor(block_size=256, scale="l2")),
}


def _np(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 300)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 3, 128)).astype(np.float32),
                  "d": rng.standard_normal((4, 7)).astype(np.float32)}}


def _close(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    if name.startswith("sign"):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_compress_and_call_match_jax_at_integer_steps(name):
    jcomp, tcomp = PAIRS[name]
    x = np.random.default_rng(len(name)).standard_normal((5, 77)).astype(np.float32)
    jcompress = jax.jit(jcomp.compress)
    jcall = jax.jit(jcomp.__call__)
    for step in (1, 7):
        jp = jcompress(jnp.int32(step), jnp.asarray(x))
        tp = tcomp.compress(step, torch.from_numpy(x))
        assert sorted(jp) == sorted(tp)
        for k in jp:
            if name.startswith("sign") and k == "scale":
                np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-5)
            else:
                np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
        _close(tcomp(step, torch.from_numpy(x)), jcall(jnp.int32(step), jnp.asarray(x)), name)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_tree_apply_matches_jax_at_integer_steps(name):
    """``tree_apply`` with an integer step is the wire's ``encode_tree`` (one
    seed a leaf index) then the decode: the runtime's payloads."""
    jcomp, tcomp = PAIRS[name]
    tree = _tree(3)
    japply = jax.jit(jcomp.tree_apply)
    jout = japply(jnp.int32(5), jax.tree.map(jnp.asarray, tree))
    tout = tcomp.tree_apply(5, {"a": torch.from_numpy(tree["a"]),
                                "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}})
    _close(tout["a"], jout["a"], name)
    for k in ("c", "d"):
        _close(tout["b"][k], jout["b"][k], name)
    # one bare tensor is a one-leaf tree
    _close(tcomp.tree_apply(2, torch.from_numpy(tree["a"])),
           japply(jnp.int32(2), jnp.asarray(tree["a"])), name)


def test_use_kernel_routes_match_the_wire_route():
    """``use_kernel=True`` goes through kernels/ops.py on the whole flattened
    tensor; on whole blocks it emits the wire route's payload for the same
    integer key, as in the JAX package."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32))
    for bits in (4, 8):
        a = tc.RandomQuantizer(bits=bits, block_size=128, use_kernel=True).compress(9, x)
        b = tc.RandomQuantizer(bits=bits, block_size=128).compress(9, x)
        assert all(torch.equal(a[k], b[k]) for k in a)
    a = tc.RandomSparsifier(p=0.25, use_kernel=True).compress(4, x)
    b = tc.RandomSparsifier(p=0.25).compress(4, x)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # a generator key works on the kernel route too (JAX's takes PRNG keys only)
    g = torch.Generator().manual_seed(0)
    y = tc.RandomQuantizer(bits=8, block_size=128, use_kernel=True)(g, x)
    assert y.shape == x.shape and (y - x).abs().max() < x.abs().max() / 100


SPECS = ["quant:8", "quant:4", "quant:3:32", "quant:5:pack=false", "sparse:0.25",
         "sparse:0.05:topk:256:value_dtype=float16", "sign", "sign:l2:256", "fp16",
         "identity", "lowrank:2", "lowrank:2:warm",
         "adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4"]


@pytest.mark.parametrize("spec", SPECS)
def test_compressor_for_matches_jax(spec):
    from repro.distributed.wire import wire_spec as jwire_spec

    j = jc.compressor_for(spec, salt=4)
    t = tc.compressor_for(spec, salt=4)
    assert type(j).__name__ == type(t).__name__
    assert t.salt == 4 and t.name == j.name
    assert tw.wire_spec(t.wire) == jwire_spec(j.wire)


def test_bounds_match_jax():
    for name, (j, t) in PAIRS.items():
        assert t.alpha_bound() == pytest.approx(j.alpha_bound(), rel=1e-12), name
    for block in (128, 1024):
        assert tc.SignCompressor(block_size=block).delta_bound() == \
            jc.SignCompressor(block_size=block).delta_bound()
    with pytest.raises(ValueError):
        tc.SignCompressor(scale="l2").delta_bound()
    for bits in (2, 4, 8):
        assert tc.RandomQuantizer(bits=bits).levels == jc.RandomQuantizer(bits=bits).levels
        assert tc.RandomQuantizer(bits=bits).packed == jc.RandomQuantizer(bits=bits).packed


def test_registry_and_deprecation_warning():
    assert sorted(tc.REGISTRY) == sorted(jc.REGISTRY)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        t = tc.make_compressor("quant", bits=4, block_size=256)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j = jc.make_compressor("quant", bits=4, block_size=256)
    assert (t.bits, t.block_size, t.name) == (j.bits, j.block_size, j.name)
    for name in tc.REGISTRY:
        with pytest.warns(DeprecationWarning):
            assert type(tc.make_compressor(name)).__name__ == \
                type(jc.REGISTRY[name]()).__name__


def test_wire_bits_per_element_match_jax():
    for name, (j, t) in PAIRS.items():
        for shape in (None, (5, 77), (4096,)):
            assert t.wire_bits_per_element(shape) == pytest.approx(
                j.wire_bits_per_element(shape), rel=1e-12), (name, shape)


def test_measured_alpha_within_the_jax_bounds():
    """The JAX tests' bounds: 8-bit < 4-bit < 2-bit and 8-bit under 0.05;
    random-k at its analytic alpha to 10%, top-k below its bound."""
    g = torch.Generator().manual_seed(0)
    z = torch.randn((4096,), generator=torch.Generator().manual_seed(1))
    a8, a4, a2 = (tc.measured_alpha(tc.RandomQuantizer(bits=b, block_size=256), g, z)
                  for b in (8, 4, 2))
    assert a8 < a4 < a2 and a8 < 0.05
    rk = tc.RandomSparsifier(p=0.25, block_size=128)
    assert tc.measured_alpha(rk, g, z) == pytest.approx(rk.alpha_bound(), rel=0.1)
    tk = tc.TopKSparsifier(p=0.25, block_size=128)
    assert tc.measured_alpha(tk, g, z) <= tk.alpha_bound()
    # the same estimate as the JAX package's to 10% (different random draws)
    ja8 = jc.measured_alpha(jc.RandomQuantizer(bits=4, block_size=256), jax.random.key(0),
                            jnp.asarray(z.numpy()))
    assert a4 == pytest.approx(ja8, rel=0.1)


def test_generator_keys_are_independent_per_call_and_per_leaf():
    comp = tc.RandomQuantizer(bits=2, block_size=128)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((256,), generator=torch.Generator().manual_seed(4))
    assert not torch.equal(comp(g, x), comp(g, x))
    out = comp.tree_apply(g, {"a": x, "b": x.clone()})
    assert not torch.equal(out["a"], out["b"])
    mean = torch.stack([comp(g, x) for _ in range(400)]).mean(0)
    assert (mean - x).abs().max() < 0.15 * x.abs().max()        # unbiased
