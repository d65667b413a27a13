"""The port's example entry points (``repro_torch.examples``) on the CPU, and
the small public remnants held against the JAX package: ``Compressor``'s
``tree_compress``/``tree_decompress``, the data pipeline's ``iterate``,
``register_wire_format`` and the deprecated ``gossip_shifts`` spelling.

``compare_compression`` keeps the JAX example's two gates: ``pareto_sweep``
returns the dominance pairs (and raises ``SystemExit`` when there are none)
and ``lowrank_sweep`` raises when a measured bits/element misses its budget.
Its problems come from ``torch.Generator``s, so its tables are its own, not
the JAX example's numbers.
"""
import argparse
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.data import pipeline as jpipe
from repro.distributed import decentralized as jd
from repro.distributed import wire as jw
from repro_torch.core import compression as tc
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import decentralized as td
from repro_torch.distributed import gossip as tg
from repro_torch.distributed import wire as tw
from repro_torch.examples import compare_compression as cc
from repro_torch.examples import serve_lm, train_lm
from test_torch_families import one_torch_thread  # noqa: F401

SPECS = ("quant:4", "quant:8:32", "quant:3:256:pack=true", "sparse:0.25",
         "sparse:0.05:topk:256:value_dtype=float16", "sign", "sign:l2:256", "fp16", "identity",
         "lowrank:2", "lowrank:4:warm", "adaptive:4096:small=fp16:large=quant:4",
         "adaptive:128:small=fp16:large=lowrank:2:leaf.embed=quant:4")


def _args(**kw):
    base = dict(topology="ring", device="cpu", quick=True, drop_rate=0.0, drop_salt=0,
                straggler=0.0, algo=None, wire=None, gamma=0.2)
    return argparse.Namespace(**{**base, **kw})


# ------------------------------------------------------------ entry points

def test_pareto_sweep_returns_dominance_pairs():
    pairs = cc.pareto_sweep(seed=0, verbose=False, device="cpu")
    assert pairs and all(a.startswith("ad") and beats for a, beats in pairs)


def test_lowrank_sweep_passes_its_wire_gate():
    rows = cc.lowrank_sweep(_args(), T=30)
    assert [s for s, _, _ in rows] == ["fp16", "lowrank:2", "lowrank:2:warm", "lowrank:4:warm"]
    assert all(math.isfinite(d) for _, _, d in rows)
    assert [m for _, m, _ in rows][1:] == [1.5, 1.5, 3.0]    # 32 r (64 + 128) / (64 * 128)


def test_lowrank_gate_raises_on_a_dishonest_wire(monkeypatch):
    monkeypatch.setattr(tw.LowRankWire, "wire_bits_per_element", lambda self, shape=None: 1.0)
    with pytest.raises(SystemExit):
        cc.lowrank_sweep(_args(), T=2)


def test_drop_sweep_quick_run_is_finite(capsys):
    rows = cc.main(["--quick", "--drop-rate", "0.2", "--straggler", "0.5", "--device", "cpu"])
    assert len(rows) == len(cc.DROP_CONFIGS) * 3
    assert {r for _, _, r, _ in rows} == {0.0, 0.2, 0.5}
    assert all(math.isfinite(v) for *_, v in rows)
    assert "epoch-time-vs-straggler-tail" in capsys.readouterr().out


def test_error_feedback_cell_is_finite_and_beats_init():
    rows = cc.main(["--quick", "--algo", "choco", "--wire", "sign", "--device", "cpu"])
    assert [(n, a, t) for n, a, t, _ in rows] == [(8, "choco", "sign")]
    assert math.isfinite(rows[0][3]) and rows[0][3] < 1.0


def test_train_lm_smoke_on_cpu():
    hist = train_lm.main(["--steps", "2", "--nodes", "2", "--device", "cpu"])
    assert len(hist["losses"]) == 2 and all(math.isfinite(l) for l in hist["losses"])


def test_serve_lm_smoke_on_cpu():
    out_full, out_win = serve_lm.main(["--device", "cpu"])
    assert out_full.shape == out_win.shape == (4, 16)
    # the ring buffer holds all 8 + 16 positions but the last 16: the first
    # token is the prefill's greedy argmax, over the same 8 prompt positions
    assert torch.equal(out_full[:, 0], out_win[:, 0])


# ----------------------------------------------------------------- remnants

@pytest.mark.parametrize("name", ["quant4", "randk", "topk", "fp16"])
def test_tree_compress_matches_jax_at_integer_steps(name):
    """At an integer step, leaf ``li``'s payload is the wire's encode of the
    flattened leaf at ``leaf_seed(step, salt, li)``, bit-equal to the JAX
    wire's; ``tree_decompress`` gives back the tree of decodes."""
    jcomp, tcomp = {
        "quant4": (jc.RandomQuantizer(bits=4, block_size=128, salt=2),
                   tc.RandomQuantizer(bits=4, block_size=128, salt=2)),
        "randk": (jc.RandomSparsifier(p=0.25, block_size=128),
                  tc.RandomSparsifier(p=0.25, block_size=128)),
        "topk": (jc.TopKSparsifier(p=0.1, block_size=128), tc.TopKSparsifier(p=0.1,
                                                                            block_size=128)),
        "fp16": (jc.HalfPrecisionCompressor(), tc.HalfPrecisionCompressor()),
    }[name]
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((3, 128)).astype(np.float32),
            "z": {"b": rng.standard_normal((256,)).astype(np.float32)}}
    ttree = {"a": torch.from_numpy(tree["a"]), "z": {"b": torch.from_numpy(tree["z"]["b"])}}
    paths, payloads = tcomp.tree_compress(7, ttree)
    assert paths == ["a", "z/b"]
    for li, (leaf, pl) in enumerate(zip(jax.tree.leaves(tree), payloads)):
        want = jcomp.wire.encode(jnp.asarray(leaf).reshape(-1),
                                 jw.leaf_seed(jnp.asarray(7), jcomp.salt, li))
        assert sorted(pl) == sorted(want)
        for k in want:
            got, exp = pl[k].numpy(), np.asarray(want[k])
            np.testing.assert_array_equal(got.view(exp.dtype) if got.dtype != exp.dtype
                                          else got, exp)
    back = tcomp.tree_decompress(paths, payloads, ttree)
    for path, leaf, pl in zip(paths, [ttree["a"], ttree["z"]["b"]], payloads):
        node = back["a"] if path == "a" else back["z"]["b"]
        assert node.shape == leaf.shape and node.dtype == leaf.dtype
        assert torch.equal(node, tcomp.decompress(pl, leaf))
    with pytest.raises(ValueError):
        tcomp.tree_decompress(paths[::-1], payloads, ttree)


def test_tree_compress_with_a_generator_has_jax_structure():
    """With a generator every leaf draws its own seed: payload containers
    shaped as the JAX package's under a PRNG key, and the round trip exact
    for fp16 values."""
    jcomp, tcomp = jc.RandomQuantizer(bits=4, block_size=128), tc.RandomQuantizer(
        bits=4, block_size=128)
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((2, 128)).astype(np.float32),
            "b": rng.standard_normal((128,)).astype(np.float32)}
    _, jpay = jcomp.tree_compress(jax.random.key(0), jax.tree.map(jnp.asarray, tree))
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    paths, tpay = tcomp.tree_compress(torch.Generator().manual_seed(0), ttree)
    for jp, tp in zip(jpay, tpay):
        assert {k: tuple(v.shape) for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
    assert not torch.equal(tpay[0]["codes"].reshape(-1)[:4], tpay[1]["codes"].reshape(-1)[:4])
    back = tcomp.tree_decompress(paths, tpay, ttree)
    for k in tree:
        assert back[k].shape == ttree[k].shape
        assert float((back[k] - ttree[k]).abs().max()) < 0.5 * float(ttree[k].abs().max())
    half = tc.HalfPrecisionCompressor()
    hp, hpay = half.tree_compress(torch.Generator().manual_seed(0), ttree)
    hb = half.tree_decompress(hp, hpay, ttree)
    for k in tree:
        assert torch.equal(hb[k], ttree[k].half().float())


def test_iterate_yields_consecutive_steps_like_jax():
    cfg = tpipe.DataConfig(vocab=64, seq_len=16, global_batch=8, n_shards=4, seed=3)
    jcfg = jpipe.DataConfig(vocab=64, seq_len=16, global_batch=8, n_shards=4, seed=3)
    it = tpipe.iterate(cfg, 2, start_step=5, device="cpu")
    jit_ = jpipe.iterate(jcfg, 2, start_step=5)
    for step in range(5, 8):
        got, jgot = next(it), next(jit_)
        want = tpipe.sample_batch(cfg, step, 2, device="cpu")
        assert sorted(got) == sorted(want) == sorted(jgot)
        for k in got:
            assert torch.equal(got[k], want[k])
            assert tuple(got[k].shape) == tuple(jgot[k].shape)


def test_register_wire_format_fills_the_registry_as_jax():
    assert {k: v[1] for k, v in tw.WIRE_FORMATS.items()} == \
        {k: v[1] for k, v in jw.WIRE_FORMATS.items()}
    assert [k for k in tw.WIRE_FORMATS] == [k for k in jw.WIRE_FORMATS]
    for spec in SPECS:
        w, jwf = tw.make_wire_format(spec), jw.make_wire_format(spec)
        assert tw.wire_spec(w) == jw.wire_spec(jwf), spec
        assert tw.make_wire_format(tw.wire_spec(w)) == w, spec


def test_register_wire_format_adds_a_spec_name(monkeypatch):
    monkeypatch.setattr(tw, "WIRE_FORMATS", dict(tw.WIRE_FORMATS))
    tw.register_wire_format("q", tw.QuantWire, positional=("bits", "block"))
    assert tw.make_wire_format("q:3:256") == tw.QuantWire(bits=3, block=256)
    assert tw.make_wire_format("q:block=128") == tw.QuantWire(block=128)
    with pytest.raises(ValueError):
        tw.make_wire_format("q:3:256:7")


def _deprecations(record):
    return [w for w in record if issubclass(w.category, DeprecationWarning)]


def test_gossip_shifts_warns_once_and_equals_jax():
    for topo, n in (("ring", 8), ("torus", 16), ("full", 5)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            w_s, shifts = td.gossip_shifts(topo, n)
        assert len(_deprecations(rec)) == 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jw_s, jshifts = jd.gossip_shifts(topo, n)
        plan = tg.make_gossip_plan(topo, n)
        assert w_s == jw_s == plan.self_weight and shifts == jshifts == dict(plan.shifts)
    with pytest.raises(ValueError), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        td.gossip_shifts("chain", 8)       # per-node weights: use the plan


def test_deprecated_codec_names_warn_once():
    for old, new in (("WireCodec", tw.QuantWire), ("SparseWireCodec", tw.SparseWire)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = getattr(td, old)
        assert len(_deprecations(rec)) == 1 and got is new
    with pytest.raises(AttributeError):
        td.NoSuchName
