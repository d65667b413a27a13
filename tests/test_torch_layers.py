"""The port's model building blocks against the JAX package's, on the CPU.

MoE routing, the SSD scan, the norms and MLPs, the positions, the Mamba
conv, the cross caches, the zamba2 shared block, the VLM frontend in the
data pipeline and ``make_batch``.  Inputs are numpy draws.  The dispatch
and combine tensors are sums of 0/1 products, so they are held bit-equal;
float32 arithmetic is held to 1e-5 (the SSD scan to 2e-5, JAX's own
tolerance for ``ssd_chunked`` against its recurrent oracle).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataConfig, sample_batch, stacked_node_batches
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.api import build_model, make_batch
from repro_torch.tree import leaf_items
from test_torch_families import np_batch, one_torch_thread, pair  # noqa: F401

T = torch.from_numpy


def _gates(rows, E, seed, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((rows, E)).astype(np.float32)
    if ties:
        logits[::3] = 0.0                       # uniform rows, as the padded zero rows give
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("E,k,cap", [(4, 2, 10), (8, 3, 5), (64, 6, 120)])
@pytest.mark.parametrize("ties", [False, True])
def test_moe_dispatch_and_combine_bit_equal(E, k, cap, ties):
    gates = _gates(48, E, seed=E + k, ties=ties)
    if not ties:
        assert all(len(set(r)) == E for r in gates.tolist())
    jd, jc = jmoe._dispatch_indices(jnp.asarray(gates), k, cap)
    td, tc = tmoe._dispatch_indices(T(gates), k, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd)) and np.array_equal(tc.numpy(), np.asarray(jc))
    assert float(td.sum()) > 0


@pytest.mark.parametrize("B,S,group", [(2, 16, 1024), (1, 40, 16), (3, 1, 1024)])
def test_moe_forward_matches_jax(B, S, group):
    """float32 tokens, padded to a whole group (40 = 2 x 16 + 8 padded rows,
    routed too) or one decode token each."""
    d, E = 32, 4
    p = jmoe.moe_init(jax.random.key(0), d, 16, E, 1)
    x = np.random.default_rng(1).standard_normal((B, S, d)).astype(np.float32)
    kw = dict(n_routed=E, n_shared=1, top_k=2, capacity_factor=1.25, group=group)
    jout, jaux = jmoe.moe_forward(jnp.asarray(x), p, **kw)
    tp = {k: (T(np.asarray(v)) if not isinstance(v, dict) else
              {kk: T(np.asarray(vv)) for kk, vv in v.items()}) for k, v in p.items()}
    tout, taux = tmoe.moe_forward(T(x), tp, **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-6)


def _ssd_inputs(b, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = (rng.standard_normal(H) * 0.5).astype(np.float32)
    B = (rng.standard_normal((b, S, G, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, B, C, np.ones(H, np.float32)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_jax_and_the_recurrent_oracle(chunk):
    args = _ssd_inputs(2, 67, 4, 8, 2, 16, seed=0)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, th = tssm.ssd_chunked(*map(T, args), chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=2e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=2e-5)
    ry, rh = tssm.ssd_recurrent_ref(*map(T, args))
    jry, jrh = jssm.ssd_recurrent_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(th.numpy(), rh.numpy(), rtol=0, atol=2e-5)


def test_ssd_state_carry_across_calls():
    x, dt, A, B, C, _ = _ssd_inputs(1, 32, 2, 4, 1, 8, seed=1)
    D = np.zeros(2, np.float32)
    y, h = tssm.ssd_chunked(*map(T, (x, dt, A, B, C, D)), chunk=8)
    y1, h1 = tssm.ssd_chunked(*map(T, (x[:, :16], dt[:, :16], A, B[:, :16], C[:, :16], D)),
                              chunk=8)
    y2, h2 = tssm.ssd_chunked(*map(T, (x[:, 16:], dt[:, 16:], A, B[:, 16:], C[:, 16:], D)),
                              chunk=8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=0, atol=2e-5)


def test_conv_segsum_norms_mlps_and_positions_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(tssm._depthwise_conv(T(x), T(w), T(b)).numpy(),
                               np.asarray(jssm._depthwise_conv(*map(jnp.asarray, (x, w, b)))),
                               rtol=0, atol=1e-5)
    lg = -np.abs(rng.standard_normal((3, 7))).astype(np.float32)
    np.testing.assert_allclose(np.exp(tssm._segsum(T(lg)).numpy()),
                               np.exp(np.asarray(jssm._segsum(jnp.asarray(lg)))), rtol=0, atol=1e-6)
    ln = {"g": rng.standard_normal(12).astype(np.float32),
          "b": rng.standard_normal(12).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.layernorm(T(x), {k: T(v) for k, v in ln.items()}).numpy(),
        np.asarray(jlayers.layernorm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in ln.items()})),
        rtol=0, atol=1e-5)
    mlp = {"wi": rng.standard_normal((12, 20)).astype(np.float32) * 0.3,
           "wo": rng.standard_normal((20, 12)).astype(np.float32) * 0.3}
    # jax.nn.gelu is the tanh approximation; the exact erf GELU differs by ~1e-3
    np.testing.assert_allclose(
        tlayers.gelu_mlp(T(x), {k: T(v) for k, v in mlp.items()}).numpy(),
        np.asarray(jlayers.gelu_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in mlp.items()})),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlayers.sinusoidal_positions(50, 16, device="cpu").numpy(),
                               np.asarray(jlayers.sinusoidal_positions(50, 16)), rtol=0, atol=1e-6)
    for t in (0, 7, 4095):
        np.testing.assert_allclose(ted.sinusoidal_positions_at(t, 16, device="cpu").numpy(),
                                   np.asarray(jed.sinusoidal_positions_at(jnp.int32(t), 16)),
                                   rtol=0, atol=1e-6)


def test_whisper_cross_caches_match_jax():
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair("whisper-base")
    frames = np.random.default_rng(3).standard_normal(
        (2, jcfg.frontend.n_tokens, jcfg.frontend.dim)).astype(np.float32)
    jc = jed.encdec_prefill_cross(jcfg, jparams, jnp.asarray(frames), jmodel.init_cache(2, 8))
    tc = ted.encdec_prefill_cross(tcfg, tparams, T(frames), tmodel.init_cache(2, 8, device="cpu"))
    for name in ("k", "v"):
        want = np.asarray(getattr(jc["cross"], name), np.float32)
        got = getattr(tc["cross"], name)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        # bf16 activations: within 2% of the largest entry (measured 0.5%)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=0.02 * float(np.abs(want).max()))
    assert float(tc["cross"].k.float().abs().max()) > 0
    # the serving loop never runs the encoder: a fresh cache's cross K/V are zero
    assert not tmodel.init_cache(2, 8, device="cpu")["cross"].k.any()


def test_zamba2_shared_block_is_one_leaf_set():
    """One set of shared attention parameters (rank 2, not stacked),
    applied once a period; its gradient (the sum over the applications)
    equals JAX's."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair("zamba2-7b")
    paths = [p for p, _ in leaf_items(tparams)]
    shared = [p for p in paths if p.startswith("shared_attn/")]
    assert len(shared) == 9 and tparams["shared_attn"]["attn"]["wq"].dim() == 2
    assert tparams["pm"]["mixer"]["wx"].shape[:2] == (tlm.HybridLayout.of(tcfg).n_periods, 1)
    batch = np_batch(jcfg, 1, 16, seed=4)
    jg = jax.grad(lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
        jparams)["shared_attn"]["attn"]["wq"]
    wq = tparams["shared_attn"]["attn"]["wq"].requires_grad_(True)
    tmodel.loss(tparams, {k: T(v.astype(np.int64)) for k, v in batch.items()})[0].backward()
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(wq.grad.numpy(), jg, rtol=0, atol=0.05 * float(np.abs(jg).max()))


def test_cast_weights_casts_matrices_only():
    cfg = get_config("mamba2-370m").reduced()
    lp = tlm._layer(build_model(cfg).init(0, device="cpu")["blocks"], 0)
    cast = tlm._cast_weights(lp)
    for (path, a), (_, b) in zip(leaf_items(lp), leaf_items(cast)):
        assert b.dtype == (torch.bfloat16 if a.dim() >= 2 else torch.float32), path
    assert cast["mixer"]["conv_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-base", "granite-3-2b"])
def test_pipeline_emits_frontend_embeds(arch):
    cfg = get_config(arch).reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=24, global_batch=6, n_shards=3, seed=5)
    a = stacked_node_batches(dc, 2, cfg, device="cpu")
    b = stacked_node_batches(dc, 2, cfg, device="cpu")
    n_text = 24 - cfg.frontend.n_tokens if cfg.frontend and cfg.frontend.kind == "vision" else 24
    assert a["tokens"].shape == a["labels"].shape == (3, 2, n_text)
    assert torch.equal(sample_batch(dc, 2, 1, cfg, device="cpu")["tokens"], a["tokens"][1])
    if cfg.frontend is None:
        assert "extra_embeds" not in a
        assert torch.equal(a["tokens"], stacked_node_batches(dc, 2, device="cpu")["tokens"])
        return
    e = a["extra_embeds"]
    assert e.shape == (3, 2, cfg.frontend.n_tokens, cfg.frontend.dim) and e.dtype == torch.float32
    assert torch.equal(e, b["extra_embeds"])
    assert torch.equal(sample_batch(dc, 2, 1, cfg, device="cpu")["extra_embeds"], e[1])
    assert not torch.equal(stacked_node_batches(dc, 3, cfg, device="cpu")["extra_embeds"], e)
    assert abs(float(e.mean())) < 0.1 and abs(float(e.std()) - 1.0) < 0.1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_shapes(arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(3)
    b = make_batch(cfg, gen, 2, 32)
    want = dict(np_batch(cfg, 2, 32))
    assert {k: tuple(v.shape) for k, v in b.items()} == {k: v.shape for k, v in want.items()}
    assert int(b["tokens"].max()) < cfg.vocab and b["tokens"].dtype == torch.int64
    again = make_batch(cfg, torch.Generator().manual_seed(3), 2, 32)
    assert all(torch.equal(b[k], again[k]) for k in b)
    loss, _ = build_model(cfg).loss(build_model(cfg).init(0, device="cpu"), b)
    assert torch.isfinite(loss)
