"""The port's decode path and attention variants against the JAX package's.

Every family at its ``reduced()`` width, the same JAX params carried by
``params_from_jax``: 14 teacher-forced ``decode_step`` calls against the
jitted JAX step (bf16 logits agree to 5e-2 absolute, the tolerance of JAX's
own ``test_dense_decode_matches_forward``; measured at most 2.2e-2 on logits
of about 0.3), one step from JAX's own caches carried by ``cache_from_jax``,
greedy decoding fed JAX's greedy tokens (the port's argmax equals JAX's
wherever JAX's top two logits are more than the tolerance apart), and
decoding past capacity on a full cache (slot ``min(t, C-1)``), on a ring
(slot ``t % C``) and in MLA's latent cache (``t`` clamped to ``C-1``).  The
chunked online-softmax attention is held to JAX's at chunk 8 with and
without a window (float32, 1e-5), with its gradients, and at S >= 4096,
where ``gqa_forward`` and ``mla_forward`` take it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import encdec as jed
from repro_torch.configs import ARCH_IDS
from repro_torch.convert import cache_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models.lm import _layer
from repro_torch.tree import tree_leaves
from test_torch_families import np_batch, one_torch_thread, pair  # noqa: F401

ATOL = 5e-2


def _setup(arch, B=2, capacity=16, window=None, seed=2):
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair(arch)
    batch = np_batch(jcfg, B, 32, seed=seed)
    jc = jmodel.init_cache(B, capacity, window)
    tc = tmodel.init_cache(B, capacity, window, device="cpu")
    if jcfg.is_encdec:
        frames = batch["extra_embeds"]
        jc = jed.encdec_prefill_cross(jcfg, jparams, jnp.asarray(frames), jc)
        tc = ted.encdec_prefill_cross(tcfg, tparams, torch.from_numpy(frames), tc)
    return jmodel, tmodel, jparams, tparams, jc, tc, batch["tokens"]


def _tok(toks, t):
    return jnp.asarray(toks[:, t:t + 1]), torch.from_numpy(toks[:, t:t + 1].astype(np.int64))


def _run(arch, steps, capacity=16, window=None):
    """Teacher-forced steps in both packages; returns the max logit error."""
    jmodel, tmodel, jparams, tparams, jc, tc, toks = _setup(arch, capacity=capacity,
                                                             window=window)
    step = jax.jit(jmodel.decode_step)
    err = 0.0
    for t in range(steps):
        jt, tt = _tok(toks, t)
        jl, jc = step(jparams, jc, jt)
        tl, tc = tmodel.decode_step(tparams, tc, tt)
        assert tl.shape == tuple(jl.shape) and tl.dtype == torch.bfloat16
        err = max(err, float(np.abs(np.asarray(jl, np.float32) - tl.float().numpy()).max()))
    return err, jc, tc


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_teacher_forced_decode_matches_jax(arch):
    err, jc, tc = _run(arch, 14)
    assert err <= ATOL, err
    # the caches agree too, and every layer's position advanced to 14
    got = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert got.keys() == tc.keys()
    for name in got:
        assert getattr(got[name], "pos", 14) == getattr(tc[name], "pos", 14) == 14, name
        for a, b in zip(vars(got[name]).values(), vars(tc[name]).values()):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                scale = float(a.float().abs().max()) + 1e-6
                assert float((a.float() - b.float()).abs().max()) <= 0.05 * scale, name


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-lite-16b", "zamba2-7b",
                                  "mamba2-370m", "whisper-base"])
def test_one_step_from_jax_caches(arch):
    """Both packages take one step from the same caches (JAX's after 6 steps,
    carried by ``cache_from_jax``)."""
    jmodel, tmodel, jparams, tparams, jc, _, toks = _setup(arch)
    step = jax.jit(jmodel.decode_step)
    for t in range(6):
        _, jc = step(jparams, jc, _tok(toks, t)[0])
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    jt, tt = _tok(toks, 6)
    jl, jc2 = step(jparams, jc, jt)
    tl, tc2 = tmodel.decode_step(tparams, tc, tt)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), rtol=0, atol=ATOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jc2), device="cpu")
    for name in want:
        assert getattr(want[name], "pos", 7) == getattr(tc2[name], "pos", 7) == 7
        for a, b in zip(tree_leaves(vars(want[name])), tree_leaves(vars(tc2[name]))):
            if isinstance(a, torch.Tensor):
                scale = float(a.float().abs().max()) + 1e-6
                assert float((a.float() - b.float()).abs().max()) <= 0.05 * scale, name


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-15b", "deepseek-moe-16b",
                                  "mamba2-370m"])
def test_greedy_decode_follows_jax(arch):
    """Greedy decoding: both packages are fed JAX's argmax; wherever JAX's
    top two logits differ by more than the tolerance, the port picks the
    same token."""
    jmodel, tmodel, jparams, tparams, jc, tc, toks = _setup(arch)
    step = jax.jit(jmodel.decode_step)
    cur = toks[:, :1]
    checked = 0
    for _ in range(12):
        jl, jc = step(jparams, jc, jnp.asarray(cur))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(cur.astype(np.int64)))
        jl = np.asarray(jl[:, 0], np.float32)
        nxt = jl.argmax(-1)
        top2 = np.sort(jl, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * ATOL
        assert (tl[:, 0].float().argmax(-1).numpy()[sure] == nxt[sure]).all()
        checked += int(sure.sum())
        cur = nxt[:, None].astype(np.int32)
    assert checked > 0


@pytest.mark.parametrize("arch,window", [("granite-3-2b", None), ("granite-3-2b", 4),
                                         ("deepseek-v2-lite-16b", None),
                                         ("whisper-base", 4), ("zamba2-7b", 4)])
def test_decode_past_capacity_matches_jax(arch, window):
    """12 steps into 8 slots: a full cache keeps writing slot C-1 (JAX's
    clamped ``dynamic_update_slice``), a ring of 4 wraps, MLA's latent cache
    writes ``t`` clamped."""
    err, _, tc = _run(arch, 12, capacity=8, window=window)
    assert err <= ATOL, err
    for c in tc.values():
        if isinstance(c, tattn.KVCache):
            assert c.k.shape[-3] == (window or 8) and c.window == window and c.pos == 12
        elif isinstance(c, tattn.MLACache):
            assert c.c_kv.shape[-2] == 8 and c.pos == 12


def test_ring_buffer_equals_full_cache_when_the_window_covers():
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair("granite-3-2b")
    p = _layer(tparams["blocks"]["attn"], 0)
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv_heads, head_dim=tcfg.hd, theta=1e4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 10, tcfg.d_model)).astype(np.float32) * 0.3)
    full = tattn.gqa_init_cache(2, 10, tcfg.n_kv_heads, tcfg.hd, dtype=torch.float32,
                                device="cpu")
    ring = tattn.gqa_init_cache(2, 10, tcfg.n_kv_heads, tcfg.hd, window=10,
                                dtype=torch.float32, device="cpu")
    short = tattn.gqa_init_cache(2, 10, tcfg.n_kv_heads, tcfg.hd, window=4,
                                 dtype=torch.float32, device="cpu")
    for t in range(10):
        xt = x[:, t:t + 1]
        o1, full = tattn.gqa_decode(xt, full, p, **kw)
        o2, ring = tattn.gqa_decode(xt, ring, p, **kw)
        o3, short = tattn.gqa_decode(xt, short, p, **kw)
        assert torch.allclose(o1, o2, rtol=0, atol=1e-5)
    assert float((o3 - o1).abs().max()) > 1e-4 and short.k.shape[1] == 4 and short.pos == 10


def _qkv(S, H=4, KV=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, S, n, D)).astype(np.float32) for n in (H, KV, KV)]


@pytest.mark.parametrize("window", [None, 5])
def test_sdpa_chunked_matches_jax(window):
    q, k, v = _qkv(37)
    want = np.asarray(jattn._sdpa_chunked(*map(jnp.asarray, (q, k, v)), window=window, chunk=8))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tattn._sdpa_chunked(tq, tk, tv, window=window, chunk=8)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    # the unchunked reference agrees, and so do the gradients (the port
    # recomputes each chunk under torch.utils.checkpoint)
    full = tattn._sdpa(*map(torch.from_numpy, (q, k, v)),
                       tattn.causal_mask(37, window, device="cpu"))
    np.testing.assert_allclose(full.numpy(), want, rtol=0, atol=1e-5)
    w = np.random.default_rng(9).standard_normal(want.shape).astype(np.float32)
    jg = jax.grad(lambda a, b, c: jnp.sum(jattn._sdpa_chunked(a, b, c, window=window, chunk=8)
                                          * w), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    (got * torch.from_numpy(w)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=0, atol=1e-4)


def test_long_prefill_takes_the_chunked_path():
    """At S = 4096 ``gqa_forward`` and ``mla_forward`` run chunked, equal to
    JAX's (which is chunked there too) in float32."""
    S, d = tattn.FLASH_THRESHOLD, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    gq = jattn.gqa_init(jax.random.key(0), d, 2, 1, 8)
    want = np.asarray(jattn.gqa_forward(jnp.asarray(x), gq, n_heads=2, n_kv=1, head_dim=8,
                                        theta=1e4))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in gq.items()}
    got = tattn.gqa_forward(torch.from_numpy(x), tp, n_heads=2, n_kv=1, head_dim=8, theta=1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    mkw = dict(kv_lora=8, qk_nope=4, qk_rope=4, v_head=4)
    ml = jattn.mla_init(jax.random.key(1), d, 2, **mkw)
    want = np.asarray(jattn.mla_forward(jnp.asarray(x), ml, n_heads=2, theta=1e4, **mkw))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in ml.items()}
    got = tattn.mla_forward(torch.from_numpy(x), tp, n_heads=2, theta=1e4, **mkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
