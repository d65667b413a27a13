"""Attention variants: GQA (full / sliding-window), MLA, cross-attention.

The port of the JAX package's ``models/attention.py``.  The JAX package
computes attention in plain jnp (einsum, softmax), so this is plain torch
einsum and softmax on the same layout and in the same association: q (B, S,
H, D), k/v (B, T, KV, D), heads grouped as (KV, G).  Above
``FLASH_THRESHOLD`` query positions, self-attention runs chunked with an
online softmax (:func:`_sdpa_chunked`).

Decode caches hold one tensor per kind with a leading layer axis (stacked
like the parameters) and the number of tokens already in context as a host
integer.  Two flavours of self-attention cache:

* full cache  — capacity = the longest sequence; position ``t`` writes slot
                ``min(t, capacity - 1)``;
* ring buffer — capacity = the sliding window; position ``t`` writes slot
                ``t % window``.

A decode step writes its new entries into the cache tensors in place and
returns the cache with the position advanced.  Keys are stored already
roped at absolute positions, so ring-buffer overwrites are safe.  Where
``jax.lax.dynamic_update_slice`` clamps an out-of-range start, the port
clamps explicitly (torch indexing raises instead).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    Params,
    apply_rope,
    dense,
    dense_init,
    einsum,
    rmsnorm,
    rmsnorm_init,
    yarn_softmax_scale,
)
from repro_torch.trace import span

NEG_INF = -1e9

# Above this many query positions, self-attention runs in the chunked
# online-softmax formulation: O(S * FLASH_CHUNK) live scores instead of
# O(S^2).
FLASH_THRESHOLD = 4096
FLASH_CHUNK = 1024


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (L, B, C, KV, D) roped keys
    v: torch.Tensor          # (L, B, C, KV, D)
    pos: int                 # tokens already in context
    window: Optional[int] = None  # ring-buffer capacity if sliding


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor       # (L, B, C, R) compressed latent
    k_rope: torch.Tensor     # (L, B, C, Dr) shared roped key part
    pos: int


# ------------------------------------------------------------------ GQA

def gqa_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int, head_dim: int, *,
             device, lead: tuple = ()) -> Params:
    return {
        "wq": dense_init(gen, d, n_heads * head_dim, device=device, lead=lead),
        "wk": dense_init(gen, d, n_kv * head_dim, device=device, lead=lead),
        "wv": dense_init(gen, d, n_kv * head_dim, device=device, lead=lead),
        "wo": dense_init(gen, n_heads * head_dim, d, device=device, lead=lead),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, -1)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,KV,D); GQA by head-group reshape; mask (S,T) or
    (B,S,T) -> (B,S,H,Dv)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, D)
    scores = einsum("bskgd,btkd->bkgst", q, k).to(torch.float32) / math.sqrt(D)
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def causal_mask(S: int, window: Optional[int] = None, *, device) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= j > i - window
    return m


def _chunk_step(m, l, acc, qr, kj, vj, kpos, qpos, S: int, window: Optional[int],
                scale: float):
    """One KV chunk of the online softmax: the running max, denominator and
    weighted accumulator after ``kj``/``vj`` at key positions ``kpos``."""
    s = torch.einsum("bskgd,btkd->bkgst", qr, kj).to(torch.float32) * scale
    valid = kpos[None, :] <= qpos[:, None]
    if window is not None:
        valid &= kpos[None, :] > qpos[:, None] - window
    valid &= (kpos < S)[None, :]
    s = torch.where(valid[None, None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgst,btkd->bkgsd", p.to(qr.dtype), vj).to(torch.float32)
    return m_new, l_new, acc_new


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int] = None, chunk: int = FLASH_CHUNK,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention with an online softmax over KV chunks.

    q (B,S,H,D), k/v (B,S,KV,D), S == T; scores scaled by ``scale``
    (``1/sqrt(D)`` when None).  Carries (running max, running
    denominator, weighted accumulator) across chunks; each chunk is masked
    causally (and by the sliding window if set).  Under autograd each chunk
    runs under ``torch.utils.checkpoint``, so the backward recomputes the
    chunk's probabilities instead of keeping them (the JAX package's
    ``jax.checkpoint`` on the scan body): a training step never holds S x S.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qr = q.reshape(B, S, KV, G, D)
    pad = (-S) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = k.shape[1] // chunk
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, Dv), dtype=torch.float32, device=q.device)
    recompute = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for c in range(n_chunks):
        kj, vj = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        if recompute:
            m, l, acc = checkpoint(_chunk_step, m, l, acc, qr, kj, vj, kpos, qpos, S, window,
                                   scale, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(m, l, acc, qr, kj, vj, kpos, qpos, S, window, scale)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv).to(q.dtype)


def _roped(x: torch.Tensor, positions: torch.Tensor, theta: float, rope: bool) -> torch.Tensor:
    return apply_rope(x, positions, theta) if rope else x


def gqa_forward(x: torch.Tensor, p: Params, *, n_heads: int, n_kv: int, head_dim: int,
                theta: float, window: Optional[int] = None,
                positions: Optional[torch.Tensor] = None, rope: bool = True) -> torch.Tensor:
    """Training / prefill self-attention (causal, optionally sliding-window);
    with ``rope`` False no position encoding (Nemotron-H's attention)."""
    B, S, _ = x.shape
    pos = positions if positions is not None else torch.arange(S, device=x.device)
    q = _roped(_split_heads(dense(x, p["wq"]), n_heads), pos, theta, rope)
    k = _roped(_split_heads(dense(x, p["wk"]), n_kv), pos, theta, rope)
    v = _split_heads(dense(x, p["wv"]), n_kv)
    if S >= FLASH_THRESHOLD:
        out = _sdpa_chunked(q, k, v, window=window)
    else:
        out = _sdpa(q, k, v, causal_mask(S, window, device=x.device))
    return dense(out.reshape(B, S, -1), p["wo"])


def gqa_init_cache(B: int, capacity: int, n_kv: int, head_dim: int,
                   window: Optional[int] = None, dtype=COMPUTE_DTYPE, *,
                   device, lead: tuple = ()) -> KVCache:
    cap = min(capacity, window) if window else capacity
    shape = lead + (B, cap, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=0, window=window)


def _write_slot(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
    """Write one position's k/v (B, 1, KV, D) into a layer's cache (B, C,
    KV, D) in place; returns the (C,) mask of the valid slots.  A ring
    writes slot ``t % C`` and, once full, sees every slot; a full cache
    writes ``min(t, C - 1)`` (``dynamic_update_slice`` clamps) and sees the
    slots up to it."""
    t, cap = cache.pos, cache.k.shape[1]
    slot = t % cap if cache.window else min(t, cap - 1)
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    j = torch.arange(cap, device=cache.k.device)
    if cache.window:
        return (j <= t) | (t >= cap)
    return j <= min(t, cap - 1)


def gqa_decode(x: torch.Tensor, cache: KVCache, p: Params, *, n_heads: int, n_kv: int,
               head_dim: int, theta: float, rope: bool = True) -> tuple:
    """One-token decode: x (B, 1, d) against one layer's cache (k/v (B, C,
    KV, D)), which takes the new entries in place; returns y and the cache
    with the position advanced."""
    B = x.shape[0]
    t = torch.tensor([cache.pos], device=x.device)
    q = _roped(_split_heads(dense(x, p["wq"]), n_heads), t, theta, rope)
    k_new = _roped(_split_heads(dense(x, p["wk"]), n_kv), t, theta, rope)
    v_new = _split_heads(dense(x, p["wv"]), n_kv)
    valid = _write_slot(cache, k_new, v_new)
    out = _sdpa(q, cache.k, cache.v, valid[None, None, :].expand(B, 1, -1))
    y = dense(out.reshape(B, 1, -1), p["wo"])
    return y, dataclasses.replace(cache, pos=cache.pos + 1)


# ------------------------------------------------------------------ MLA (DeepSeek-V2)

def mla_init(gen: torch.Generator, d: int, n_heads: int, *, kv_lora: int, qk_nope: int,
             qk_rope: int, v_head: int, device, lead: tuple = (),
             latent_norm: bool = False) -> Params:
    p = {
        "wq": dense_init(gen, d, n_heads * (qk_nope + qk_rope), device=device, lead=lead),
        "wdkv": dense_init(gen, d, kv_lora, device=device, lead=lead),
        "wuk": dense_init(gen, kv_lora, n_heads * qk_nope, device=device, lead=lead),
        "wuv": dense_init(gen, kv_lora, n_heads * v_head, device=device, lead=lead),
        "wkr": dense_init(gen, d, qk_rope, device=device, lead=lead),
        "wo": dense_init(gen, n_heads * v_head, d, device=device, lead=lead),
    }
    if latent_norm:
        p["kv_norm"] = rmsnorm_init(kv_lora, device=device, lead=lead)
    return p


def _latent(x: torch.Tensor, p: Params, latent_norm: bool) -> torch.Tensor:
    """The compressed latent ``c_kv = x W_dkv``, RMS-normed with ``latent_norm``."""
    c_kv = dense(x, p["wdkv"])
    return rmsnorm(c_kv, p["kv_norm"]) if latent_norm else c_kv


def mla_forward(x: torch.Tensor, p: Params, *, n_heads: int, kv_lora: int, qk_nope: int,
                qk_rope: int, v_head: int, theta: float, latent_norm: bool = False,
                yarn: Tuple[float, ...] = ()) -> torch.Tensor:
    """Training/prefill MLA (uncompressed path), inside the span ``model.mla``."""
    with span("model.mla"):
        return _mla_forward(x, p, n_heads=n_heads, qk_nope=qk_nope, qk_rope=qk_rope,
                            v_head=v_head, theta=theta, latent_norm=latent_norm, yarn=yarn)


def _mla_forward(x, p, *, n_heads, qk_nope, qk_rope, v_head, theta, latent_norm, yarn):
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q = dense(x, p["wq"]).reshape(B, S, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, pos, theta, yarn)
    c_kv = _latent(x, p, latent_norm)                                # (B,S,R)
    k_nope = dense(c_kv, p["wuk"]).reshape(B, S, n_heads, qk_nope)
    v = dense(c_kv, p["wuv"]).reshape(B, S, n_heads, v_head)
    k_rope = apply_rope(dense(x, p["wkr"])[:, :, None, :], pos, theta, yarn)  # (B,S,1,Dr)
    scale = yarn_softmax_scale(qk_nope + qk_rope, yarn)

    if S >= FLASH_THRESHOLD:
        # chunked path: fold the shared rope key into per-head effective K
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_eff = torch.cat([k_nope, k_rope.expand(B, S, n_heads, qk_rope)], dim=-1)
        out = _sdpa_chunked(q_eff, k_eff, v, scale=scale)
        return dense(out.reshape(B, S, -1), p["wo"])

    s1 = torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
    s2 = torch.einsum("bshd,btxd->bhst", q_rope, k_rope)
    scores = (s1 + s2).to(torch.float32) * scale
    mask = causal_mask(S, device=x.device)[None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    return dense(out.reshape(B, S, -1), p["wo"])


def mla_init_cache(B: int, capacity: int, kv_lora: int, qk_rope: int,
                   dtype=COMPUTE_DTYPE, *, device, lead: tuple = ()) -> MLACache:
    return MLACache(
        c_kv=torch.zeros(lead + (B, capacity, kv_lora), dtype=dtype, device=device),
        k_rope=torch.zeros(lead + (B, capacity, qk_rope), dtype=dtype, device=device),
        pos=0,
    )


def mla_decode(x: torch.Tensor, cache: MLACache, p: Params, *, n_heads: int, kv_lora: int,
               qk_nope: int, qk_rope: int, v_head: int, theta: float,
               latent_norm: bool = False, yarn: Tuple[float, ...] = ()) -> tuple:
    """Absorbed-matrix decode: scores and values are computed in the
    ``kv_lora``-dim latent space, so a step costs O(S * (kv_lora + qk_rope))
    a head.  Writes one layer's latent cache (B, C, R) and rope keys (B, C,
    Dr) at slot ``t`` in place; the JAX package writes ``t`` unclamped,
    which XLA clamps to ``C - 1``, and so does this.  Returns y and the
    cache with the position advanced."""
    B = x.shape[0]
    t, c_kv, k_rope = cache.pos, cache.c_kv, cache.k_rope
    tt = torch.tensor([t], device=x.device)
    q = dense(x, p["wq"]).reshape(B, 1, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, tt, theta, yarn)

    c_new = _latent(x, p, latent_norm)                               # (B,1,R)
    kr_new = apply_rope(dense(x, p["wkr"])[:, :, None, :], tt, theta, yarn)[:, :, 0]
    slot = min(t, c_kv.shape[1] - 1)
    c_kv[:, slot] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, slot] = kr_new[:, 0].to(k_rope.dtype)

    # absorb W_uk into q: q_lat (B,H,R)
    wuk = p["wuk"].reshape(kv_lora, n_heads, qk_nope).to(x.dtype)
    q_lat = einsum("bxhd,rhd->bhr", q_nope, wuk)
    scale = yarn_softmax_scale(qk_nope + qk_rope, yarn)
    s1 = einsum("bhr,btr->bht", q_lat, c_kv)
    s2 = einsum("bxhd,btd->bht", q_rope, k_rope)
    scores = (s1 + s2).to(torch.float32) * scale
    valid = torch.arange(c_kv.shape[1], device=x.device) <= t
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = einsum("bht,btr->bhr", probs, c_kv)                # (B,H,R)
    wuv = p["wuv"].reshape(kv_lora, n_heads, v_head).to(x.dtype)
    out = einsum("bhr,rhd->bhd", o_lat, wuv).reshape(B, 1, -1)
    return dense(out, p["wo"]), dataclasses.replace(cache, pos=t + 1)


# ------------------------------------------------------------------ cross-attention

def cross_init(gen: torch.Generator, d: int, n_heads: int, head_dim: int, *, device,
               lead: tuple = ()) -> Params:
    return gqa_init(gen, d, n_heads, n_heads, head_dim, device=device, lead=lead)


def cross_forward(x: torch.Tensor, enc: torch.Tensor, p: Params, *, n_heads: int,
                  head_dim: int) -> torch.Tensor:
    """Decoder->encoder attention; no mask (encoder fully visible), no RoPE."""
    B, S, _ = x.shape
    T = enc.shape[1]
    q = _split_heads(dense(x, p["wq"]), n_heads)
    k = _split_heads(dense(enc.to(x.dtype), p["wk"]), n_heads)
    v = _split_heads(dense(enc.to(x.dtype), p["wv"]), n_heads)
    out = _sdpa(q, k, v, torch.ones((S, T), dtype=torch.bool, device=x.device))
    return dense(out.reshape(B, S, -1), p["wo"])
