"""Grouped-query causal self-attention (the training path).

The port of the GQA path of the JAX package's ``models/attention.py``.  The
JAX package computes attention in plain jnp (einsum, softmax), so this is
plain torch matmul and softmax on the same layout: q (B, S, H, D), k/v
(B, T, KV, D), heads grouped as (KV, G).  The chunked online-softmax path
above ``FLASH_THRESHOLD`` query positions is not ported; sequences that long
raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import Params, apply_rope, dense, dense_init

NEG_INF = -1e9
FLASH_THRESHOLD = 4096


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


def causal_mask(S: int, device) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    return j <= i


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,KV,D), mask (S,T) -> (B,S,H,Dv)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32) / math.sqrt(D)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def gqa_forward(x: torch.Tensor, p: Params, *, n_heads: int, n_kv: int, head_dim: int,
                theta: float) -> torch.Tensor:
    """Causal self-attention over x (B, S, d)."""
    B, S, _ = x.shape
    if S >= FLASH_THRESHOLD:
        raise NotImplementedError(
            f"sequences of {S} >= {FLASH_THRESHOLD} need the chunked attention path, "
            "which is not ported")
    pos = torch.arange(S, device=x.device)
    q = apply_rope(_split_heads(dense(x, p["wq"]), n_heads), pos, theta)
    k = apply_rope(_split_heads(dense(x, p["wk"]), n_kv), pos, theta)
    v = _split_heads(dense(x, p["wv"]), n_kv)
    out = _sdpa(q, k, v, causal_mask(S, x.device))
    return dense(out.reshape(B, S, -1), p["wo"])
