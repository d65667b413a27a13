"""The ``dense`` family (granite-3-2b): pre-norm decoder layers, RMSNorm
(eps 1e-6), grouped-query causal attention with rotary embeddings
(rotate-half form, base ``rope_theta``), SwiGLU MLP ``wo(silu(x wg) * (x wi))``.

Departures from the published granite, which the program shares: its
embedding, attention, residual and logit multipliers and its tied
embeddings are left out.
"""
from __future__ import annotations

import math

import torch

from bench.reference.model import dense, rmsnorm, rope, swiglu


def arch(cfg: dict) -> dict:
    return {}


def layout(cfg: dict, proj) -> dict:
    d, layers = cfg["d_model"], cfg["n_layers"]
    hd = d // cfg["n_heads"]
    return {
        "blocks/ln1": ((layers, d), "ones"),
        "blocks/attn/wq": proj(d, cfg["n_heads"] * hd),
        "blocks/attn/wk": proj(d, cfg["n_kv_heads"] * hd),
        "blocks/attn/wv": proj(d, cfg["n_kv_heads"] * hd),
        "blocks/attn/wo": proj(cfg["n_heads"] * hd, d),
        "blocks/ln2": ((layers, d), "ones"),
        "blocks/ffn/wi": proj(d, cfg["d_ff"]),
        "blocks/ffn/wg": proj(d, cfg["d_ff"]),
        "blocks/ffn/wo": proj(cfg["d_ff"], d),
    }


def matmul_params_per_layer(cfg: dict) -> list:
    d = cfg["d_model"]
    hd = d // cfg["n_heads"]
    per_layer = d * (cfg["n_heads"] + 2 * cfg["n_kv_heads"]) * hd \
        + cfg["n_heads"] * hd * d + 3 * d * cfg["d_ff"]
    return [per_layer] * cfg["n_layers"]


def mixer_flops_per_token(cfg: dict, seq_len: int) -> list:
    """Attention's two products over the full ``S x S`` square, forward and
    backward: ``12 S d_attn``."""
    return [12.0 * seq_len * cfg["n_heads"] * (cfg["d_model"] // cfg["n_heads"])] \
        * cfg["n_layers"]


def attention(x, p, cfg: dict, precision: str):
    b, s, _ = x.shape
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["d_model"] // h
    q = rope(dense(x, p["wq"], precision).reshape(b, s, h, hd), cfg["rope_theta"])
    k = rope(dense(x, p["wk"], precision).reshape(b, s, kv, hd), cfg["rope_theta"])
    v = dense(x, p["wv"], precision).reshape(b, s, kv, hd)
    # query head j reads key/value head j // (h // kv)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    return dense(out.reshape(b, s, h * hd), p["wo"], precision)


def block(h, lp, cfg: dict, precision: str):
    h = h + attention(rmsnorm(h, lp["ln1"]), lp["attn"], cfg, precision)
    h = h + swiglu(rmsnorm(h, lp["ln2"]), lp["ffn"], precision)
    return h, 0.0
