"""The ``mla_moe`` family (DeepSeek-V2-Lite): pre-norm decoder layers,
RMSNorm (eps 1e-6), multi-head latent attention, and after the leading dense
layers (SwiGLU of ``intermediate_size``) a mixture of experts.

Attention (no ``q_lora``): ``q = x W_q`` split per head into ``q_nope``
and ``q_rope``; the latent ``c = rmsnorm(x W_dkv)``; ``k_nope = c W_uk``,
``v = c W_uv``; one rope key ``k_rope = x W_kr`` shared by the heads.  Rope
is YaRN's (``rope_scaling``): frequencies ``f_e = theta^(-2i/D)`` below the
ramp, ``f_e / factor`` above it, a linear ramp between the dims that turn
``beta_fast`` and ``beta_slow`` times over the original context; cos and sin
scaled by ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)`` and
the scores by ``mscale(factor, mscale_all_dim)^2 / sqrt(qk_nope + qk_rope)``,
``mscale(s, m) = 0.1 m ln s + 1``.  Full causal softmax over ``S x S``.

Experts: a softmax gate over all ``published.n_routed_experts``, taken in
float32, greedy top ``num_experts_per_tok``, the raw gate values as weights
(``norm_topk_prob`` false), every chosen expert computed (no capacity).
This device holds ``n_routed_experts`` of them from ``first_expert`` and adds
their SwiGLU outputs, weighted; the 2 shared experts (one SwiGLU of twice
the expert width) are added once.  The loss terms of a MoE layer: ``0.01 x``
the Switch load balance ``E sum_e mean_t(gate) x (tokens choosing e) / T``
and ``1e-3 x`` the z-loss ``mean_t logsumexp(logits)^2``, over the batch.

Departures from the published model, which the program shares: rope is
rotate-half where DeepSeek-V2 pairs the rope dims interleaved (with random
weights, a fixed permutation of the rope columns of ``W_q`` and ``W_kr``);
the loss terms above stand in for its sequence-level balance loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.model import dense, rmsnorm, swiglu

YARN_KEYS = ("factor", "original_max_position_embeddings", "beta_fast", "beta_slow", "mscale",
             "mscale_all_dim")


def _dense_layers(cfg: dict) -> int:
    return cfg["first_k_dense_replace"]


def _router_width(cfg: dict) -> int:
    return cfg["published"].get("n_routed_experts", cfg["n_routed_experts"])


def arch(cfg: dict) -> dict:
    return {
        "mla": {"kv_lora": cfg["kv_lora_rank"], "qk_nope": cfg["qk_nope_head_dim"],
                "qk_rope": cfg["qk_rope_head_dim"], "v_head": cfg["v_head_dim"],
                "latent_norm": True,
                "yarn": [cfg["rope_scaling"][k] for k in YARN_KEYS]},
        "moe": {"n_routed": _router_width(cfg), "n_shared": cfg["n_shared_experts"],
                "top_k": cfg["num_experts_per_tok"], "d_expert": cfg["moe_intermediate_size"],
                "capacity_factor": None,
                "dense_layers": list(range(_dense_layers(cfg))),
                "d_ff_dense": cfg["intermediate_size"], "norm_topk": cfg["norm_topk_prob"],
                "first_held": cfg["first_expert"], "n_held": cfg["n_routed_experts"]},
    }


def _attention(stack: str, layers: int, cfg: dict, proj) -> dict:
    d, h = cfg["d_model"], cfg["n_heads"]
    r, nope, rope, v = (cfg[k] for k in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                                         "v_head_dim"))
    lead = (layers,)
    return {
        f"{stack}/ln1": ((layers, d), "ones"),
        f"{stack}/attn/wq": proj(d, h * (nope + rope), lead),
        f"{stack}/attn/wdkv": proj(d, r, lead),
        f"{stack}/attn/wuk": proj(r, h * nope, lead),
        f"{stack}/attn/wuv": proj(r, h * v, lead),
        f"{stack}/attn/wkr": proj(d, rope, lead),
        f"{stack}/attn/wo": proj(h * v, d, lead),
        f"{stack}/attn/kv_norm": ((layers, r), "ones"),
        f"{stack}/ln2": ((layers, d), "ones"),
    }


def layout(cfg: dict, proj) -> dict:
    """``blocks0``: the leading dense layers; ``blocks``: the MoE layers,
    their held experts stacked under ``experts`` (layers, experts, ...)."""
    d = cfg["d_model"]
    dense_n = _dense_layers(cfg)
    moe_n = cfg["n_layers"] - dense_n
    ff, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = fe * cfg["n_shared_experts"]
    held = (moe_n, cfg["n_routed_experts"])
    return {
        **_attention("blocks0", dense_n, cfg, proj),
        "blocks0/ffn/wi": proj(d, ff, (dense_n,)),
        "blocks0/ffn/wg": proj(d, ff, (dense_n,)),
        "blocks0/ffn/wo": proj(ff, d, (dense_n,)),
        **_attention("blocks", moe_n, cfg, proj),
        "blocks/ffn/router": ((moe_n, d, _router_width(cfg)), 0.02),
        "blocks/ffn/experts/wi": proj(d, fe, held),
        "blocks/ffn/experts/wg": proj(d, fe, held),
        "blocks/ffn/experts/wo": proj(fe, d, held),
        "blocks/ffn/shared/wi": proj(d, fs, (moe_n,)),
        "blocks/ffn/shared/wg": proj(d, fs, (moe_n,)),
        "blocks/ffn/shared/wo": proj(fs, d, (moe_n,)),
    }


def _attention_params(cfg: dict) -> int:
    d, h = cfg["d_model"], cfg["n_heads"]
    r, nope, rope, v = (cfg[k] for k in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                                         "v_head_dim"))
    return d * h * (nope + rope) + d * r + r * h * (nope + v) + d * rope + h * v * d


def matmul_params_per_layer(cfg: dict) -> list:
    """A dense layer: attention's projections and its SwiGLU.  A MoE layer:
    attention's projections, the router, the shared experts, and the held
    experts at their expected share of a token, ``top_k x held / router
    width`` experts."""
    d = cfg["d_model"]
    attn = _attention_params(cfg)
    dense_layer = attn + 3 * d * cfg["intermediate_size"]
    expert = 3 * d * cfg["moe_intermediate_size"]
    moe_layer = attn + d * _router_width(cfg) + cfg["n_shared_experts"] * expert \
        + cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / _router_width(cfg) * expert
    return [dense_layer] * _dense_layers(cfg) \
        + [moe_layer] * (cfg["n_layers"] - _dense_layers(cfg))


def mixer_flops_per_token(cfg: dict, seq_len: int) -> list:
    """Attention's two products over the full ``S x S`` square, forward and
    backward: ``6 S H (qk_nope + qk_rope + v_head)``."""
    dims = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    return [6.0 * seq_len * cfg["n_heads"] * dims] * cfg["n_layers"]


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(cfg: dict, device):
    """``(frequencies, cos/sin factor, softmax scale, (low, high))``."""
    y = cfg["rope_scaling"]
    dim, theta = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    old = y["original_max_position_embeddings"]

    def turns(r):
        return dim * math.log(old / (2 * math.pi * r)) / (2 * math.log(theta))

    low = max(math.floor(turns(y["beta_fast"])), 0)
    high = min(math.ceil(turns(y["beta_slow"])), dim - 1)
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    freqs = 1.0 / (y["factor"] * base) * ramp + 1.0 / base * (1 - ramp)
    amp = _mscale(y["factor"], y["mscale"]) / _mscale(y["factor"], y["mscale_all_dim"])
    scale = _mscale(y["factor"], y["mscale_all_dim"]) ** 2 \
        / math.sqrt(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"])
    return freqs, amp, scale, (low, high)


def _rope(x, freqs, amp):
    """x (B, S, H, D), rotate-half at the given frequencies."""
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = (torch.cos(ang) * amp)[:, None, :], (torch.sin(ang) * amp)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, p, cfg: dict, precision: str):
    b, s, _ = x.shape
    h, nope, rope, v = (cfg["n_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                        cfg["v_head_dim"])
    freqs, amp, scale, _ = yarn(cfg, x.device)
    q = dense(x, p["wq"], precision).reshape(b, s, h, nope + rope)
    c = rmsnorm(dense(x, p["wdkv"], precision), p["kv_norm"])
    k_nope = dense(c, p["wuk"], precision).reshape(b, s, h, nope)
    values = dense(c, p["wuv"], precision).reshape(b, s, h, v)
    k_rope = _rope(dense(x, p["wkr"], precision).reshape(b, s, 1, rope), freqs, amp)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], freqs, amp)], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
    scores = torch.einsum("bshd,bthd->bhst", q, k) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), values)
    return dense(out.reshape(b, s, h * v), p["wo"], precision)


def experts(x, p, cfg: dict, precision: str):
    """The MoE layer on x (B, S, d): its output and loss terms."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    width, k = _router_width(cfg), cfg["num_experts_per_tok"]
    logits = dense(flat, p["router"], precision)
    gates = torch.softmax(logits, dim=-1)
    weight, chosen = torch.topk(gates, k, dim=-1)
    if cfg["norm_topk_prob"]:
        weight = weight / weight.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(flat)
    for j in range(p["experts"]["wi"].shape[0]):
        hit = chosen == cfg["first_expert"] + j                            # (T, k)
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if not len(rows):
            continue
        one = {name: w[j] for name, w in p["experts"].items()}
        y = swiglu(flat[rows], one, precision) * (weight * hit).sum(dim=-1)[rows, None]
        out = out.index_add(0, rows, y)
    out = out + swiglu(flat, p["shared"], precision)
    chose = F.one_hot(chosen, width).sum(dim=1).to(torch.float32)          # (T, E)
    balance = width * torch.sum(gates.mean(dim=0) * chose.mean(dim=0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(b, s, d), 0.01 * balance + 1e-3 * z


def block(h, lp, cfg: dict, precision: str):
    h = h + attention(rmsnorm(h, lp["ln1"]), lp["attn"], cfg, precision)
    x = rmsnorm(h, lp["ln2"])
    if "router" in lp["ffn"]:
        y, aux = experts(x, lp["ffn"], cfg, precision)
    else:
        y, aux = swiglu(x, lp["ffn"], precision), 0.0
    return h + y, aux
