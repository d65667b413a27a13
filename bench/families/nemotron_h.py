"""The ``nemotron_h`` family (NVIDIA Nemotron 3 Nano 30B-A3B): pre-norm
residual layers ``h <- h + mixer(rmsnorm(h))`` (RMSNorm eps 1e-6) of three
kinds, in the order of ``hybrid_override_pattern``'s first
``num_hidden_layers`` letters:

* ``M``, Mamba2: separate z, x, BC and dt projections, causal depthwise conv
  (width 4, with a bias) and SiLU over ``[x | B | C]``, ``dt = softplus(x
  wdt + dt_bias)``, the SSD scan with ``A = -exp(A_log)`` and skip ``D``
  chunk by chunk (B and C shared by the heads of each of ``n_groups``
  groups), the gated norm ``g * RMS_group(y * silu(z))`` over each of the
  ``n_groups`` groups, out projection;
* ``E``, experts: float32 router logits over all
  ``published.n_routed_experts``, a sigmoid score each, the top
  ``num_experts_per_tok`` scores chosen, their weights the chosen scores
  over their sum (+1e-20) times ``routed_scaling_factor``; non-gated
  ``relu(x W_up)^2 W_down`` experts.  This device holds
  ``n_routed_experts`` of them from ``first_expert`` and adds their outputs,
  weighted; the shared expert (``moe_shared_expert_intermediate_size``) is
  added once.  Loss terms: ``0.01 x`` the Switch balance ``E sum_e
  mean_t(s_te / sum_e' s_te') x (tokens choosing e) / T`` on the sigmoid
  scores ``s`` and ``1e-3 x`` the z-loss ``mean_t logsumexp(logits)^2``;
* ``*``, attention: GQA with ``num_attention_heads`` query and
  ``num_key_value_heads`` KV heads of ``head_dim``, no position encoding
  (Nemotron-H's attention is Jamba's, which applies none), full causal
  softmax over ``S x S``, taken a KV head's query group at a time.

The model's layers run as one period, the block leaves stacked under
``blocks/<kind>`` with leading axes ``(1, layers of the kind)``.  Start:
the conv scaled by 0.1 and its bias 0, ``A_log = log(linspace(1, 16, H))``,
``D = 1``, ``dt_bias`` the inverse softplus of ``dt`` log-spaced over
``[time_step_min, time_step_max]`` across the heads (the published init
draws it).  Departures from the published model, which the program shares:
RMSNorm eps 1e-6 (1e-5 published); ``e_score_correction_bias`` held at its
initial 0 (not moved by the aux-loss-free rule), so the choice is the top
scores themselves; the loss terms above stand in for the published
balancing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.model import dense, rmsnorm, ssd_scan

STACKS = {"M": "mamba", "E": "moe", "*": "attn"}


def _pattern(cfg: dict) -> str:
    return cfg["hybrid_override_pattern"][:cfg["num_hidden_layers"]]


def _counts(cfg: dict) -> dict:
    """Layers of each stack, in the order the pattern first names them."""
    out: dict = {}
    for letter in _pattern(cfg):
        out[STACKS[letter]] = out.get(STACKS[letter], 0) + 1
    return out


def _router_width(cfg: dict) -> int:
    return cfg["published"]["n_routed_experts"]


def _ssm(cfg: dict) -> dict:
    return {"d_inner": cfg["mamba_num_heads"] * cfg["mamba_head_dim"],
            "d_state": cfg["ssm_state_size"], "n_heads": cfg["mamba_num_heads"],
            "n_groups": cfg["n_groups"], "chunk": cfg["chunk_size"], "gate_first": True}


def arch(cfg: dict) -> dict:
    fe, fs = cfg["moe_intermediate_size"], cfg["moe_shared_expert_intermediate_size"]
    if fs % fe:
        raise ValueError(f"the shared expert's width {fs} is no whole number of experts {fe}")
    return {
        "head_dim": cfg["head_dim"], "layer_pattern": _pattern(cfg), "rope": False,
        "ssm": _ssm(cfg),
        # one shared expert of ``fs`` is ``fs // fe`` of the experts' width: the
        # same relu^2 function
        "moe": {"n_routed": _router_width(cfg), "n_shared": fs // fe,
                "top_k": cfg["num_experts_per_tok"], "d_expert": fe, "capacity_factor": None,
                "dense_layers": [], "norm_topk": cfg["norm_topk_prob"], "score": "sigmoid",
                "routed_scale": cfg["routed_scaling_factor"], "act": "relu2",
                "first_held": cfg["first_expert"], "n_held": cfg["n_routed_experts"]},
    }


def a_log(shape, device):
    row = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32, device=device))
    return row.expand(shape).clone()


def make_dt_bias(cfg: dict):
    """``dt_bias`` as the inverse softplus of ``dt`` log-spaced over
    ``[time_step_min, time_step_max]`` across the heads (floored at
    ``time_step_floor``)."""
    def dt_bias(shape, device):
        lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
        dt = torch.exp(torch.linspace(lo, hi, shape[-1], dtype=torch.float32, device=device))
        dt = dt.clamp(min=cfg["time_step_floor"])
        return (dt + torch.log(-torch.expm1(-dt))).expand(shape).clone()
    return dt_bias


def layout(cfg: dict, proj) -> dict:
    d, counts = cfg["d_model"], _counts(cfg)
    out = {}
    if "mamba" in counts:
        s = _ssm(cfg)
        lead = (1, counts["mamba"])
        di, h, bc = s["d_inner"], s["n_heads"], 2 * s["n_groups"] * s["d_state"]
        k = cfg["conv_kernel"]
        out.update({
            "blocks/mamba/ln": ((*lead, d), "ones"),
            "blocks/mamba/mixer/wz": proj(d, di, lead),
            "blocks/mamba/mixer/wx": proj(d, di, lead),
            "blocks/mamba/mixer/wbc": proj(d, bc, lead),
            "blocks/mamba/mixer/wdt": proj(d, h, lead),
            "blocks/mamba/mixer/conv_w": ((*lead, k, di + bc), 0.1),
            "blocks/mamba/mixer/conv_b": ((*lead, di + bc), "zeros"),
            "blocks/mamba/mixer/A_log": ((*lead, h), a_log),
            "blocks/mamba/mixer/D": ((*lead, h), "ones"),
            "blocks/mamba/mixer/dt_bias": ((*lead, h), make_dt_bias(cfg)),
            "blocks/mamba/mixer/norm_g": ((*lead, di), "ones"),
            "blocks/mamba/mixer/out_proj": proj(di, d, lead),
        })
    if "moe" in counts:
        lead = (1, counts["moe"])
        fe, fs = cfg["moe_intermediate_size"], cfg["moe_shared_expert_intermediate_size"]
        held = lead + (cfg["n_routed_experts"],)
        out.update({
            "blocks/moe/ln": ((*lead, d), "ones"),
            "blocks/moe/ffn/router": ((*lead, d, _router_width(cfg)), 0.02),
            "blocks/moe/ffn/experts/wi": proj(d, fe, held),
            "blocks/moe/ffn/experts/wo": proj(fe, d, held),
            "blocks/moe/ffn/shared/wi": proj(d, fs, lead),
            "blocks/moe/ffn/shared/wo": proj(fs, d, lead),
        })
    if "attn" in counts:
        lead = (1, counts["attn"])
        h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        out.update({
            "blocks/attn/ln": ((*lead, d), "ones"),
            "blocks/attn/attn/wq": proj(d, h * hd, lead),
            "blocks/attn/attn/wk": proj(d, kv * hd, lead),
            "blocks/attn/attn/wv": proj(d, kv * hd, lead),
            "blocks/attn/attn/wo": proj(h * hd, d, lead),
        })
    return out


def _layer_params(cfg: dict) -> dict:
    """A layer's parameters that a token's matrix products use, by stack:
    the held experts at their expected share of a token, ``top_k x held /
    router width`` experts, each ``2 d f``."""
    d, s = cfg["d_model"], _ssm(cfg)
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    expert = 2 * d * cfg["moe_intermediate_size"]
    return {
        "mamba": d * (2 * s["d_inner"] + 2 * s["n_groups"] * s["d_state"] + s["n_heads"])
        + s["d_inner"] * d,
        "moe": d * _router_width(cfg) + 2 * d * cfg["moe_shared_expert_intermediate_size"]
        + cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / _router_width(cfg) * expert,
        "attn": d * h * hd + 2 * d * kv * hd + h * hd * d,
    }


def matmul_params_per_layer(cfg: dict) -> list:
    per = _layer_params(cfg)
    return [per[STACKS[letter]] for letter in _pattern(cfg)]


def mixer_flops_per_token(cfg: dict, seq_len: int) -> list:
    """Forward and backward: the SSD scan's chunk products, ``3 x (2 L N G +
    2 L H P + 4 H P N)`` for chunk ``L``, state ``N``, ``G`` groups and
    ``H`` heads of ``P`` (the scores ``C B^T`` once a group); attention's two
    products over the full ``S x S`` square, ``12 S H D``; none for the
    experts."""
    s = _ssm(cfg)
    chunk, n, g, h = s["chunk"], s["d_state"], s["n_groups"], s["n_heads"]
    p = s["d_inner"] // h
    per = {"mamba": 3.0 * (2 * chunk * n * g + 2 * chunk * h * p + 4 * h * p * n),
           "moe": 0.0,
           "attn": 12.0 * seq_len * cfg["num_attention_heads"] * cfg["head_dim"]}
    return [per[STACKS[letter]] for letter in _pattern(cfg)]


def mamba2(u, p, cfg: dict, precision: str):
    s = _ssm(cfg)
    b, seq, _ = u.shape
    di, n, h, g = s["d_inner"], s["d_state"], s["n_heads"], s["n_groups"]
    z = dense(u, p["wz"], precision)
    xbc = torch.cat([dense(u, p["wx"], precision), dense(u, p["wbc"], precision)], dim=-1)
    k = p["conv_w"].shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, i:i + seq] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(conv + p["conv_b"])
    x = xbc[..., :di].reshape(b, seq, h, di // h)
    bm = xbc[..., di:di + g * n].reshape(b, seq, g, n)
    cm = xbc[..., di + g * n:].reshape(b, seq, g, n)
    dt = F.softplus(dense(u, p["wdt"], precision) + p["dt_bias"])
    y = ssd_scan(x, dt, p["A_log"], bm, cm, p["D"], s["chunk"]).reshape(b, seq, di)
    y = (y * F.silu(z)).reshape(b, seq, g, di // g)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return dense(y.reshape(b, seq, di) * p["norm_g"], p["out_proj"], precision)


def relu2(x, p, precision: str):
    return dense(torch.square(F.relu(dense(x, p["wi"], precision))), p["wo"], precision)


def experts(x, p, cfg: dict, precision: str):
    """The expert layer on x (B, S, d): its output and loss terms."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    width, k = _router_width(cfg), cfg["num_experts_per_tok"]
    logits = dense(flat, p["router"], precision)
    scores = torch.sigmoid(logits)
    chosen = torch.topk(scores, k, dim=-1).indices
    weight = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    weight = weight * cfg["routed_scaling_factor"]
    out = torch.zeros_like(flat)
    for j in range(p["experts"]["wi"].shape[0]):
        hit = chosen == cfg["first_expert"] + j                            # (T, k)
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if not len(rows):
            continue
        one = {name: w[j] for name, w in p["experts"].items()}
        y = relu2(flat[rows], one, precision) * (weight * hit).sum(dim=-1)[rows, None]
        out = out.index_add(0, rows, y)
    out = out + relu2(flat, p["shared"], precision)
    chose = F.one_hot(chosen, width).sum(dim=1).to(torch.float32)          # (T, E)
    gates = scores / scores.sum(dim=-1, keepdim=True)
    balance = width * torch.sum(gates.mean(dim=0) * chose.mean(dim=0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(b, s, d), 0.01 * balance + 1e-3 * z


def attention(x, p, cfg: dict, precision: str):
    b, s, _ = x.shape
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    q = dense(x, p["wq"], precision).reshape(b, s, kv, h // kv, hd)
    keys = dense(x, p["wk"], precision).reshape(b, s, kv, hd)
    values = dense(x, p["wv"], precision).reshape(b, s, kv, hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    outs = []
    for j in range(kv):
        scores = torch.einsum("bsgd,btd->bgst", q[:, :, j], keys[:, :, j]) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        outs.append(torch.einsum("bgst,btd->bsgd", torch.softmax(scores, dim=-1),
                                 values[:, :, j]))
    out = torch.stack(outs, dim=2)                                         # (b, s, kv, g, hd)
    return dense(out.reshape(b, s, h * hd), p["wo"], precision)


def _take(tree, j: int):
    if isinstance(tree, dict):
        return {k: _take(v, j) for k, v in tree.items()}
    return tree[j]


def block(h, lp, cfg: dict, precision: str):
    """One period: the pattern's layers in turn, each kind's next layer."""
    taken = dict.fromkeys(lp, 0)
    aux = 0.0
    for letter in _pattern(cfg):
        stack = STACKS[letter]
        layer = _take(lp[stack], taken[stack])
        taken[stack] += 1
        x = rmsnorm(h, layer["ln"])
        if stack == "mamba":
            h = h + mamba2(x, layer["mixer"], cfg, precision)
        elif stack == "moe":
            y, extra = experts(x, layer["ffn"], cfg, precision)
            h, aux = h + y, aux + extra
        else:
            h = h + attention(x, layer["attn"], cfg, precision)
    return h, aux
