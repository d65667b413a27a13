"""The ``ssm`` family (mamba2-370m): pre-norm Mamba2 mixers: separate z, x,
BC and dt projections, causal depthwise conv (width 4) and SiLU over
``[x | B | C]``, ``dt = softplus(x wdt + dt_bias)``, the SSD scan with
``A = -exp(A_log)`` and skip ``D`` evaluated chunk by chunk, RMSNorm (eps
1e-6) gated by ``silu(z)``, out projection.

Its start is the usual Mamba2 one: the conv scaled by 0.1 and its bias 0,
``A_log = log(linspace(1, 16, H))``, ``D = 1``, ``dt_bias =
log(expm1(0.01))``.  Departures from the published model, which the
program shares: the conv has a bias and no group norm over heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.model import dense, rmsnorm, ssd_scan


def arch(cfg: dict) -> dict:
    return {"ssm": dict(cfg["ssm"])}


def a_log(shape, device):
    row = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32, device=device))
    return row.expand(shape).clone()


def dt_bias(shape, device):
    return torch.full(shape, math.log(math.expm1(0.01)), dtype=torch.float32, device=device)


def layout(cfg: dict, proj) -> dict:
    d, layers, s = cfg["d_model"], cfg["n_layers"], cfg["ssm"]
    di, h, bc = s["d_inner"], s["n_heads"], 2 * s["n_groups"] * s["d_state"]
    return {
        "blocks/ln": ((layers, d), "ones"),
        "blocks/mixer/wz": proj(d, di),
        "blocks/mixer/wx": proj(d, di),
        "blocks/mixer/wbc": proj(d, bc),
        "blocks/mixer/wdt": proj(d, h),
        "blocks/mixer/conv_w": ((layers, 4, di + bc), 0.1),
        "blocks/mixer/conv_b": ((layers, di + bc), "zeros"),
        "blocks/mixer/A_log": ((layers, h), a_log),
        "blocks/mixer/D": ((layers, h), "ones"),
        "blocks/mixer/dt_bias": ((layers, h), dt_bias),
        "blocks/mixer/norm_g": ((layers, di), "ones"),
        "blocks/mixer/out_proj": proj(di, d),
    }


def matmul_params_per_layer(cfg: dict) -> list:
    d, s = cfg["d_model"], cfg["ssm"]
    per_layer = d * (2 * s["d_inner"] + 2 * s["n_groups"] * s["d_state"] + s["n_heads"]) \
        + s["d_inner"] * d
    return [per_layer] * cfg["n_layers"]


def mixer_flops_per_token(cfg: dict, seq_len: int) -> list:
    """The SSD scan's chunk products, forward and backward: ``3 x (2 L N H +
    2 L H P + 4 H P N)`` for chunk ``L``, state ``N``, ``H`` heads of ``P``."""
    s = cfg["ssm"]
    chunk, n, h = s["chunk"], s["d_state"], s["n_heads"]
    p = s["d_inner"] // h
    return [3.0 * (2 * chunk * n * h + 2 * chunk * h * p + 4 * h * p * n)] * cfg["n_layers"]


def mamba2(u, p, cfg: dict, precision: str):
    ssm = cfg["ssm"]
    b, s, _ = u.shape
    di, n, h, g = ssm["d_inner"], ssm["d_state"], ssm["n_heads"], ssm["n_groups"]
    z = dense(u, p["wz"], precision)
    xbc = torch.cat([dense(u, p["wx"], precision), dense(u, p["wbc"], precision)], dim=-1)
    k = p["conv_w"].shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, i:i + s] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(conv + p["conv_b"])
    x = xbc[..., :di].reshape(b, s, h, di // h)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dense(u, p["wdt"], precision) + p["dt_bias"])
    y = ssd_scan(x, dt, p["A_log"], bm, cm, p["D"], ssm["chunk"]).reshape(b, s, di)
    y = rmsnorm(y, p["norm_g"]) * F.silu(z)
    return dense(y, p["out_proj"], precision)


def block(h, lp, cfg: dict, precision: str):
    return h + mamba2(rmsnorm(h, lp["ln"]), lp["mixer"], cfg, precision), 0.0
