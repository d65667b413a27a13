"""Plain float32 forward passes and losses of the benchmark's model families.

Written from the architectures' equations, in float32 with TF32 off, on
parameter trees keyed as the configuration file's families name them:

* ``dense`` (granite-3-2b): pre-norm decoder layers, RMSNorm (eps 1e-6),
  grouped-query causal attention with rotary embeddings (rotate-half form,
  base ``rope_theta``), SwiGLU MLP ``wo(silu(x wg) * (x wi))``;
* ``ssm`` (mamba2-370m): pre-norm Mamba2 mixers: separate z, x, BC and dt
  projections, causal depthwise conv (width 4) and SiLU over ``[x | B | C]``,
  ``dt = softplus(x wdt + dt_bias)``, the SSD scan with ``A = -exp(A_log)``
  and skip ``D`` evaluated chunk by chunk (intra-chunk quadratic form plus
  the carried state), RMSNorm (eps 1e-6) gated by ``silu(z)``, out
  projection.

Both end in a final RMSNorm and an untied LM head over the vocabulary padded
to a multiple of 256, and the loss is the mean token cross-entropy over
those padded columns.  Departures from the published models, which the
program shares: granite-3.0's embedding, attention, residual and logit
multipliers and its tied embeddings are left out; the conv has a bias and no
group norm over heads.

``precision="fp8"`` is the control: every projection runs on float8 operands
(e4m3 forward, e5m2 gradients, each tensor scaled by its absolute maximum),
as a float8 training recipe would, and the rest stays float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_FORWARD = torch.float8_e4m3fn
FP8_BACKWARD = torch.float8_e5m2


def _fake_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fake_fp8(x, FP8_FORWARD), _fake_fp8(w, FP8_FORWARD)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _fake_fp8(gy, FP8_BACKWARD)
        gx = gq @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1) @ gq.reshape(-1, gq.shape[-1]))
        return gx, gw


def _dense(x, w, precision: str):
    if precision == "fp8":
        return _Fp8Dense.apply(x, w)
    return x @ w


def _rmsnorm(x, g, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def _rope(x, theta: float):
    """x (B, S, H, D), rotate-half with frequencies ``theta^(-2i/D)``."""
    d, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(x, p, cfg: dict, precision: str):
    b, s, _ = x.shape
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["d_model"] // h
    q = _rope(_dense(x, p["wq"], precision).reshape(b, s, h, hd), cfg["rope_theta"])
    k = _rope(_dense(x, p["wk"], precision).reshape(b, s, kv, hd), cfg["rope_theta"])
    v = _dense(x, p["wv"], precision).reshape(b, s, kv, hd)
    # query head j reads key/value head j // (h // kv)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    return _dense(out.reshape(b, s, h * hd), p["wo"], precision)


def _swiglu(x, p, precision: str):
    return _dense(F.silu(_dense(x, p["wg"], precision)) * _dense(x, p["wi"], precision),
                  p["wo"], precision)


def ssd_scan(x, dt, a_log, bm, cm, d_skip, chunk: int):
    """y_t = sum_{s <= t} C_t . B_s * exp(sum_{s < r <= t} dt_r A) * dt_s * x_s
    + D x_t, in chunks of ``chunk`` positions.  x (b,S,H,P), dt (b,S,H),
    B/C (b,S,G,N) shared by the H // G heads of a group."""
    b, s, h, p = x.shape
    rep = h // bm.shape[2]
    bh, ch = bm.repeat_interleave(rep, dim=2), cm.repeat_interleave(rep, dim=2)
    decay = -torch.exp(a_log)
    state = torch.zeros((b, h, p, bm.shape[3]), dtype=torch.float32, device=x.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        xk, dtk = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bk, ck = bh[:, c0:c0 + chunk], ch[:, c0:c0 + chunk]
        n = xk.shape[1]
        cum = torch.cumsum(dtk * decay, dim=1)                            # (b,n,H)
        seg = cum.transpose(1, 2)[..., :, None] - cum.transpose(1, 2)[..., None, :]
        seg = seg.masked_fill(~tri[:n, :n], float("-inf"))                # (b,H,t,s)
        xdt = xk * dtk[..., None]
        within = torch.einsum("bthn,bshn->bhts", ck, bk) * torch.exp(seg)
        y = torch.einsum("bhts,bshp->bthp", within, xdt)
        y = y + torch.einsum("bthn,bhpn->bthp", ck, state) * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:, :] - cum)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bshn,bshp,bsh->bhpn", bk, xdt, to_end)
        ys.append(y)
    return torch.cat(ys, dim=1) + x * d_skip[None, None, :, None]


def _mamba2(u, p, cfg: dict, precision: str):
    ssm = cfg["ssm"]
    b, s, _ = u.shape
    di, n, h, g = ssm["d_inner"], ssm["d_state"], ssm["n_heads"], ssm["n_groups"]
    z = _dense(u, p["wz"], precision)
    xbc = torch.cat([_dense(u, p["wx"], precision), _dense(u, p["wbc"], precision)], dim=-1)
    k = p["conv_w"].shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, i:i + s] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(conv + p["conv_b"])
    x = xbc[..., :di].reshape(b, s, h, di // h)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(_dense(u, p["wdt"], precision) + p["dt_bias"])
    y = ssd_scan(x, dt, p["A_log"], bm, cm, p["D"], ssm["chunk"]).reshape(b, s, di)
    y = _rmsnorm(y, p["norm_g"]) * F.silu(z)
    return _dense(y, p["out_proj"], precision)


def loss(cfg: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         precision: str = "f32") -> torch.Tensor:
    """Mean token cross-entropy of one node's batch (B, S)."""
    h = params["embed"][tokens]
    blocks = params["blocks"]
    for layer in range(cfg["n_layers"]):
        lp = {k: (v[layer] if not isinstance(v, dict) else {kk: vv[layer] for kk, vv in v.items()})
              for k, v in blocks.items()}
        if cfg["family"] == "ssm":
            h = h + _mamba2(_rmsnorm(h, lp["ln"]), lp["mixer"], cfg, precision)
        else:
            h = h + _attention(_rmsnorm(h, lp["ln1"]), lp["attn"], cfg, precision)
            h = h + _swiglu(_rmsnorm(h, lp["ln2"]), lp["ffn"], precision)
    logits = _dense(_rmsnorm(h, params["final_ln"]), params["lm_head"], precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
