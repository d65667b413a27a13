"""Plain float32 forward passes and losses of the benchmark's models.

Written from the architectures' equations, in float32 with TF32 off, on
parameter trees as :mod:`bench.weights` lays them out: the embedding, the
layers of the configuration's family (``bench/families/<family>.py``
``block``, one layer at a time, stack by stack), a final RMSNorm (eps 1e-6)
and an untied LM head over the vocabulary padded to a multiple of 256.  The
loss is the mean token cross-entropy over those padded columns, plus the
loss terms the layers add.

The primitives the families share live here: :func:`dense` (a projection,
or the float8 control's), :func:`rmsnorm`, :func:`rope` (rotate-half),
:func:`swiglu` and :func:`ssd_scan`.

``precision="fp8"`` is the control: every projection runs on float8 operands
(e4m3 forward, e5m2 gradients, each tensor scaled by its absolute maximum),
as a float8 training recipe would, and the rest stays float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import families, weights

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


def dense(x, w, precision: str):
    """``x @ w``, or on float8 operands for the control."""
    if precision == "fp8":
        return _Fp8Dense.apply(x, w)
    return x @ w


def rmsnorm(x, g, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x, theta: float):
    """x (B, S, H, D), rotate-half with frequencies ``theta^(-2i/D)``."""
    d, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x, p, precision: str):
    return dense(F.silu(dense(x, p["wg"], precision)) * dense(x, p["wi"], precision),
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


def _layers(cfg: dict, params: dict):
    """Each layer's parameters in the order the layers run: the stacks (the
    top-level groups of block leaves, each over a leading layer axis) in the
    order the layout first names them, each layer by layer."""
    stacks = dict.fromkeys(p.split("/")[0] for p in weights.layout(cfg) if "/" in p)
    for stack in stacks:
        tree = params[stack]
        first = tree
        while isinstance(first, dict):
            first = next(iter(first.values()))
        for layer in range(first.shape[0]):
            yield _slice(tree, layer)


def _slice(tree, layer: int):
    if isinstance(tree, dict):
        return {k: _slice(v, layer) for k, v in tree.items()}
    return tree[layer]


def loss(cfg: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         precision: str = "f32") -> torch.Tensor:
    """Mean token cross-entropy of one node's batch (B, S), plus the layers'
    loss terms."""
    family = families.of(cfg)
    h, aux = params["embed"][tokens], 0.0
    for lp in _layers(cfg, params):
        h, extra = family.block(h, lp, cfg, precision)
        aux = aux + extra
    logits = dense(rmsnorm(h, params["final_ln"]), params["lm_head"], precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)) + aux
