"""Mamba2 (SSD, state-space duality) mixer block [arXiv:2405.21060].

The port of the JAX package's ``models/ssm.py``: the chunked SSD algorithm
for training and prefill (chunk-local quadratic form plus an inter-chunk
recurrence), a constant-state recurrent step for decode, and the naive
sequential oracle the tests hold the chunked form to.  Plain torch, as the
JAX package is plain jnp; the dtypes follow JAX's promotion (a bf16
activation meeting a float32 state computes in float32).

Layout: x (B, S, H, P) heads, A (H,) negative decay, B/C (B, S, G, N) groups
broadcast over heads, dt (B, S, H) softplus-positive step sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense, dense_init
from repro_torch.trace import span


@dataclasses.dataclass
class SSMCache:
    h: torch.Tensor          # (L, B, H, P, N) float32 state
    conv: torch.Tensor       # (L, B, K-1, Dconv) conv tail
    pos: int


def ssm_init(gen: torch.Generator, d: int, *, d_inner: int, d_state: int, n_heads: int,
             n_groups: int = 1, d_conv: int = 4, device, lead: tuple = ()) -> Params:
    """Separate z/x/BC/dt projections, as in the JAX package."""
    d_bc = 2 * n_groups * d_state
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32, device=device))
    return {
        "wz": dense_init(gen, d, d_inner, device=device, lead=lead),        # gate
        "wx": dense_init(gen, d, d_inner, device=device, lead=lead),        # ssm input
        "wbc": dense_init(gen, d, d_bc, device=device, lead=lead),          # B and C
        "wdt": dense_init(gen, d, n_heads, device=device, lead=lead),       # step sizes
        "conv_w": torch.randn(lead + (d_conv, d_inner + d_bc), generator=gen, device=device,
                              dtype=torch.float32).mul_(0.1),               # depthwise K=4
        "conv_b": torch.zeros(lead + (d_inner + d_bc,), dtype=torch.float32, device=device),
        "A_log": a_log.expand(lead + (n_heads,)).clone(),                   # A = -exp(A_log)
        "D": torch.ones(lead + (n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.full(lead + (n_heads,), math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=device),
        "norm_g": torch.ones(lead + (d_inner,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, d_inner, d, device=device, lead=lead),
    }


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, D) with kernel (K, D), then SiLU."""
    K = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def _segsum(lg: torch.Tensor) -> torch.Tensor:
    """lg (..., L): pairwise decay exponents ``out[t, s] = sum_{s < r <= t} lg[r]``."""
    L = lg.shape[-1]
    cs = torch.cumsum(lg, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                       # t, s
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=lg.device))
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, h0: Optional[torch.Tensor] = None):
    """SSD scan.  x (b,S,H,P), dt (b,S,H), A (H,), B/C (b,S,G,N), D (H,).

    Returns y (b,S,H,P) and the final state (b,H,P,N) in float32.
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(B, rep, dim=2)                      # (b,S,H,N)
    Ch = torch.repeat_interleave(C, rep, dim=2)
    pad = (-S) % chunk
    xp = x
    if pad:
        xp = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    L = chunk
    nc = xp.shape[1] // L
    decay = -torch.exp(A.to(torch.float32))
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        xk, dtk, Bk, Ck = xp[:, sl], dt[:, sl], Bh[:, sl], Ch[:, sl]
        lgk = dtk * decay                                            # (b,L,H) log decay, f32
        xdtk = xk * dtk[..., None]
        csum = torch.cumsum(lgk, dim=1)                              # (b,L,H)
        # intra-chunk (dual quadratic form within the chunk)
        Ldec = torch.exp(_segsum(lgk.transpose(1, 2)))               # (b,H,L,L)
        scores = torch.einsum("blhn,bshn->bhls", Ck, Bk) * Ldec.to(Ck.dtype)
        y_intra = torch.einsum("bhls,bshp->blhp", scores, xdtk)
        # contribution of the carried-in state
        dec_in = torch.exp(csum)                                     # (b,L,H)
        y_inter = torch.einsum("blhn,bhpn,blh->blhp", Ck, h.to(Ck.dtype),
                               dec_in.to(Ck.dtype))
        # new carried state: decay the old state over the chunk, add the
        # chunk's outer products
        dec_out = torch.exp(csum[:, -1:, :] - csum)                  # (b,L,H) decay l -> end
        h_add = torch.einsum("blhn,blhp,blh->bhpn", Bk, xdtk, dec_out.to(Bk.dtype))
        chunk_decay = torch.exp(csum[:, -1])[:, :, None, None]       # (b,H,1,1)
        h = h * chunk_decay + h_add.to(torch.float32)
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + x * D.to(y.dtype)[None, None, :, None]
    return y, h


def ssd_recurrent_ref(x, dt, A, B, C, D, h0: Optional[torch.Tensor] = None):
    """Naive O(S) sequential oracle (float32), the ground truth for
    :func:`ssd_chunked`."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(B, rep, dim=2).to(torch.float32)
    Ch = torch.repeat_interleave(C, rep, dim=2).to(torch.float32)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    a = torch.exp(dtf * (-torch.exp(A.to(torch.float32))))           # (b,S,H)
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.to(torch.float32)
    ys = []
    for t in range(S):
        h = h * a[:, t, :, None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", Bh[:, t], xf[:, t], dtf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1) + xf * D.to(torch.float32)[None, None, :, None]
    return y.to(x.dtype), h


# ------------------------------------------------------------------ full mixer block

def _project(u, p):
    """-> gate z, conv input [x|BC], dt logits."""
    z = dense(u, p["wz"])
    xbc = torch.cat([dense(u, p["wx"]), dense(u, p["wbc"])], dim=-1)
    dt = dense(u, p["wdt"])
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor, n_groups: int,
                gate_first: bool, dtype) -> torch.Tensor:
    """The mixer's gated RMSNorm (eps 1e-6) of y (..., d_inner) by the gate
    z, in ``dtype``: norm before gate, ``(RMS(y) * g) * silu(z)`` over the
    whole width; or with ``gate_first`` the published Mamba2 norm, ``g *
    RMS(y * silu(z))`` over each of ``n_groups`` groups, in float32."""
    if not gate_first:
        yf = y.to(torch.float32)
        yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
        return (yf * g).to(dtype) * F.silu(z)
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    yg = yf.reshape(*yf.shape[:-1], n_groups, yf.shape[-1] // n_groups)
    yg = yg * torch.rsqrt(torch.mean(yg * yg, dim=-1, keepdim=True) + 1e-6)
    return (yg.reshape(yf.shape) * g).to(dtype)


def mamba_forward(u: torch.Tensor, p: Params, *, d_inner: int, d_state: int,
                  n_heads: int, n_groups: int = 1, chunk: int = 128,
                  h0: Optional[torch.Tensor] = None, return_state: bool = False,
                  gate_first: bool = False):
    """u (B, S, d) -> (B, S, d).  The Mamba2 mixer: proj -> conv -> SSD ->
    gated RMSNorm (:func:`_gated_norm`) -> out, inside the span
    ``model.ssm``."""
    with span("model.ssm"):
        B_, S, _ = u.shape
        P = d_inner // n_heads
        z, xbc, dt_raw = _project(u, p)
        xbc = _depthwise_conv(xbc, p["conv_w"], p["conv_b"])
        x = xbc[..., :d_inner].reshape(B_, S, n_heads, P)
        Bm = xbc[..., d_inner: d_inner + n_groups * d_state].reshape(B_, S, n_groups, d_state)
        Cm = xbc[..., d_inner + n_groups * d_state:].reshape(B_, S, n_groups, d_state)
        dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"]).to(u.dtype)
        y, h_fin = ssd_chunked(x, dt, p["A_log"], Bm, Cm, p["D"], chunk=chunk, h0=h0)
        y = _gated_norm(y.reshape(B_, S, d_inner), z, p["norm_g"], n_groups, gate_first,
                        u.dtype)
        out = dense(y, p["out_proj"])
    if return_state:
        return out, h_fin
    return out


def mamba_init_cache(B: int, *, d_inner: int, d_state: int, n_heads: int,
                     n_groups: int = 1, d_conv: int = 4, dtype=torch.float32,
                     device, lead: tuple = ()) -> SSMCache:
    P = d_inner // n_heads
    d_bc = 2 * n_groups * d_state
    return SSMCache(
        h=torch.zeros(lead + (B, n_heads, P, d_state), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (B, d_conv - 1, d_inner + d_bc), dtype=dtype, device=device),
        pos=0,
    )


def mamba_decode(u: torch.Tensor, cache: SSMCache, p: Params, *, d_inner: int, d_state: int,
                 n_heads: int, n_groups: int = 1,
                 gate_first: bool = False) -> Tuple[torch.Tensor, SSMCache]:
    """One-token recurrent step, u (B, 1, d); writes one layer's state (B,
    H, P, N) and conv tail (B, K-1, D) in place and returns the output and
    the cache with the position advanced.  As in JAX, the float32 conv tail
    meeting the bf16 projection makes the conv and everything after it
    float32 until the output cast."""
    B_ = u.shape[0]
    h_cache, conv_cache = cache.h, cache.conv
    P = d_inner // n_heads
    z, xbc, dt_raw = _project(u[:, 0], p)                            # (B, ...)
    # conv over [cached K-1 inputs, current]
    dt_conv = torch.promote_types(conv_cache.dtype, xbc.dtype)
    hist = torch.cat([conv_cache.to(dt_conv), xbc[:, None].to(dt_conv)], dim=1)  # (B, K, D)
    w = p["conv_w"].to(u.dtype).to(dt_conv)
    conv = torch.einsum("bkd,kd->bd", hist, w)
    xbc_c = F.silu(conv + p["conv_b"].to(u.dtype).to(dt_conv))
    x = xbc_c[..., :d_inner].reshape(B_, n_heads, P)
    Bm = xbc_c[..., d_inner: d_inner + n_groups * d_state].reshape(B_, n_groups, d_state)
    Cm = xbc_c[..., d_inner + n_groups * d_state:].reshape(B_, n_groups, d_state)
    rep = n_heads // n_groups
    Bh = torch.repeat_interleave(Bm, rep, dim=1).to(torch.float32)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])        # (B, H)
    a = torch.exp(dt * (-torch.exp(p["A_log"])))
    h = h_cache * a[..., None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", Bh, x.to(torch.float32), dt)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + x.to(torch.float32) * p["D"][None, :, None]
    y = _gated_norm(y.reshape(B_, d_inner), z, p["norm_g"], n_groups, gate_first, u.dtype)
    out = dense(y[:, None], p["out_proj"])
    h_cache.copy_(h)
    conv_cache.copy_(hist[:, 1:].to(conv_cache.dtype))
    return out, dataclasses.replace(cache, pos=cache.pos + 1)
