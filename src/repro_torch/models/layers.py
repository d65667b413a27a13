"""Shared neural building blocks: plain functions on tensors plus inits.

The port of the JAX package's ``models/layers.py``.  Compute runs in bf16
with float32 master weights (``layers.py:13``): each function casts a
weight to the activation dtype at use, and the norms, RoPE and the
cross-entropy work in float32, as the JAX versions do.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

COMPUTE_DTYPE = torch.bfloat16


def generator(seed: int, device) -> Optional[torch.Generator]:
    """The init's generator on ``device``, seeded; ``None`` on the meta
    device, which draws nothing (shapes only: the dryrun's parameter
    specs)."""
    if torch.device(device).type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
               scale: Optional[float] = None, lead: tuple = ()) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(lead + (d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...i,io->...o", x, w.astype(x.dtype))``."""
    return torch.matmul(x, w.to(x.dtype))


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``: operands of different float dtypes are promoted to
    their common dtype first (torch's einsum raises instead)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device,
                       dtype=torch.float32).mul_(0.02)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table.astype(bf16)[tokens]``, gathering the rows before the cast
    (the same values, without casting the whole table)."""
    return table[tokens].to(COMPUTE_DTYPE)


def rmsnorm_init(d: int, *, device, lead: tuple = ()) -> torch.Tensor:
    return torch.ones(lead + (d,), dtype=torch.float32, device=device)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.to(torch.float32)
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * g).to(x.dtype)


def layernorm_init(d: int, *, device, lead: tuple = ()) -> Params:
    return {"g": torch.ones(lead + (d,), dtype=torch.float32, device=device),
            "b": torch.zeros(lead + (d,), dtype=torch.float32, device=device)}


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    h = x.to(torch.float32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean((h - mu) ** 2, dim=-1, keepdim=True)
    return ((h - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(x.dtype)


# ----------------------------------------------------------------- MLPs

def swiglu_init(gen: torch.Generator, d: int, d_ff: int, *, device, lead: tuple = ()) -> Params:
    # the draw order follows the JAX key split (wi, wg, wo); the values differ
    return {
        "wi": dense_init(gen, d, d_ff, device=device, lead=lead),
        "wg": dense_init(gen, d, d_ff, device=device, lead=lead),
        "wo": dense_init(gen, d_ff, d, device=device, lead=lead),
    }


def swiglu(x: torch.Tensor, p: Params) -> torch.Tensor:
    return dense(F.silu(dense(x, p["wg"])) * dense(x, p["wi"]), p["wo"])


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int, *, device, lead: tuple = ()) -> Params:
    return {"wi": dense_init(gen, d, d_ff, device=device, lead=lead),
            "wo": dense_init(gen, d_ff, d, device=device, lead=lead)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    return dense(gelu(dense(x, p["wi"])), p["wo"])


def relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (Nemotron-H's ``relu2``)."""
    return torch.square(F.relu(x))


def relu2_mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The non-gated ``relu(x wi)^2 wo`` on :func:`gelu_mlp_init`'s leaves."""
    return dense(relu2(dense(x, p["wi"])), p["wo"])


# ----------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention factor, ``0.1 mscale ln(scale) + 1`` (1 at no scaling)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_range(head_dim: int, theta: float, yarn: Tuple[float, ...]) -> Tuple[int, int]:
    """The frequency indices ``(low, high)`` between which YaRN's ramp runs:
    the rotary dims that turn ``beta_fast`` and ``beta_slow`` times over the
    original context, ``corr(r) = D ln(L / (2 pi r)) / (2 ln theta)``."""
    _, original, beta_fast, beta_slow = yarn[:4]

    def corr(rotations):
        return head_dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    return max(math.floor(corr(beta_fast)), 0), min(math.ceil(corr(beta_slow)), head_dim - 1)


def yarn_freqs(head_dim: int, theta: float, yarn: Tuple[float, ...], device) -> torch.Tensor:
    """DeepSeek-V2's YaRN frequencies: ``f_e = theta^(-2i/D)`` extrapolated
    below ``low``, ``f_e / factor`` interpolated above ``high``, a linear ramp
    between."""
    factor = yarn[0]
    low, high = yarn_range(head_dim, theta, yarn)
    base = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    f_extra, f_inter = 1.0 / base, 1.0 / (factor * base)
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    ramp = torch.clamp((i - low) / (high - low if high > low else 0.001), 0, 1)
    return f_inter * ramp + f_extra * (1 - ramp)


def yarn_softmax_scale(head_dim: int, yarn: Tuple[float, ...]) -> float:
    """Attention's softmax scale: ``1/sqrt(D)``, times ``mscale(factor,
    mscale_all_dim)^2`` under YaRN."""
    scale = 1.0 / math.sqrt(head_dim)
    if yarn and yarn[5]:
        scale *= yarn_mscale(yarn[0], yarn[5]) ** 2
    return scale


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn: Tuple[float, ...] = ()) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).  With ``yarn``
    the frequencies are :func:`yarn_freqs` and cos and sin are scaled by
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    d = x.shape[-1]
    freqs = yarn_freqs(d, theta, yarn, x.device) if yarn \
        else rope_freqs(d, theta, x.device)                             # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                               # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    if yarn:
        factor, _, _, _, mscale, mscale_all_dim = yarn
        amp = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)
        if amp != 1.0:
            cos, sin = cos * amp, sin * amp
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, *, device) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    return _sinusoid(pos, d)


def _sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``[sin(p * div), cos(p * div)]`` interleaved, for float32
    positions ``pos`` of shape (S, 1)."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ----------------------------------------------------------------- loss

def chunked_softmax_xent(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy over sequence chunks of at most ``chunk``
    positions, so only (B, chunk, V) f32 logits live at once.  The logits
    span every column of ``head_w`` — the padded vocab, as in the JAX
    package."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        hc, yc, mc = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
        logits = dense(hc, head_w).to(torch.float32)                   # (B, c, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].to(torch.int64))[..., 0]
        total = total + torch.sum((logz - gold) * mc)
        count = count + torch.sum(mc)
    return total / torch.clamp(count, min=1.0)
