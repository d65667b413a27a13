"""Whisper-style encoder-decoder transformer backbone.

The port of the JAX package's ``models/encdec.py``.  The mel-spectrogram and
conv feature extractor are a stub: the model consumes precomputed encoder
frames ``(B, n_frames, d)``.  Encoder: bidirectional self-attention, LN +
GELU, sinusoidal positions.  Decoder: causal self-attention + cross-attention
to the encoder output.  Decode caches: a per-layer self-attention KV cache
and the cross K/V, computed once by :func:`encdec_prefill_cross`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    generator,
    COMPUTE_DTYPE,
    Params,
    _sinusoid,
    chunked_softmax_xent,
    dense,
    dense_init,
    embed,
    embed_init,
    gelu_mlp,
    gelu_mlp_init,
    layernorm,
    layernorm_init,
    sinusoidal_positions,
)
from repro_torch.models.lm import _layer, _layer_cache, run_layer
from repro_torch.tree import unstack


@dataclasses.dataclass
class CrossCache:
    k: torch.Tensor   # (L, B, T_enc, H, D), from the encoder output
    v: torch.Tensor


def encdec_init(cfg: ArchConfig, seed: int, *, device) -> Params:
    """Random float32 parameters from ``seed`` with the JAX package's keys
    and shapes (torch's values)."""
    gen = generator(seed, device)
    d, E, L = cfg.d_model, (cfg.encoder_layers,), (cfg.n_layers,)
    return {
        "embed": embed_init(gen, cfg.vocab_padded, d, device=device),
        "enc": {"ln1": layernorm_init(d, device=device, lead=E),
                "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_heads, cfg.hd,
                                      device=device, lead=E),
                "ln2": layernorm_init(d, device=device, lead=E),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, device=device, lead=E)},
        "dec": {"ln1": layernorm_init(d, device=device, lead=L),
                "self": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_heads, cfg.hd,
                                      device=device, lead=L),
                "ln2": layernorm_init(d, device=device, lead=L),
                "cross": attn.cross_init(gen, d, cfg.n_heads, cfg.hd, device=device, lead=L),
                "ln3": layernorm_init(d, device=device, lead=L),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, device=device, lead=L)},
        "enc_ln": layernorm_init(d, device=device),
        "final_ln": layernorm_init(d, device=device),
        "lm_head": dense_init(gen, d, cfg.vocab_padded, device=device, scale=0.02),
    }


def _heads(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, cfg.n_heads, cfg.hd)


def _enc_layer(cfg: ArchConfig, h: torch.Tensor, lp: Params) -> torch.Tensor:
    # bidirectional self-attention: no mask, no rope (sinusoid already added)
    x = layernorm(h, lp["ln1"])
    B, S, _ = x.shape
    q, k, v = (_heads(cfg, dense(x, lp["attn"][w])) for w in ("wq", "wk", "wv"))
    o = attn._sdpa(q, k, v, torch.ones((S, S), dtype=torch.bool, device=x.device))
    h = h + dense(o.reshape(B, S, -1), lp["attn"]["wo"])
    return h + gelu_mlp(layernorm(h, lp["ln2"]), lp["mlp"])


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames (B, T, d) -> encoder hidden (B, T, d); ``remat`` recomputes
    each layer in the backward pass (:func:`~repro_torch.models.lm.run_layer`)."""
    T = frames.shape[1]
    h = frames.to(COMPUTE_DTYPE) + \
        sinusoidal_positions(T, cfg.d_model, device=frames.device).to(COMPUTE_DTYPE)
    for lp in unstack(params["enc"]):
        h = run_layer(functools.partial(_enc_layer, cfg), h, lp, remat)
    return layernorm(h, params["enc_ln"])


def _dec_layer(cfg: ArchConfig, mask: torch.Tensor, enc_out: torch.Tensor,
               h: torch.Tensor, lp: Params) -> torch.Tensor:
    x = layernorm(h, lp["ln1"])
    B, S, _ = x.shape
    q, k, v = (_heads(cfg, dense(x, lp["self"][w])) for w in ("wq", "wk", "wv"))
    o = attn._sdpa(q, k, v, mask)
    h = h + dense(o.reshape(B, S, -1), lp["self"]["wo"])
    h = h + attn.cross_forward(layernorm(h, lp["ln2"]), enc_out, lp["cross"],
                               n_heads=cfg.n_heads, head_dim=cfg.hd)
    return h + gelu_mlp(layernorm(h, lp["ln3"]), lp["mlp"])


def _decoder(cfg: ArchConfig, params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
             remat: bool = False):
    S = tokens.shape[1]
    h = embed(tokens, params["embed"]) + \
        sinusoidal_positions(S, cfg.d_model, device=tokens.device).to(COMPUTE_DTYPE)
    layer = functools.partial(_dec_layer, cfg, attn.causal_mask(S, device=tokens.device),
                              enc_out)
    for lp in unstack(params["dec"]):
        h = run_layer(layer, h, lp, remat)
    return layernorm(h, params["final_ln"])


def encdec_loss(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
                remat: bool = False):
    """The decoder's cross-entropy; ``remat`` recomputes each encoder and
    decoder layer in the backward pass (the JAX package takes the flag and
    ignores it: the loss and gradients are the same either way)."""
    enc_out = encode(cfg, params, batch["extra_embeds"], remat)
    h = _decoder(cfg, params, batch["tokens"], enc_out, remat)
    xent = chunked_softmax_xent(h, params["lm_head"], batch["labels"], batch.get("loss_mask"))
    zero = torch.zeros((), dtype=torch.float32, device=xent.device)
    return xent, {"xent": xent, "lb_loss": zero, "z_loss": zero}


def encdec_logits(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
                  last_only: bool = False):
    enc_out = encode(cfg, params, batch["extra_embeds"])
    h = _decoder(cfg, params, batch["tokens"], enc_out)
    if last_only:
        h = h[:, -1:]
    return dense(h, params["lm_head"])[..., : cfg.vocab]


# ----------------------------------------------------------------- decode

def encdec_init_cache(cfg: ArchConfig, B: int, capacity: int, window: Optional[int] = None, *,
                      device) -> Dict[str, Any]:
    L = (cfg.n_layers,)
    shape = L + (B, cfg.frontend.n_tokens, cfg.n_heads, cfg.hd)
    return {
        "self": attn.gqa_init_cache(B, capacity, cfg.n_heads, cfg.hd, window=window,
                                    device=device, lead=L),
        "cross": CrossCache(k=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                            v=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)),
    }


@torch.no_grad()
def encdec_prefill_cross(cfg: ArchConfig, params: Params, frames: torch.Tensor, caches):
    """Run the encoder once and fill every layer's cross K/V."""
    enc_out = encode(cfg, params, frames)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = _layer(params["dec"], l)
        ks.append(_heads(cfg, dense(enc_out, lp["cross"]["wk"])).to(COMPUTE_DTYPE))
        vs.append(_heads(cfg, dense(enc_out, lp["cross"]["wv"])).to(COMPUTE_DTYPE))
    return {**caches, "cross": CrossCache(k=torch.stack(ks), v=torch.stack(vs))}


@torch.no_grad()
def encdec_decode_step(cfg: ArchConfig, params: Params, caches, tokens: torch.Tensor):
    """tokens (B,1) -> logits (B,1,V), against the cached cross K/V (the
    encoder already run); the self-attention cache is written in place."""
    sc, cc = caches["self"], caches["cross"]
    t = sc.pos
    x = embed(tokens, params["embed"])
    x = x + sinusoidal_positions_at(t, cfg.d_model, device=x.device).to(COMPUTE_DTYPE)
    B = x.shape[0]
    for l in range(cfg.n_layers):
        lp = _layer(params["dec"], l)
        q, kn, vn = (dense(layernorm(x, lp["ln1"]), lp["self"][w]).reshape(
            B, 1, cfg.n_heads, cfg.hd) for w in ("wq", "wk", "wv"))
        lc = _layer_cache(sc, l)
        valid = attn._write_slot(lc, kn, vn)
        o = attn._sdpa(q, lc.k, lc.v, valid[None, None, :].expand(B, 1, -1))
        x = x + dense(o.reshape(B, 1, -1), lp["self"]["wo"])
        # cross-attention against the cached K/V
        xq = dense(layernorm(x, lp["ln2"]), lp["cross"]["wq"]).reshape(
            B, 1, cfg.n_heads, cfg.hd)
        o2 = attn._sdpa(xq, cc.k[l], cc.v[l],
                        torch.ones((1, cc.k.shape[2]), dtype=torch.bool, device=x.device))
        x = x + dense(o2.reshape(B, 1, -1), lp["cross"]["wo"])
        x = x + gelu_mlp(layernorm(x, lp["ln3"]), lp["mlp"])
    x = layernorm(x, params["final_ln"])
    logits = dense(x, params["lm_head"])[..., : cfg.vocab]
    return logits, {**caches, "self": dataclasses.replace(sc, pos=t + 1)}


def sinusoidal_positions_at(t: int, d: int, *, device) -> torch.Tensor:
    """The sinusoidal position row of position ``t``, (d,)."""
    pos = torch.full((1, 1), float(t), dtype=torch.float32, device=device)
    return _sinusoid(pos, d)[0]

