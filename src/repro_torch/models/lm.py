"""Dense decoder-only language model.

The port of the dense path of the JAX package's ``models/lm.py``.  Layers are
stacked along a leading layer axis (``params["blocks"][...][l]``), exactly
like the JAX tree, and the forward walks that axis in a Python loop where
JAX scans it.  Weights stay float32; every matrix is cast to bf16 at use.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    chunked_softmax_xent,
    dense_init,
    embed,
    embed_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
)


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.norm != "rms" or cfg.act != "swiglu":
        raise NotImplementedError(
            f"only the dense rms/swiglu decoder is ported, got {cfg.family}/{cfg.norm}/{cfg.act}")


def lm_init(cfg: ArchConfig, seed: int, *, device) -> Params:
    """Random float32 parameters from ``seed`` (a torch.Generator on
    ``device``), with the JAX package's keys, shapes and init scales; the
    values are torch's, not threefry's."""
    _check_ported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, L = cfg.d_model, (cfg.n_layers,)
    return {
        "embed": embed_init(gen, cfg.vocab_padded, d, device=device),
        "final_ln": rmsnorm_init(d, device=device),
        "lm_head": dense_init(gen, d, cfg.vocab_padded, device=device, scale=0.02),
        "blocks": {
            "ln1": rmsnorm_init(d, device=device, lead=L),
            "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                  device=device, lead=L),
            "ln2": rmsnorm_init(d, device=device, lead=L),
            "ffn": swiglu_init(gen, d, cfg.d_ff, device=device, lead=L),
        },
    }


def _layer(blocks: Params, l: int) -> Params:
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in blocks.items()}


def _block_fwd(cfg: ArchConfig, h: torch.Tensor, p: Params) -> torch.Tensor:
    h = h + attn.gqa_forward(rmsnorm(h, p["ln1"]), p["attn"], n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta)
    return h + swiglu(rmsnorm(h, p["ln2"]), p["ffn"])


def lm_hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, d) in bf16."""
    _check_ported(cfg)
    h = embed(tokens, params["embed"])
    for l in range(params["blocks"]["ln1"].shape[0]):
        h = _block_fwd(cfg, h, _layer(params["blocks"], l))
    return rmsnorm(h, params["final_ln"])


def lm_loss(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S), labels (B, S), optional loss_mask.  The dense
    model has no auxiliary losses, so the loss is the cross-entropy."""
    h = lm_hidden(cfg, params, batch["tokens"])
    xent = chunked_softmax_xent(h, params["lm_head"], batch["labels"], batch.get("loss_mask"))
    zero = torch.zeros((), dtype=torch.float32, device=xent.device)
    return xent, {"xent": xent, "lb_loss": zero, "z_loss": zero}
