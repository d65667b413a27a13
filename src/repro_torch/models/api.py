"""Public model API: every architecture behind one interface.

The port of the JAX package's ``models/api.py``.  ``init`` takes an integer
seed and a device where JAX takes a key (``device="meta"`` builds the shapes
alone); ``loss`` takes ``remat`` as JAX's does; ``init_cache`` takes the device of
the caches; ``make_batch`` draws from a ``torch.Generator`` (on the device
the batch is made on) where JAX draws from a key, so its numbers differ from
JAX's for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ed
from repro_torch.models import lm
from repro_torch.models.layers import dense
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]         # (seed, *, device) -> params
    loss: Callable[..., Any]         # (params, batch, remat=False) -> (loss, metrics)
    logits: Callable[..., Any]       # (params, batch) -> logits (B, S, V)
    prefill: Callable[..., Any]      # (params, batch) -> last-position logits (B, 1, V)
    init_cache: Callable[..., Any]   # (B, capacity, window=None, *, device="cuda") -> caches
    decode_step: Callable[..., Any]  # (params, caches, tokens) -> (logits, caches)

    def param_count(self, params) -> int:
        return sum(int(p.numel()) for p in tree_leaves(params))


def build_model(cfg: ArchConfig) -> Model:
    if cfg.is_encdec:
        return Model(
            cfg=cfg,
            init=lambda seed, *, device: ed.encdec_init(cfg, seed, device=device),
            loss=lambda params, batch, remat=False: ed.encdec_loss(cfg, params, batch, remat),
            logits=lambda params, batch: ed.encdec_logits(cfg, params, batch),
            prefill=lambda params, batch: ed.encdec_logits(cfg, params, batch, last_only=True),
            init_cache=lambda B, capacity, window=None, *, device="cuda":
                ed.encdec_init_cache(cfg, B, capacity, window, device=device),
            decode_step=lambda params, caches, tokens:
                ed.encdec_decode_step(cfg, params, caches, tokens),
        )
    return Model(
        cfg=cfg,
        init=lambda seed, *, device: lm.lm_init(cfg, seed, device=device),
        loss=lambda params, batch, remat=False: lm.lm_loss(cfg, params, batch, remat),
        logits=lambda params, batch: lm.lm_logits(cfg, params, batch["tokens"],
                                                  batch.get("extra_embeds")),
        prefill=lambda params, batch: _lm_prefill(cfg, params, batch),
        init_cache=lambda B, capacity, window=None, *, device="cuda":
            lm.lm_init_cache(cfg, B, capacity, window, device=device),
        decode_step=lambda params, caches, tokens: lm.lm_decode_step(cfg, params, caches, tokens),
    )


def _lm_prefill(cfg: ArchConfig, params, batch):
    """Serving prefill: the full forward, logits only at the final position
    (the (B, S, V) logits are never made)."""
    h, _ = lm.lm_hidden(cfg, params, batch["tokens"], batch.get("extra_embeds"))
    return dense(h[:, -1:], params["lm_head"])[..., : cfg.vocab]


def make_batch_specs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for one training batch (the dryrun's; nothing
    is allocated): tokens and labels (B, S_text) int64, the port's token
    dtype (JAX's are int32), and for a frontend ``extra_embeds`` (B,
    n_tokens, dim) float32.  A vision frontend's patches take ``n_tokens``
    of the ``seq`` positions."""
    n_front = cfg.frontend.n_tokens if cfg.frontend else 0
    s_text = seq - n_front if cfg.frontend and cfg.frontend.kind == "vision" else seq
    meta = torch.device("meta")
    specs = {"tokens": torch.empty((batch, s_text), dtype=torch.int64, device=meta),
             "labels": torch.empty((batch, s_text), dtype=torch.int64, device=meta)}
    if cfg.frontend:
        specs["extra_embeds"] = torch.empty((batch, cfg.frontend.n_tokens, cfg.frontend.dim),
                                            dtype=torch.float32, device=meta)
    return specs


def make_batch(cfg: ArchConfig, gen: torch.Generator, batch: int, seq: int
               ) -> Dict[str, torch.Tensor]:
    """A synthetic training batch on ``gen``'s device: uniform tokens and
    labels (B, S_text) int64, and for a frontend ``extra_embeds`` (B,
    n_tokens, dim) standard normal.  A vision frontend's patches take
    ``n_tokens`` of the ``seq`` positions."""
    n_front = cfg.frontend.n_tokens if cfg.frontend else 0
    s_text = seq - n_front if cfg.frontend and cfg.frontend.kind == "vision" else seq
    device = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, s_text), generator=gen, device=device),
           "labels": torch.randint(0, cfg.vocab, (batch, s_text), generator=gen, device=device)}
    if cfg.frontend:
        out["extra_embeds"] = torch.randn((batch, cfg.frontend.n_tokens, cfg.frontend.dim),
                                          generator=gen, device=device)
    return out
