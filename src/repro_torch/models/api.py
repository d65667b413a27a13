"""Public model API: the ported architectures behind one interface."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]     # (seed, *, device) -> params
    loss: Callable[..., Any]     # (params, batch) -> (loss, metrics)


def build_model(cfg: ArchConfig) -> Model:
    """The dense decoder (the only family ported so far)."""
    return Model(
        cfg=cfg,
        init=lambda seed, *, device: lm.lm_init(cfg, seed, device=device),
        loss=lambda params, batch: lm.lm_loss(cfg, params, batch),
    )
