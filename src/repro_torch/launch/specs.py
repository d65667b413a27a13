"""The assigned input shapes, and meta-device stand-ins for the dryrun.

The port of the JAX package's ``launch/specs.py``.  Where JAX builds
``ShapeDtypeStruct`` s with ``eval_shape``, everything here lives on
``torch.device("meta")``: tensors with a shape and a dtype and no storage,
so no memory is allocated, whatever the width.  Token ids are int64, the
port's dtype (JAX's are int32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import build_model
from repro_torch.tree import tree_map

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str               # train | prefill | decode
    seq_len: int
    global_batch: int
    windowed: bool = False  # long-context decode: sliding-window ring cache


SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   InputShape("long_500k", "decode", 524_288, 1, windowed=True),
}


def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    """A vision frontend's patches take ``n_tokens`` of the positions."""
    if cfg.frontend and cfg.frontend.kind == "vision":
        return seq_len - cfg.frontend.n_tokens
    return seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg: ArchConfig, shape: InputShape, n_nodes: int
                      ) -> Dict[str, torch.Tensor]:
    """The stacked per-node training batch: leaves (n_nodes, per_node_batch, ...)."""
    if shape.global_batch % n_nodes:
        raise ValueError(f"global batch {shape.global_batch} over {n_nodes} nodes")
    b, s_text = shape.global_batch // n_nodes, _text_len(cfg, shape.seq_len)
    specs = {"tokens": _meta((n_nodes, b, s_text), torch.int64),
             "labels": _meta((n_nodes, b, s_text), torch.int64)}
    if cfg.frontend:
        specs["extra_embeds"] = _meta((n_nodes, b, cfg.frontend.n_tokens, cfg.frontend.dim),
                                      torch.float32)
    return specs


def prefill_input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    specs = {"tokens": _meta((b, _text_len(cfg, shape.seq_len)), torch.int64)}
    if cfg.frontend:
        specs["extra_embeds"] = _meta((b, cfg.frontend.n_tokens, cfg.frontend.dim),
                                      torch.float32)
    return specs


def decode_cache_specs(cfg: ArchConfig, shape: InputShape) -> Tuple[Any, torch.Tensor]:
    """(caches, token) of one decode step.  ``long_500k`` uses the
    sliding-window ring (capacity = ``long_context_window``) for every
    attention cache; SSM caches are O(1) regardless."""
    window = cfg.long_context_window if shape.windowed else None
    capacity = window if window else shape.seq_len
    caches = build_model(cfg).init_cache(shape.global_batch, capacity, window=window,
                                         device=META)
    return caches, _meta((shape.global_batch, 1), torch.int64)


def params_specs(cfg: ArchConfig) -> Any:
    """The parameter tree on the meta device (float32, no allocation)."""
    return build_model(cfg).init(0, device=META)


def stacked_params_specs(cfg: ArchConfig, n_nodes: int) -> Any:
    return tree_map(lambda l: _meta((n_nodes,) + tuple(l.shape), l.dtype), params_specs(cfg))
