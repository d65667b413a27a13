"""Per-architecture parallelism plans for the production layouts.

The port of the JAX package's ``distributed/plans.py``, value for value.
Train: the 16-wide ``data`` axis of the 256-device layout (32 wide with the
pod axis folded in) is split into ``node x fsdp``; each gossip node owns a
full replica sharded over ``fsdp x model`` devices.  ``n_nodes`` is chosen
so that replica + momentum + the DCD/ECD aux trees fit a device; the big
architectures use fewer, fatter nodes and keep their replicas in bf16
(``aux_dtype``).  ``remat`` recomputes each block in the backward pass.

Serve: ``(dp, mp)``; ``mp`` divides the arch's KV, latent or state heads.

The port's runtime shards no node over devices: these plans size the
dryrun's per-device arithmetic (:mod:`repro_torch.distributed.sharding`)
and choose ``aux_dtype`` and ``remat`` for the executed steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    n_nodes: int            # gossip ring size on the single-pod layout
    tp: int = 8             # tensor-parallel width within a node (node*fsdp*tp = devices)
    aux_dtype: str = "float32"   # replica/estimate storage (bf16 for the biggest archs)
    remat: bool = True

    def nodes_for(self, multi_pod: bool) -> int:
        return self.n_nodes * (2 if multi_pod else 1)

    @property
    def torch_aux_dtype(self):
        """``aux_dtype`` as ``init_dist_state`` takes it: None for float32."""
        return torch.bfloat16 if self.aux_dtype == "bfloat16" else None


@dataclasses.dataclass(frozen=True)
class ServePlan:
    mp: int                 # tensor-parallel width (must divide head-ish dims)


# tp sized to the model (tensor parallelism for a 2B model spends links on
# activations; fsdp carries the sharding instead), n_nodes sized so that
# replica + momentum + aux fit a device.  Head-aligned tp: tp divides
# n_kv_heads, else the GQA head reshape cuts across shards and the K/V
# would be resharded every layer.
TRAIN_PLANS: Dict[str, TrainPlan] = {
    "internvl2-76b":        TrainPlan(n_nodes=2, tp=8, aux_dtype="bfloat16"),   # kv=8
    "zamba2-7b":            TrainPlan(n_nodes=8, tp=8),
    "deepseek-moe-16b":     TrainPlan(n_nodes=8, tp=16),   # EP: 64 experts / 16
    "whisper-base":         TrainPlan(n_nodes=16, tp=1),
    "mistral-large-123b":   TrainPlan(n_nodes=2, tp=8, aux_dtype="bfloat16"),   # kv=8
    "deepseek-v2-lite-16b": TrainPlan(n_nodes=8, tp=16),
    "codeqwen1.5-7b":       TrainPlan(n_nodes=8, tp=8),
    "starcoder2-15b":       TrainPlan(n_nodes=8, tp=4),                         # kv=4
    "mamba2-370m":          TrainPlan(n_nodes=16, tp=1),
    "granite-3-2b":         TrainPlan(n_nodes=16, tp=2),
}

SERVE_PLANS: Dict[str, ServePlan] = {
    "internvl2-76b":        ServePlan(mp=8),
    "zamba2-7b":            ServePlan(mp=16),
    "deepseek-moe-16b":     ServePlan(mp=16),
    "whisper-base":         ServePlan(mp=8),
    "mistral-large-123b":   ServePlan(mp=8),
    "deepseek-v2-lite-16b": ServePlan(mp=16),
    "codeqwen1.5-7b":       ServePlan(mp=16),
    "starcoder2-15b":       ServePlan(mp=4),
    "mamba2-370m":          ServePlan(mp=16),
    "granite-3-2b":         ServePlan(mp=8),
}
