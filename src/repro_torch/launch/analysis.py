"""Roofline terms of a dryrun step on the H100, from meta-device counts.

The port of the JAX package's ``launch/analysis.py``.  Three terms per
(arch x shape x layout), in seconds, against the card's published figures
(NVIDIA H100 SXM data sheet, dense rates at the 700 W limit):

    compute    = FLOPs_per_device / 989 TFLOP/s (bf16 tensor cores)
    memory     = HBM_bytes_per_device / 3.35 TB/s (HBM3)
    collective = node-axis bytes_per_device / 450 GB/s (NVLink, each way),
                 the bytes that cross between pods at 50 GB/s instead

The last rate is an assumption: one 400 Gb/s InfiniBand NDR link a GPU, as
the DGX H100 data sheet gives its eight ConnectX-7 ports for eight GPUs.

Where JAX reads these from XLA's compiled module, the port counts the eager
program on the meta device (nothing runs, nothing is allocated):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step, which
  counts matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``),
  convolutions and ``scaled_dot_product_attention``, forward and backward:
  the ops JAX's ``jaxpr_flops`` counts (``dot_general`` and
  ``conv_general_dilated``).  A checkpointed block's forward runs again in
  the backward pass and is counted again, as JAX's grad jaxpr holds the
  recompute.
* HBM bytes: the eager program's own traffic, the bytes of every input and
  output of every aten op (:class:`TrafficMode`), no op fused.  XLA's
  parsed HLO counts fused ops' outputs once; this counts every
  intermediate as written and read, so it is an upper bound of what a fused
  program would move.
* Collective bytes: the node axis's gossip payloads
  (:func:`gossip_collectives`); the port shards no node over devices, so
  no fsdp or tensor-parallel collective is modelled.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12         # bf16 dense, H100 SXM (data sheet)
HBM_BW = 3.35e12            # bytes/s, H100 SXM HBM3 (data sheet)
LINK_BW = 450e9             # bytes/s each way, NVLink within a host (data sheet)
DCN_BW = 50e9               # bytes/s a GPU between hosts: assumed 400 Gb/s NDR (DGX H100)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    counts_by_op: Dict[str, int]
    dcn_bytes: int = 0     # bytes crossing pod boundaries (multi-pod layouts)

    @property
    def total_bytes(self) -> int:
        # an all-reduce crosses the links twice (reduce and broadcast)
        return sum(b * (2 if op == "all-reduce" else 1) for op, b in self.bytes_by_op.items())


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: CollectiveStats
    model_flops_global: float = 0.0     # 6*N*D analytic
    n_chips: int = 1

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        dcn = float(self.collectives.dcn_bytes)
        return (self.collective_bytes_per_chip - dcn) / LINK_BW + dcn / DCN_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): what remat and redundancy waste."""
        counted = self.flops_per_chip * self.n_chips
        return self.model_flops_global / counted if counted else 0.0

    def as_dict(self) -> dict:
        """JAX's keys; ``xla_raw_flops`` and ``scan_factor`` (XLA's own count
        and its correction) have no counterpart and are ``None``."""
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_breakdown": self.collectives.bytes_by_op,
            "collective_counts": self.collectives.counts_by_op,
            "dcn_bytes_per_chip": self.collectives.dcn_bytes,
            "xla_raw_flops": None,
            "scan_factor": None,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


class TrafficMode(TorchDispatchMode):
    """Counts ``bytes``: for every aten op that is not a view or an empty
    allocation, the bytes of its tensor inputs (read once) and of its
    outputs (written once); an in-place op's output is its written input."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        views = any(r.alias_info is not None and not r.alias_info.is_write
                    for r in schema.returns)
        name = schema.name
        if not views and not name.startswith(("aten::empty", "aten::new_empty")):
            self.bytes += _tensor_bytes(list(args)) + _tensor_bytes(list(kwargs.values())) \
                + _tensor_bytes(out if isinstance(out, (list, tuple)) else [out])
        return out


def count_fn(fn: Callable, *args) -> Tuple[float, int]:
    """``(FLOPs, HBM bytes)`` of ``fn(*args)`` (run it on meta tensors: the
    counts come from shapes alone)."""
    traffic = TrafficMode()
    flops = FlopCounterMode(display=False)
    with flops, traffic:
        fn(*args)
    return float(flops.get_total_flops()), traffic.bytes


def count_fn_flops(fn: Callable, *args) -> float:
    """Matmul, conv and attention FLOPs of ``fn(*args)``: the counterpart of
    the JAX package's ``count_fn_flops``."""
    return count_fn(fn, *args)[0]


def gossip_collectives(payload_bytes: float, payloads: int, n_leaves: int, n_chips: int,
                       shifts: Tuple[int, ...], n_nodes: int, pod_nodes: Optional[int]
                       ) -> Tuple[float, CollectiveStats]:
    """The node axis's traffic per device and step: ``payloads`` shifts of
    every node's payload (``payload_bytes`` for all ``n_nodes``, one
    collective-permute a leaf and shift), each device sending its shard
    (the node's payload over its ``fsdp x model`` devices).  With
    ``pod_nodes`` (nodes a pod, pod-major), a shift that moves any node to
    another pod puts its bytes between pods."""
    per_shift = payload_bytes / n_chips
    total = per_shift * payloads
    crossing = 0
    if pod_nodes:
        crossing = sum(1 for s in shifts
                       if any(i // pod_nodes != ((i + s) % n_nodes) // pod_nodes
                              for i in range(n_nodes)))
    dcn = per_shift * min(crossing, payloads) if crossing else 0.0
    stats = CollectiveStats(bytes_by_op={"collective-permute": int(total)} if payloads else {},
                            counts_by_op={"collective-permute": payloads * n_leaves}
                            if payloads else {}, dcn_bytes=int(dcn))
    return float(total), stats


# ------------------------------------------------------- analytic MODEL_FLOPS

def model_flops(cfg, shape, params_count: int, active_params: Optional[int] = None) -> float:
    """6*N*D (train) / 2*N*D (inference), N the (active) non-embedding params."""
    n = active_params if active_params is not None else params_count
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def active_param_count(cfg, params_count: int) -> int:
    """MoE: only the top_k and shared experts are active per token."""
    if not cfg.moe:
        return params_count
    m = cfg.moe
    expert_params = cfg.n_layers * m.n_routed * 3 * cfg.d_model * m.d_expert
    active_expert = cfg.n_layers * (m.top_k + m.n_shared) * 3 * cfg.d_model * m.d_expert
    return params_count - expert_params + active_expert
