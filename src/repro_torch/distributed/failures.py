"""Deterministic failure injection for the gossip runtime.

The port of the JAX package's ``distributed/failures.py``:

* :class:`DropSpec`: the failure configuration (drop rate, salt, degraded
  mode decay), parsed from CLI strings by :func:`make_drop_spec`.
* :func:`edge_drop_mask`: the keep/drop decision of every directed edge
  ``i <- i - shift`` for one gossip round, a PCG hash of the round's
  effective counter, the shift, the node and the salt.  The masks are
  bit-equal to the JAX package's, so both runtimes see the same failure
  trace.  The hash runs in int64 masked to 32 bits on the host (the masks
  are (n,) vectors; the runtime needs them there to pick the rows it
  freezes).

A dropped edge's neighbour contribution is zeroed and its weight moves onto
the self weight (:func:`repro_torch.distributed.gossip.gated_weights`); for
the replica-tracking algorithms (DCD, ECD, CHOCO) the stale replica is
frozen and its vote decays by ``DropSpec.decay`` a missed delivery
(:func:`update_freshness`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.kernels.ref import MASK32, uniform_from_hash
from repro_torch.tree import tree_map

# stream constant separating the drop-mask hash stream from the wire
# formats' (step, salt, leaf) stochastic-rounding stream
_DROP_STREAM = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class DropSpec:
    """``rate``: per-edge per-round drop probability in [0, 1); ``salt``:
    the drop-mask salt (equal salts replay the same trace); ``decay``: the
    vote decay of a stale replica a missed delivery, in (0, 1]."""

    rate: float
    salt: int = 0
    decay: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"drop rate must be in [0, 1), got {self.rate}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")

    @property
    def enabled(self) -> bool:
        return self.rate > 0.0

    def describe(self) -> str:
        return f"drop={self.rate:g}@salt{self.salt}(decay={self.decay:g})"


def make_drop_spec(spec: Union[None, DropSpec, float, str],
                   salt: int = 0, decay: float = 0.5) -> Optional[DropSpec]:
    """``None`` | :class:`DropSpec` | float rate | ``"rate[:salt[:decay]]"``
    -> :class:`DropSpec`, or ``None`` for a zero rate (the runtime then runs
    without the machinery)."""
    if spec is None:
        return None
    if isinstance(spec, DropSpec):
        return spec if spec.enabled else None
    if isinstance(spec, str):
        parts = spec.split(":")
        out = DropSpec(rate=float(parts[0]),
                       salt=int(parts[1]) if len(parts) > 1 else salt,
                       decay=float(parts[2]) if len(parts) > 2 else decay)
    else:
        out = DropSpec(rate=float(spec), salt=salt, decay=decay)
    return out if out.enabled else None


def edge_drop_mask(n: int, shift: int, step: int, drop: DropSpec) -> torch.Tensor:
    """(n,) float32 delivery mask (on the CPU) of the edges ``i <- (i -
    shift)`` at effective round counter ``step``: 1.0 delivered, 0.0
    dropped."""
    seed = ((int(step) & MASK32) * 2654435761 & MASK32) ^ \
        ((drop.salt * 747796405 + _DROP_STREAM) & MASK32)
    # distinct counters per (node, shift): shifts are canonical in
    # (-n/2, n/2], so ``shift % n`` enumerates them without collisions
    idx = (torch.arange(n, dtype=torch.int64) + (shift % n) * n) & MASK32
    u = uniform_from_hash(idx, seed)
    return (u >= torch.tensor(drop.rate, dtype=torch.float32)).to(torch.float32)


def update_freshness(fresh: torch.Tensor, mask: torch.Tensor, decay: float) -> torch.Tensor:
    """A missed delivery multiplies a replica's vote by ``decay``; a receipt
    recovers it at the same rate, capped at 1."""
    recovered = torch.clamp(fresh * (1.0 / decay), max=1.0)
    return mask * recovered + (1.0 - mask) * (decay * fresh)


def select_delivered(mask: torch.Tensor, delivered: Any, frozen: Any) -> Any:
    """Treewise per-node choice between the post-receive tree (mask 1) and
    the frozen pre-round tree (mask 0)."""
    def one(new, old):
        keep = mask.to(device=new.device, dtype=torch.bool)
        return torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
    return tree_map(one, delivered, frozen)


def fresh_key(shift: int, salt: int) -> str:
    """Aux key of the freshness vector of one union shift; the salt is in
    the name so that a checkpoint restored under another salt raises
    ``KeyError``."""
    return f"fresh{shift:+d}@drop{salt}"
