"""Compiled gossip plans: mixing matrix W -> node-axis shifts (flat plans).

The port of the plan slice of the JAX package's ``distributed/gossip.py``.
Replicas are stacked along a leading node axis on one device; a plan shift
``s`` is ``torch.roll(leaf, s, dims=0)``, which stands in for the JAX
runtime's collective-permute of the same payload:

    ``(X W)_i  ==  self_weight * X_i + sum_s w_s * roll(X, s)_i``

Only circulant (uniform-weight) plans are ported; schedules, per-node weight
vectors and gated mixing come with the topologies that need them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.topology import SpectralInfo
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True, eq=False)
class GossipPlan:
    """One gossip graph, compiled to node-axis shifts with scalar weights."""

    n: int
    self_weight: float
    shifts: Tuple[Tuple[int, float], ...]
    spectral: Optional[SpectralInfo] = None
    name: str = "custom"

    @property
    def degree(self) -> int:
        """Shifts per gossip step == payload rolls per replica update."""
        return len(self.shifts)

    @property
    def shift_list(self) -> Tuple[int, ...]:
        return tuple(s for s, _ in self.shifts)

    @property
    def shift_union(self) -> Tuple[int, ...]:
        """Sorted shifts: the DCD/ECD aux key set of a flat plan."""
        return tuple(sorted(self.shift_list))

    def mixing_matrix(self) -> np.ndarray:
        """Reconstruct W (the exact inverse of :meth:`from_mixing_matrix`)."""
        W = np.zeros((self.n, self.n))
        W[np.arange(self.n), np.arange(self.n)] = self.self_weight
        rows = np.arange(self.n)
        for s, w in self.shifts:
            # roll(X, s)[i] = X[(i - s) % n]  =>  weight lands on column i - s
            W[rows, (rows - s) % self.n] += w
        return W

    @classmethod
    def from_mixing_matrix(cls, W: np.ndarray, *, name: str = "custom",
                           max_shifts: int = 8, tol: float = 1e-12) -> "GossipPlan":
        """Decompose W into its roll diagonals ``w_s = W[i, (i - s) % n]``,
        shifts canonical in ``(-n/2, n/2]``.  Raises ``ValueError`` when a
        diagonal is not uniform (not ported) or the support needs more than
        ``max_shifts`` diagonals."""
        W = np.asarray(W, dtype=np.float64)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ValueError(f"W must be square, got {W.shape}")
        n = W.shape[0]
        if n > 1:
            topo.check_mixing_matrix(W)
        rows = np.arange(n)
        shifts = []
        for d in range(1, n):
            s = d if d <= n // 2 else d - n
            v = W[rows, (rows - s) % n]
            if np.max(np.abs(v)) <= tol:
                continue
            if not np.allclose(v, v[0], atol=tol):
                raise ValueError("per-node shift weights (non-circulant W) are not ported")
            shifts.append((s, float(v[0])))
        if len(shifts) > max_shifts:
            raise ValueError(f"W spans {len(shifts)} shift diagonals, more than "
                             f"max_shifts={max_shifts}")
        diag = W[rows, rows]
        if not np.allclose(diag, diag[0], atol=tol):
            raise ValueError("per-node self weights (non-circulant W) are not ported")
        return cls(n=n, self_weight=float(diag[0]),
                   shifts=tuple(sorted(shifts, key=lambda sw: sw[0])),
                   spectral=topo.spectral_info(W) if n > 1 else None, name=name)

    @classmethod
    def ring(cls, n: int) -> "GossipPlan":
        """Uniform-weight ring: 2 shifts at 1/3 (the paper's setup)."""
        return cls.from_mixing_matrix(topo.ring(n), name="ring")


GOSSIP_TOPOLOGIES = ("ring",)


def make_gossip_plan(spec, n: Optional[int] = None) -> GossipPlan:
    """spec -> :class:`GossipPlan`: a plan (checked against ``n``), the name
    ``ring``, or a circulant mixing matrix."""
    if isinstance(spec, GossipPlan):
        if n is not None and spec.n != n:
            raise ValueError(f"plan has n={spec.n}, caller wants {n}")
        return spec
    if isinstance(spec, np.ndarray):
        return GossipPlan.from_mixing_matrix(spec)
    if spec != "ring":
        raise ValueError(f"unknown or unported gossip topology {spec!r}; "
                         f"ported: {GOSSIP_TOPOLOGIES}")
    if n is None:
        raise ValueError("topology names need the node count n")
    return GossipPlan.ring(n)


# --------------------------------------------------------- runtime primitives

def roll_tree(tree: Any, shift: int) -> Any:
    """Neighbor exchange over the stacked node axis."""
    return tree_map(lambda l: torch.roll(l, shift, dims=0), tree)


def mix_leaf(plan: GossipPlan, x: torch.Tensor,
             neighbors: Dict[int, torch.Tensor]) -> torch.Tensor:
    """``self_weight * x + sum_s w_s * neighbors[s]`` for one leaf, summed in
    plan order as the JAX package sums (weights round to the leaf's dtype)."""
    out = plan.self_weight * x
    for s, w in plan.shifts:
        out.add_(w * neighbors[s])
    return out


def plan_mix(plan: GossipPlan, x: Any, neighbors: Dict[int, Any]) -> Any:
    """Treewise :func:`mix_leaf`."""
    shifts = plan.shift_list
    return tree_map(lambda l, *nb: mix_leaf(plan, l, dict(zip(shifts, nb))),
                    x, *(neighbors[s] for s in shifts))
