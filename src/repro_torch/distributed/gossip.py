"""Compiled gossip plans and schedules: mixing matrix W -> node-axis shifts.

The port of the JAX package's ``distributed/gossip.py``.  Replicas are
stacked along a leading node axis on one device; a plan shift ``s`` is
``torch.roll(leaf, s, dims=0)``, which stands in for the JAX runtime's
collective-permute of the same payload:

    ``(X W)_i  ==  self_weight_i * X_i + sum_s w_s[i] * roll(X, s)_i``

where each shift carries one scalar weight (circulant W: ring, the flattened
torus) or an (n,) per-node weight vector (banded W that is not circulant:
chain, the exact 2-D torus, star, full).  A :class:`GossipSchedule` is an
ordered tuple of sparse plan rounds whose product realizes a dense W:
``full_logn`` runs every round each step, ``exp`` and ``exp_any`` run one
round a step (time-varying).  :func:`make_gossip_plan` resolves all nine
names of :data:`GOSSIP_TOPOLOGIES`.

Delivery gates (edge drops, :mod:`repro_torch.distributed.failures`) enter
through :func:`gated_weights`: a gated-away neighbour weight moves onto the
self weight, so every realized row of W still sums to 1.

The port has no device mesh: every plan runs on the stacked node axis of
one device, so the JAX package's sharded decode (``shard_map`` over the node
axis) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.topology import SpectralInfo
from repro_torch.trace import span
from repro_torch.tree import tree_map

ShiftWeight = Union[float, np.ndarray]   # scalar (circulant) or (n,) per-node


@dataclasses.dataclass(frozen=True, eq=False)
class GossipPlan:
    """One gossip graph, compiled to node-axis shifts.

    ``shifts`` maps each shift to its weight: a float when every node applies
    the same weight (circulant W) or an (n,) vector otherwise.  ``degree`` is
    the number of shifts, i.e. payload rolls a gossip round."""

    n: int
    self_weight: ShiftWeight
    shifts: Tuple[Tuple[int, ShiftWeight], ...]
    spectral: Optional[SpectralInfo] = None
    name: str = "custom"

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"a plan needs n >= 1, got {self.n}")

    @property
    def degree(self) -> int:
        """Shifts per gossip round == payload rolls per replica update."""
        return len(self.shifts)

    @property
    def replica_payloads(self) -> int:
        """Payload rolls a step for the replica-tracking algorithms: the
        degree, for a flat plan."""
        return self.degree

    @property
    def shift_list(self) -> Tuple[int, ...]:
        return tuple(s for s, _ in self.shifts)

    @property
    def shift_union(self) -> Tuple[int, ...]:
        """Sorted shifts: the DCD/ECD/CHOCO aux key set of a flat plan."""
        return tuple(sorted(self.shift_list))

    @property
    def uniform(self) -> bool:
        """True iff every weight is a scalar (strictly circulant W)."""
        return not isinstance(self.self_weight, np.ndarray) and \
            all(not isinstance(w, np.ndarray) for _, w in self.shifts)

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
                           max_shifts: int = 8, tol: float = 1e-12,
                           validate: bool = True, schedule: bool = False):
        """Decompose W into its roll diagonals ``w_s[i] = W[i, (i - s) % n]``,
        shifts canonical in ``(-n/2, n/2]``, each weight a scalar when its
        diagonal is uniform and an (n,) vector otherwise.  Raises
        ``ValueError`` when the support needs more than ``max_shifts``
        diagonals.  ``schedule=True`` returns
        :meth:`GossipSchedule.from_mixing_matrix` instead."""
        if schedule:
            return GossipSchedule.from_mixing_matrix(W, name=name, max_shifts=max_shifts,
                                                     tol=tol, validate=validate)
        W = np.asarray(W, dtype=np.float64)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ValueError(f"W must be square, got {W.shape}")
        n = W.shape[0]
        if validate and n > 1:
            topo.check_mixing_matrix(W)
        rows = np.arange(n)
        shifts = []
        for d in range(1, n):
            s = d if d <= n // 2 else d - n
            v = W[rows, (rows - s) % n]
            if np.max(np.abs(v)) <= tol:
                continue
            w: ShiftWeight = float(v[0]) if np.allclose(v, v[0], atol=tol) \
                else np.ascontiguousarray(v)
            shifts.append((s, w))
        if len(shifts) > max_shifts:
            raise ValueError(f"W spans {len(shifts)} shift diagonals, more than "
                             f"max_shifts={max_shifts}; pass max_shifts={len(shifts)} to "
                             "compile it anyway")
        diag = W[rows, rows]
        self_w: ShiftWeight = float(diag[0]) if np.allclose(diag, diag[0], atol=tol) \
            else np.ascontiguousarray(diag)
        # spectral_info assumes a symmetric W; an unvalidated round may only
        # be doubly stochastic (a directed dimension-exchange round)
        symmetric = validate or bool(np.allclose(W, W.T, atol=1e-9))
        spectral = topo.spectral_info(W) if n > 1 and symmetric else None
        return cls(n=n, self_weight=self_w,
                   shifts=tuple(sorted(shifts, key=lambda sw: sw[0])),
                   spectral=spectral, name=name)

    # ------------------------------------------------------------ factories
    @classmethod
    def ring(cls, n: int) -> "GossipPlan":
        """Uniform-weight ring: 2 shifts at 1/3 (the paper's setup)."""
        return cls.from_mixing_matrix(topo.ring(n), name="ring")

    @classmethod
    def chain(cls, n: int) -> "GossipPlan":
        """Metropolis path graph: shifts +-1 with per-node weights (the wrap
        entry is zero: the endpoints have one neighbour)."""
        if n < 2:
            return cls.ring(n)
        return cls.from_mixing_matrix(topo.chain(n), name="chain")

    @classmethod
    def torus(cls, n: int) -> "GossipPlan":
        """Circulant flattened torus: jumps {+-1, +-c} (c ~ sqrt(n)) at 1/5,
        every neighbour one uniform shift.  Sizes too small or too thin for
        four distinct neighbours fall back to the ring."""
        if n < 9:
            return cls.ring(n)
        r = int(np.floor(np.sqrt(n)))
        while n % r:
            r -= 1
        c = n // r
        if r < 3 or c < 3:
            return cls.ring(n)
        W = np.zeros((n, n))
        rows = np.arange(n)
        W[rows, rows] = 0.2
        for s in (1, -1, c, -c):
            W[rows, (rows - s) % n] += 0.2
        return cls.from_mixing_matrix(W, name="torus")


# ------------------------------------------------------------------ schedules

def _canon_shift(s: int, n: int) -> int:
    """Canonicalize a node-axis shift into ``(-n/2, n/2]``."""
    s %= n
    return s if s <= n // 2 else s - n


def _mixed_radix(n: int) -> Tuple[int, ...]:
    """Prime factorization of ``n``, smallest factors first: the radices of
    the dimension-exchange schedule."""
    radices, d, m = [], 2, n
    while d * d <= m:
        while m % d == 0:
            radices.append(d)
            m //= d
        d += 1
    if m > 1:
        radices.append(m)
    return tuple(radices)


@dataclasses.dataclass(frozen=True, eq=False)
class GossipSchedule:
    """An ordered tuple of :class:`GossipPlan` rounds whose product
    ``W_R ... W_1`` realizes a dense mixing matrix.

    ``time_varying=False`` (``full_logn``): every step runs all rounds in
    order.  ``time_varying=True`` (``exp``, ``exp_any``): step ``t`` runs
    round ``t % period`` only.  The replica-tracking algorithms keep one aux
    tree per shift of :attr:`shift_union`, advanced on every round."""

    n: int
    rounds: Tuple[GossipPlan, ...]
    time_varying: bool = False
    name: str = "custom"

    def __post_init__(self):
        if not self.rounds:
            raise ValueError("a schedule needs at least one round")
        if any(r.n != self.n for r in self.rounds):
            raise ValueError(f"round sizes {[r.n for r in self.rounds]} differ from n={self.n}")

    @property
    def period(self) -> int:
        return len(self.rounds)

    @property
    def round_degrees(self) -> Tuple[int, ...]:
        return tuple(r.degree for r in self.rounds)

    @property
    def degree(self) -> int:
        """Graph rolls a training step: the sum over rounds, or the largest
        round when each step runs one round."""
        if self.time_varying:
            return max(self.round_degrees)
        return sum(self.round_degrees)

    @property
    def replica_payloads(self) -> int:
        """Payload rolls a step for the replica-tracking algorithms: every
        round's payload reaches every union-shift aux tree."""
        per_round = len(self.shift_union)
        return per_round if self.time_varying else self.period * per_round

    @property
    def shift_union(self) -> Tuple[int, ...]:
        """Sorted union of every round's shifts: the aux key set."""
        return tuple(sorted({s for r in self.rounds for s in r.shift_list}))

    @property
    def uniform(self) -> bool:
        return all(r.uniform for r in self.rounds)

    def effective_mixing_matrix(self) -> np.ndarray:
        """The dense W one full pass realizes: ``W_R @ ... @ W_1``."""
        return functools.reduce(lambda acc, r: r.mixing_matrix() @ acc, self.rounds,
                                np.eye(self.n))

    def mixing_matrix(self) -> np.ndarray:
        """Alias of :meth:`effective_mixing_matrix`."""
        return self.effective_mixing_matrix()

    @property
    def spectral(self) -> Optional[SpectralInfo]:
        """SpectralInfo of the effective W, None when it is not symmetric."""
        W = self.effective_mixing_matrix()
        if self.n > 1 and np.allclose(W, W.T, atol=1e-9):
            return topo.spectral_info(W)
        return None

    # ------------------------------------------------------------ factories
    @classmethod
    def averaging(cls, n: int, *, name: str = "full_logn",
                  time_varying: bool = False) -> "GossipSchedule":
        """The mixed-radix dimension-exchange schedule: exact ``J/n`` in
        ``len(radices)`` rounds; round ``i`` (radix ``d``, stride ``m``) has
        self weight and ``d - 1`` shifts ``j*m`` at ``1/d``."""
        if n == 1:
            return cls(n=1, rounds=(GossipPlan.ring(1),), name=name)
        rounds, stride = [], 1
        for i, d in enumerate(_mixed_radix(n)):
            shifts = tuple((_canon_shift(j * stride, n), 1.0 / d) for j in range(1, d))
            rounds.append(GossipPlan(n=n, self_weight=1.0 / d, shifts=shifts, spectral=None,
                                     name=f"dimex{i}"))
            stride *= d
        return cls(n=n, rounds=tuple(rounds), time_varying=time_varying, name=name)

    @classmethod
    def exp(cls, n: int) -> "GossipSchedule":
        """The time-varying one-peer exponential graph: step ``t`` averages
        each node with its ``+2^(t mod log2 n)`` neighbour.  Exact averaging
        needs a power-of-two ``n``; other sizes raise (use ``exp_any``)."""
        if n < 2 or n & (n - 1):
            raise ValueError(f"exp needs a power-of-two node count for exact averaging, "
                             f"got {n}; use exp_any (round-robin mixed-radix, exact for "
                             "any n) or full_logn instead")
        return cls.averaging(n, name="exp", time_varying=True)

    @classmethod
    def exp_any(cls, n: int) -> "GossipSchedule":
        """The mixed-radix rounds of :meth:`averaging`, one round a step."""
        return cls.averaging(n, name="exp_any", time_varying=True)

    @classmethod
    def from_mixing_matrix(cls, W: np.ndarray, *, name: str = "custom",
                           max_shifts: int = 8, tol: float = 1e-12,
                           validate: bool = True) -> "GossipSchedule":
        """A sparse W is the single-round schedule of its flat plan; ``J/n``
        (full) and the Metropolis star factor into the dimension-exchange
        rounds (the star's effective W is then the uniform average, its fixed
        point).  Any other dense W raises."""
        W = np.asarray(W, dtype=np.float64)
        n = W.shape[0]
        try:
            plan = GossipPlan.from_mixing_matrix(W, name=name, max_shifts=max_shifts, tol=tol,
                                                 validate=validate)
            return cls(n=n, rounds=(plan,), name=plan.name)
        except ValueError:
            pass
        if np.allclose(W, np.full((n, n), 1.0 / n), atol=1e-12):
            return cls.averaging(n, name="full_logn" if name == "custom" else name)
        if np.allclose(W, topo.star(n), atol=1e-12):
            return cls.averaging(n, name="star_logn" if name == "custom" else name)
        raise ValueError(f"W spans more than {max_shifts} shift diagonals and is neither "
                         "J/n (full) nor the Metropolis star; factor it into GossipPlan "
                         "rounds (GossipSchedule(n, rounds)) or run it on the stacked "
                         "reference (repro_torch.core.algorithms)")


def as_schedule(spec) -> GossipSchedule:
    """A plan or schedule as a :class:`GossipSchedule` (a plan becomes the
    single-round schedule)."""
    if isinstance(spec, GossipSchedule):
        return spec
    plan = make_gossip_plan(spec)
    return GossipSchedule(n=plan.n, rounds=(plan,), name=plan.name)


def _named(name: str) -> Callable[[int], Union[GossipPlan, GossipSchedule]]:
    if name == "torus2d":
        # the exact 2-D torus: 4 graph neighbours on 6 shift diagonals
        return lambda n: GossipPlan.from_mixing_matrix(
            topo.make_topology("torus", n), name="torus2d", max_shifts=max(n, 8))
    if name in ("star", "full"):
        # dense support: ~n shifts, compiled with the budget widened to n
        return lambda n: GossipPlan.from_mixing_matrix(
            topo.make_topology(name, n), name=name, max_shifts=max(n, 8))
    ctor = {"ring": GossipPlan.ring, "chain": GossipPlan.chain, "torus": GossipPlan.torus,
            "full_logn": GossipSchedule.averaging, "exp": GossipSchedule.exp,
            "exp_any": GossipSchedule.exp_any}.get(name)
    if ctor is None:
        raise ValueError(f"unknown gossip topology {name!r}; known: "
                         f"{', '.join(GOSSIP_TOPOLOGIES)} — or pass a GossipPlan / "
                         "GossipSchedule / mixing matrix")
    return ctor


GOSSIP_TOPOLOGIES = ("ring", "chain", "torus", "torus2d", "star", "full",
                     "full_logn", "exp", "exp_any")


def make_gossip_plan(spec, n: Optional[int] = None):
    """spec -> :class:`GossipPlan` | :class:`GossipSchedule`: a plan or
    schedule (checked against ``n``), a name of :data:`GOSSIP_TOPOLOGIES`,
    or a mixing matrix."""
    if isinstance(spec, (GossipPlan, GossipSchedule)):
        if n is not None and spec.n != n:
            raise ValueError(f"plan has n={spec.n}, caller wants {n}")
        return spec
    if isinstance(spec, np.ndarray):
        plan = GossipPlan.from_mixing_matrix(spec)
        if n is not None and plan.n != n:
            raise ValueError(f"W has n={plan.n}, caller wants {n}")
        return plan
    if not isinstance(spec, str):
        raise TypeError(f"gossip spec must be a GossipPlan, GossipSchedule, name or W "
                        f"matrix, got {type(spec)}")
    if n is None:
        raise ValueError("topology names need the node count n")
    return _named(spec)(n)


# --------------------------------------------------------- runtime primitives

def roll_tree(tree: Any, shift: int) -> Any:
    """Neighbour exchange over the stacked node axis."""
    return tree_map(lambda l: torch.roll(l, shift, dims=0), tree)


def weight_for(w, leaf: torch.Tensor):
    """A scalar weight stays a Python float for a float32 leaf (rounded to
    float32 by the product, as JAX's weak-typed scalar), and for a bfloat16
    leaf (bf16 replicas) becomes a 0-d tensor of the leaf's dtype: JAX
    rounds a weak-typed scalar to the array's dtype before the product,
    where torch would multiply by its float32 value.  An (n,) vector, numpy
    or tensor, becomes an ``(n, 1, ..., 1)`` tensor in the leaf's dtype on
    its device."""
    if isinstance(w, (int, float)):
        if leaf.dtype == torch.float32:
            return w
        return torch.tensor(w, dtype=leaf.dtype, device=leaf.device)
    t = torch.as_tensor(np.asarray(w) if isinstance(w, np.ndarray) else w)
    return t.to(device=leaf.device, dtype=leaf.dtype).reshape((-1,) + (1,) * (leaf.dim() - 1))


def mix_leaf(plan: GossipPlan, x: torch.Tensor, neighbors: Dict[int, torch.Tensor],
             weights: Optional[Tuple[Any, Dict[int, Any]]] = None) -> torch.Tensor:
    """``self_weight * x + sum_s w_s * neighbors[s]`` for one leaf, summed in
    plan order as the JAX package sums.  ``weights`` (``(self_w, {s: w_s})``,
    e.g. from :func:`gated_weights`) replaces the plan's own."""
    self_w, ws = weights if weights is not None else (plan.self_weight, dict(plan.shifts))
    with span("gossip.mix"):
        out = weight_for(self_w, x) * x
        for s in plan.shift_list:
            nb = neighbors[s]           # a lazy neighbour decodes on each access
            out.add_(weight_for(ws[s], nb) * nb)
        return out


def plan_mix(plan: GossipPlan, x: Any, neighbors: Dict[int, Any]) -> Any:
    """Treewise :func:`mix_leaf`."""
    shifts = plan.shift_list
    return tree_map(lambda l, *nb: mix_leaf(plan, l, dict(zip(shifts, nb))),
                    x, *(neighbors[s] for s in shifts))


def gated_weights(plan: GossipPlan, gates: Dict[int, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """One round's mixing weights under per-edge delivery gates: ``gates[s]``
    is the (n,) gate of shift ``s`` in [0, 1].  Returns ``(self_w, {s: w_s})``
    as (n,) float32 tensors on the gates' device; every unit of gated-away
    neighbour weight lands on the self weight, so each realized row of W
    sums to 1 (:func:`realized_mixing_matrix`)."""
    dev = next(iter(gates.values())).device if gates else torch.device("cpu")
    ones = torch.ones((plan.n,), dtype=torch.float32, device=dev)

    def f32(w):
        return torch.as_tensor(np.asarray(w, dtype=np.float32), device=dev)

    self_w = ones * f32(plan.self_weight)
    out: Dict[int, torch.Tensor] = {}
    for s, w in plan.shifts:
        wv = ones * f32(w)
        g = gates[s].to(torch.float32)
        out[s] = wv * g
        self_w = self_w + wv * (1.0 - g)
    return self_w, out


def plan_mix_gated(plan: GossipPlan, x: Any, neighbors: Dict[int, Any],
                   gates: Dict[int, torch.Tensor]) -> Any:
    """:func:`plan_mix` under per-edge delivery gates (treewise)."""
    weights = gated_weights(plan, gates)
    shifts = plan.shift_list
    return tree_map(lambda l, *nb: mix_leaf(plan, l, dict(zip(shifts, nb)), weights),
                    x, *(neighbors[s] for s in shifts))


def realized_mixing_matrix(plan: GossipPlan, gates: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The dense (n, n) float32 mixing matrix one gated round applies:
    ``diag(self + sum_s w_s (1 - g_s))`` plus ``w_s g_s`` on the roll
    diagonals."""
    self_w, w_gated = gated_weights(plan, gates)
    n = plan.n
    rows = torch.arange(n, device=self_w.device)
    W = torch.zeros((n, n), dtype=torch.float32, device=self_w.device)
    W[rows, rows] = self_w
    for s in plan.shift_list:
        # roll(X, s)[i] = X[(i - s) % n]  =>  gated weight lands on col i - s
        W.index_put_((rows, (rows - s) % n), w_gated[s], accumulate=True)
    return W
