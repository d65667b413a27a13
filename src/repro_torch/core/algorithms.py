"""The paper's algorithms in their stacked form (the port of the JAX
package's ``core/algorithms.py``).

Every local model lives in a tree whose leaves carry a leading node axis
``n``: ``X[i] = x^{(i)}``, and gossip ``X W`` is a tensordot with the small
mixing matrix.  Steps:

* ``cpsgd``  — centralized AllReduce SGD (paper §5 "Centralized").
* ``dpsgd``  — full-precision D-PSGD: ``X_{t+1} = X_t W - lr G``.
* ``naive``  — D-PSGD over naively compressed models (Supp. D; must fail).
* ``dcd``    — Algorithm 1, difference compression.
* ``ecd``    — Algorithm 2, extrapolation compression.
* ``choco``  — CHOCO-SGD: compressed differences to replica estimates,
  consensus stepsize gamma.
* ``deepsqueeze`` — DeepSqueeze: error-compensated compression of the model
  value.

The math is the JAX package's, but a step walks the leaves in flatten order
and finishes each leaf before the next, updating the state's trees IN PLACE
(the JAX step is pure and builds new trees).  At full width a stacked tree
is gigabytes; the functional form would hold X, G, X_half, Z, C(Z) and
X_new at once, a leaf at a time holds one leaf of each transient.  So
``step(state, grads, key, lr)`` consumes ``state``: it returns the same
object, advanced.

``key`` is an integer step counter (the wire's (step, salt, leaf) seeding,
payloads bit-equal to the JAX package's) or a ``torch.Generator``; see
``core/compression.py``.

:class:`GossipReference` is the stacked mirror of the runtime
(``distributed/decentralized.py``): explicit replica and estimate trees per
shift, the runtime's encode counters and drop masks, a dense decode then a
roll of the decoded values.  It walks the leaves the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.compression import Compressor, IdentityCompressor
from repro_torch.tree import leaf_items, tree_leaves, tree_map


def _mix_leaf(W: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``sum_j W_ij x_j`` over the node axis of one stacked leaf (a new tensor)."""
    w = torch.as_tensor(np.asarray(W, dtype=np.float32), device=leaf.device)
    return torch.tensordot(w, leaf.to(torch.float32), dims=([1], [0])).to(leaf.dtype)


def mix(W, X: Any) -> Any:
    """``(X W^T)_i = sum_j W_ij x_j`` applied leaf-wise over the node axis."""
    return tree_map(lambda leaf: _mix_leaf(W, leaf), X)


def _stack(params_single: Any, n: int) -> Any:
    """A copy of a single model for each of ``n`` nodes (a new tree)."""
    return tree_map(lambda p: p.detach().unsqueeze(0).repeat((n,) + (1,) * p.dim()),
                    params_single)


@dataclasses.dataclass
class AlgoState:
    params: Any                 # stacked tree (nested dicts or one tensor), leading axis n
    step: int = 1               # starts at 1, as the paper's t
    aux: Any = None             # ecd: estimates X_tilde; choco: X_hat; deepsqueeze: E


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A decentralized training algorithm = init + step over stacked state."""

    name: str
    W: np.ndarray
    compressor: Compressor = IdentityCompressor()
    gamma: float = 0.5          # CHOCO consensus stepsize, valid on (0, 1]

    def __post_init__(self):
        if self.name not in _STEPS:
            raise ValueError(f"algorithms are {ALGORITHMS}, got {self.name!r}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"CHOCO consensus stepsize gamma must be in (0, 1], got "
                             f"{self.gamma}")

    @property
    def n_nodes(self) -> int:
        return self.W.shape[0]

    def init(self, params_single: Any) -> AlgoState:
        """Copy a single model to all ``n`` nodes (paper: x_1^{(i)} = x_1); the
        estimates of ECD and CHOCO start as their own copy of X, DeepSqueeze's
        residual at zero."""
        X = _stack(params_single, self.n_nodes)
        aux = None
        if self.name in ("ecd", "choco"):
            aux = _stack(params_single, self.n_nodes)
        elif self.name == "deepsqueeze":
            aux = tree_map(torch.zeros_like, X)
        return AlgoState(params=X, step=1, aux=aux)

    def step_fn(self) -> Callable[[AlgoState, Any, Any, float], AlgoState]:
        fn, W, comp, gamma = _STEPS[self.name], self.W, self.compressor, self.gamma

        def step(state: AlgoState, grads: Any, key: Any, lr: float) -> AlgoState:
            items = leaf_items(state.params)
            aux = tree_leaves(state.aux) if state.aux is not None else [None] * len(items)
            ctx = _Ctx(W=W, comp=comp, key=key, lr=float(np.float32(lr)),
                       gamma=float(np.float32(gamma)), step=state.step)
            with torch.no_grad():
                for li, ((path, x), g, a) in enumerate(zip(items, tree_leaves(grads), aux)):
                    fn(ctx, li, path, x, g.to(x.dtype), a)
            state.step += 1
            return state

        return step


@dataclasses.dataclass(frozen=True)
class _Ctx:
    W: np.ndarray
    comp: Compressor
    key: Any
    lr: float                   # f32 values, as the JAX step's f32 scalars
    gamma: float
    step: int

    def C(self, z: torch.Tensor, li: int, path: str) -> torch.Tensor:
        return self.comp.apply_leaf(self.key, z, li, path)

    def lr_g(self, g: torch.Tensor) -> torch.Tensor:
        return self.lr * g


# --------------------------------------------------------------------------
# Individual algorithm steps: one leaf each, in place
# --------------------------------------------------------------------------

def cpsgd_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """Centralized: every node applies the exact average gradient."""
    x.sub_(c.lr_g(g.mean(dim=0, keepdim=True)))


def dpsgd_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """X_{t+1} = X_t W - lr G."""
    x.copy_(_mix_leaf(c.W, x).sub_(c.lr_g(g)))


def naive_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """X_{t+1} = C(X_t) W - lr G — does NOT converge."""
    x.copy_(_mix_leaf(c.W, c.C(x, li, path)).sub_(c.lr_g(g)))


def dcd_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """Algorithm 1: X_half = X W - lr G; Z = X_half - X; X_{t+1} = X + C(Z).
    Every replica would advance by the same compressed delta as its true
    model, so the stacked form keeps none."""
    z = _mix_leaf(c.W, x).sub_(c.lr_g(g)).sub_(x)
    x.add_(c.C(z, li, path))


def ecd_leaf(c: _Ctx, li, path, x, g, xt) -> None:
    """Algorithm 2, with ``aux`` the shared estimates X_tilde and ``s = t + 1``:
    X_{t+1} = X_tilde W - lr G; Z = (1 - s/2) X_t + (s/2) X_{t+1};
    X_tilde' = (1 - 2/s) X_tilde + (2/s) C(Z).  The scalars are f32, as in
    the JAX step."""
    s = np.float32(c.step + 1)
    za, zb = float(np.float32(1.0) - np.float32(0.5) * s), float(np.float32(0.5) * s)
    decay = float(np.float32(1.0) - np.float32(2.0) / s)
    blend = float(np.float32(2.0) / s)
    x_new = _mix_leaf(c.W, xt).sub_(c.lr_g(g))
    z = za * x + zb * x_new
    cz = c.C(z, li, path)
    del z
    xt.copy_(decay * xt + blend * cz)
    x.copy_(x_new)


def choco_leaf(c: _Ctx, li, path, x, g, xh) -> None:
    """CHOCO-SGD, ``aux`` the shared estimates X_hat: X_half = X - lr G;
    X_hat' = X_hat + C(X_half - X_hat); X_new = X_half + gamma (X_hat' W - X_hat')."""
    x.sub_(c.lr_g(g))
    xh.add_(c.C(x - xh, li, path))
    m = _mix_leaf(c.W, xh).sub_(xh)
    x.add_(c.gamma * m)


def deepsqueeze_leaf(c: _Ctx, li, path, x, g, e) -> None:
    """DeepSqueeze, ``aux`` the residual E: X_half = X - lr G; V = X_half + E;
    D = C(V); E' = V - D; X_new = X_half + D W - D.  The residual last: an
    identity payload is the V buffer itself."""
    x.sub_(c.lr_g(g))
    e.add_(x)                                       # V
    d = c.C(e, li, path)
    x.add_(_mix_leaf(c.W, d).sub_(d))
    e.sub_(d)


_STEPS = {
    "cpsgd": cpsgd_leaf,
    "dpsgd": dpsgd_leaf,
    "naive": naive_leaf,
    "dcd": dcd_leaf,
    "ecd": ecd_leaf,
    "choco": choco_leaf,
    "deepsqueeze": deepsqueeze_leaf,
}

ALGORITHMS = tuple(_STEPS)


# --------------------------------------------------------------------------
# Shift-space reference with failure injection (GossipReference)
# --------------------------------------------------------------------------

REFERENCE_ALGOS = ("dpsgd", "naive", "dcd", "ecd", "choco", "deepsqueeze")
# the per-shift replica or estimate trees' aux prefix
_REPLICA_PREFIX = {"dcd": "rep", "ecd": "tilde", "choco": "hat"}


@dataclasses.dataclass
class _RefRound:
    """One gossip round of a reference step: its plan, encode counter, the
    gated mixing weights on the params' device and, under drops, the dropped
    rows of each replica shift."""
    plan: Any
    enc: int
    weights: Tuple[torch.Tensor, Dict[int, torch.Tensor]]
    dropped: Dict[int, torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class GossipReference:
    """Stacked, transparent mirror of the runtime, drops included.

    :class:`Algorithm` is the paper-math reference: a dense ``X W`` and
    DCD's implicit replicas (they coincide with the neighbours' models, so
    none is stored).  Edge failure breaks that shortcut: a dropped
    compressed delta leaves a replica stale.  This reference therefore keeps
    the explicit replica and estimate trees of every union shift, encodes
    through the same :class:`~repro_torch.distributed.wire.WireFormat` with
    the runtime's ``(step, salt, leaf)`` counters (words bit-equal), draws
    the same per-edge masks
    (:func:`~repro_torch.distributed.failures.edge_drop_mask`), and applies
    the same row-stochastic renormalization and freeze/decay policy, but
    stacked: one dense decode into float32 (the send kernels and the dense
    decodes K4a, K4b, K6b run, no receive kernel), then ``torch.roll`` of
    the decoded values.

    The step counter starts at 0 (the runtime's, not :class:`AlgoState`'s
    1).  Round ``r`` of step ``t`` encodes with counter ``t * period + r``;
    on a time-varying schedule step ``t`` runs round ``t % period`` only,
    with counter ``t``.  ``step_fn`` has the :class:`Algorithm` signature, so
    :func:`repro_torch.core.testbed.run` drives it unchanged, and ignores
    ``key``: compression and failure randomness are functions of the step.
    As the other steps here, a step walks the leaves with the rounds inside
    and updates the state's trees in place.
    """

    name: str                    # dpsgd | naive | dcd | ecd | choco | deepsqueeze
    plan: Any                    # GossipPlan | GossipSchedule
    wire: Optional[Any] = None   # WireFormat | spec str | None (dpsgd)
    drop: Optional[Any] = None   # DropSpec | rate float | "rate[:salt[:decay]]"
    gamma: float = 0.5           # CHOCO consensus stepsize, valid on (0, 1]

    def __post_init__(self):
        from repro_torch.distributed.failures import make_drop_spec
        from repro_torch.distributed.gossip import as_schedule
        from repro_torch.distributed.wire import make_wire_format

        if self.name not in REFERENCE_ALGOS:
            raise ValueError(f"reference algorithms are {REFERENCE_ALGOS}, got {self.name!r}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"CHOCO consensus stepsize gamma must be in (0, 1], got "
                             f"{self.gamma}")
        object.__setattr__(self, "plan", as_schedule(self.plan))
        if self.wire is not None:
            object.__setattr__(self, "wire", make_wire_format(self.wire))
        elif self.name != "dpsgd":
            raise ValueError(f"{self.name} needs a wire format")
        object.__setattr__(self, "drop", make_drop_spec(self.drop))

    @property
    def n_nodes(self) -> int:
        return self.plan.n

    def init(self, params_single: Any) -> AlgoState:
        """``params_single`` stacked over the nodes; every replica or
        estimate tree its own copy, DeepSqueeze's residual zero, the
        freshness vectors (DCD, ECD, CHOCO under drops) ones, and a stateful
        wire's codec state."""
        from repro_torch.distributed.failures import fresh_key

        sched, n = self.plan, self.n_nodes
        X = _stack(params_single, n)
        aux: dict = {}
        prefix = _REPLICA_PREFIX.get(self.name)
        if self.name in ("ecd", "choco"):
            aux[f"{prefix}_self"] = _stack(params_single, n)
        if prefix is not None:
            aux.update({f"{prefix}{s:+d}": _stack(params_single, n) for s in sched.shift_union})
            if self.drop is not None:
                aux.update({fresh_key(s, self.drop.salt): torch.ones((n,), dtype=torch.float32)
                            for s in sched.shift_union})
        if self.name == "deepsqueeze":
            aux["err_self"] = tree_map(torch.zeros_like, X)
        if self.wire is not None and self.wire.stateful:
            aux[self.wire.aux_name] = self.wire.init_aux(X)
        return AlgoState(params=X, step=0, aux=aux)

    def step_fn(self) -> Callable[[AlgoState, Any, Any, float], AlgoState]:
        from repro_torch.distributed.decentralized import _SALT
        from repro_torch.distributed.failures import (
            edge_drop_mask, fresh_key, update_freshness)
        from repro_torch.distributed.gossip import gated_weights, mix_leaf
        from repro_torch.distributed.wire import leaf_seed

        sched, wire, drop, name = self.plan, self.wire, self.drop, self.name
        gamma = float(np.float32(self.gamma))
        rounds, period, union, n = sched.rounds, sched.period, sched.shift_union, sched.n
        time_varying = sched.time_varying and period > 1
        salt = _SALT.get(name, 0)
        wkey = wire.aux_name if wire is not None and wire.stateful else None
        prefix = _REPLICA_PREFIX.get(name)
        ones = torch.ones((n,), dtype=torch.float32)

        def plan_rounds(state: AlgoState, device) -> List[_RefRound]:
            """This step's rounds; the freshness vectors, shared by every
            leaf, advance here once a round, before the gates."""
            t = state.step
            todo = [(rounds[t % period], t)] if time_varying else \
                [(rnd, t * period + r) for r, rnd in enumerate(rounds)]
            out = []
            for rnd, enc in todo:
                masks = {s: ones if drop is None else edge_drop_mask(n, s, enc, drop)
                         for s in union}
                if drop is not None and prefix is not None:
                    for s in union:
                        k = fresh_key(s, drop.salt)
                        state.aux[k] = update_freshness(state.aux[k], masks[s], drop.decay)
                    gates = {s: masks[s] * state.aux[fresh_key(s, drop.salt)]
                             for s in rnd.shift_list}
                else:
                    gates = {s: masks[s] for s in rnd.shift_list}
                self_w, ws = gated_weights(rnd, gates)
                dropped = {s: torch.nonzero(masks[s] == 0).reshape(-1).to(device)
                           for s in union if drop is not None and prefix is not None
                           and not bool(masks[s].all())}
                out.append(_RefRound(rnd, enc, (self_w.to(device),
                                                {s: w.to(device) for s, w in ws.items()}),
                                     dropped))
            return out

        def mix(rd: _RefRound, x: torch.Tensor, nbrs: Dict[int, torch.Tensor]) -> torch.Tensor:
            return mix_leaf(rd.plan, x, nbrs, rd.weights)

        def coded(state: AlgoState, rd: _RefRound, li: int, lw, z: torch.Tensor) -> torch.Tensor:
            """Encode ``z`` at the round's counter (threading a stateful
            wire's codec state) and decode it densely into float32."""
            seed = leaf_seed(rd.enc, salt, li)
            if wkey is None:
                payload = lw.encode(z, seed)
            else:
                payload, _ = wire.encode_leaf_stateful(z, seed, li, state.aux[wkey])
            return lw.decode(payload, torch.empty(z.shape, dtype=torch.float32, device="meta"))

        def advance(rd: _RefRound, s: int, acc: torch.Tensor, dec: torch.Tensor,
                    blend=None, decay=None) -> None:
            """``acc + roll(dec, s)`` (ECD: ``decay*acc + blend*roll(dec, s)``)
            in place, the rows whose edge dropped left as they were."""
            rows = rd.dropped.get(s)
            kept = acc.index_select(0, rows) if rows is not None else None
            nb = torch.roll(dec, s, dims=0)
            if blend is None:
                acc.add_(nb)
            else:
                acc.mul_(decay).add_(nb.mul_(blend))
            if kept is not None:
                acc.index_copy_(0, rows, kept)

        def gossip_leaf(state, rnds, li, lw, x, g, lr, aux):
            """Every round of one leaf; ``g`` enters round 0 (DCD, ECD,
            CHOCO, DeepSqueeze) or follows the last round (D-PSGD, naive)."""
            if name in ("dpsgd", "naive"):
                cur = x
                for rd in rnds:
                    dec = cur if name == "dpsgd" else coded(state, rd, li, lw, cur)
                    cur = mix(rd, dec, {s: torch.roll(dec, s, dims=0)
                                        for s in rd.plan.shift_list})
                    del dec
                x.copy_(cur.sub_(lr * g))
                return
            for r, rd in enumerate(rnds):
                lr_g = lr * g if r == 0 else None
                if name == "dcd":
                    reps = aux["rep"]
                    z = mix(rd, x, {s: reps[s][li] for s in rd.plan.shift_list})
                    if lr_g is not None:
                        z.sub_(lr_g)                                     # X_half
                    dec = coded(state, rd, li, lw, z.sub_(x))           # Z = X_half - X
                    del z
                    x.add_(dec)
                    for s in union:
                        advance(rd, s, reps[s][li], dec)
                elif name == "choco":
                    hs, hats = aux["hat_self"][li], aux["hat"]
                    if lr_g is not None:
                        x.sub_(lr_g)                                     # X_half
                    dec = coded(state, rd, li, lw, x - hs)              # Z = X_half - hat_self
                    hs.add_(dec)
                    for s in union:
                        advance(rd, s, hats[s][li], dec)
                    mixed = mix(rd, hs, {s: hats[s][li] for s in rd.plan.shift_list})
                    x.add_(gamma * mixed.sub_(hs))                      # + gamma*(mix - hat)
                elif name == "deepsqueeze":
                    e = aux["err_self"][li]
                    if lr_g is not None:
                        x.sub_(lr_g)                                     # X_half
                    v = x + e                                            # V = X_half + E
                    dec = coded(state, rd, li, lw, v)
                    e.copy_(v - dec)
                    del v
                    mixed = mix(rd, dec, {s: torch.roll(dec, s, dims=0)
                                          for s in rd.plan.shift_list})
                    x.add_(mixed.sub_(dec))                              # + (mix(D) - D_self)
                else:   # ecd, s_t the counter plus one as a float32 value
                    ts, tildes = aux["tilde_self"][li], aux["tilde"]
                    s_t = np.float32(rd.enc + 1)
                    za, zb = (float(np.float32(1.0) - np.float32(0.5) * s_t),
                              float(np.float32(0.5) * s_t))
                    blend = float(np.float32(2.0) / s_t)
                    decay = float(np.float32(1.0) - np.float32(2.0) / s_t)
                    x_next = mix(rd, ts, {s: tildes[s][li] for s in rd.plan.shift_list})
                    if lr_g is not None:
                        x_next.sub_(lr_g)
                    dec = coded(state, rd, li, lw, za * x + zb * x_next)
                    ts.mul_(decay).add_(blend * dec)
                    for s in union:
                        advance(rd, s, tildes[s][li], dec, blend, decay)
                    x.copy_(x_next)
                    del x_next
                del dec, lr_g

        def step(state: AlgoState, grads: Any, key: Any, lr: float) -> AlgoState:
            del key     # randomness is a function of the step counter
            lr32 = float(np.float32(lr))
            items = leaf_items(state.params)
            aux = {k: tree_leaves(v) for k, v in state.aux.items() if k.endswith("_self")}
            if prefix is not None:
                aux[prefix] = {s: tree_leaves(state.aux[f"{prefix}{s:+d}"]) for s in union}
            with torch.no_grad():
                rnds = plan_rounds(state, items[0][1].device)
                for li, ((path, x), g) in enumerate(zip(items, tree_leaves(grads))):
                    lw = wire.route(path, x.shape) if wire is not None else None
                    gossip_leaf(state, rnds, li, lw, x, g.to(x.dtype), lr32, aux)
            state.step += 1
            return state

        return step


def make_algorithm(name: str, n_nodes: int, topology: str = "ring",
                   compressor: Optional[Compressor] = None, gamma: float = 0.5) -> Algorithm:
    """An :class:`Algorithm` on the named topology's mixing matrix."""
    W = topo.make_topology(topology, n_nodes)
    topo.check_mixing_matrix(W)
    return Algorithm(name=name, W=W, compressor=compressor or IdentityCompressor(),
                     gamma=gamma)


# --------------------------------------------------------------------------
# Diagnostics
# --------------------------------------------------------------------------

def consensus_distance(X: Any) -> torch.Tensor:
    """``sum_i ||x_i - x_bar||²``, the quantity bounded by (27)/(36) in the paper."""
    return sum(torch.sum((leaf - leaf.mean(dim=0, keepdim=True)) ** 2)
               for leaf in tree_leaves(X))


def average_model(X: Any) -> Any:
    """The paper's output: ``(1/n) sum_i x_T^{(i)}``."""
    return tree_map(lambda leaf: leaf.mean(dim=0), X)
