"""Decentralized training step over a stacked node axis: the AllReduce and
D-PSGD baselines, naive compression, DCD-PSGD, ECD-PSGD, CHOCO-SGD and
DeepSqueeze, on every gossip plan and schedule, with or without edge drops.

The port of the JAX package's ``distributed/decentralized.py``.  Stacked
(the default), every leaf has a leading node axis of length ``n`` on one
device, and a plan shift ``s`` is ``torch.roll(payload, s, dims=0)`` of the
ENCODED payload — the packed words and scales, as the JAX runtime's
collective-permute moves them; on ranks (below) the same payload travels
between processes (:mod:`~repro_torch.distributed.transport`).

* cpsgd: identical replicas apply the node-mean update (no gossip).
* dpsgd: ``X <- X W - lr*G``, full-precision gossip of X itself.
* naive (salt 1): every node's model is encoded and the decoded models are
  mixed, ``X <- dec(X) W - lr*G``; K4b or K4a decodes the quant wire.
* DCD (JAX ``_dcd_round``, salt 2): one replica tree per union shift
  (``rep{s:+d}``), advanced by the received compressed deltas;
  ``rep{s} == roll(X, s)`` holds exactly here, because X and every replica
  are advanced by the same kernel on the same words.
* ECD (JAX ``_ecd_round``, salt 3): ``tilde_self`` plus one estimate per shift
  with Algorithm 2's ``(1 - 2/s_t, 2/s_t)`` update, ``s_t`` the effective
  counter plus one, as float32 values.
* CHOCO (salt 4): ``hat_self`` plus one estimate per shift, advanced by the
  compressed differences ``Z = X_half - hat_self``; mixing runs on the
  estimates with consensus stepsize ``gamma``.
* DeepSqueeze (salt 5): ``err_self`` only; ``V = X_half + err`` is encoded,
  the residual ``V - dec(V)`` kept, and ``X = X_half + (mix(D) - D_self)``.

Schedules (:class:`~repro_torch.distributed.gossip.GossipSchedule`): a
multi-round schedule runs every round inside one step, round ``r`` of step
``t`` encoding (and drawing its drop masks) with the effective counter
``t * period + r``; a time-varying one (``exp``) runs the one round ``t %
period`` with counter ``t``.  The gradient update rides round 0 for the
replica-tracking algorithms and DeepSqueeze; dpsgd and naive add it after
the last round.  Every union replica or estimate advances on every round;
the mix uses that round's shifts only.

Drops (``drop=``, :mod:`repro_torch.distributed.failures`): each round draws
the delivery masks of its shifts (of every union shift for DCD, ECD and
CHOCO, which also advance their freshness vectors ``fresh{s:+d}@drop{salt}``
and gate with ``mask * fresh``), mixes with
:func:`~repro_torch.distributed.gossip.gated_weights`, and freezes each
replica, estimate or hat on its dropped edges: the dropped nodes' rows are
saved before the in-place decode and put back after it, bit-equal to the
JAX package's ``select_delivered``.  The masks and freshness vectors are
(n,) float32 vectors on the host.  cpsgd refuses drops.

Ranks (``group=``, a :class:`~repro_torch.launch.mesh.NodeGroup`): one
process a node, the counterpart of the JAX runtime sharding the node axis
over its mesh.  A rank holds its node's slice of every tree, each leaf with
a node axis of length 1, so shapes, wire routing and block choices are the
stacked mode's; it encodes with its node's counter offset
(:meth:`~repro_torch.distributed.wire.WireFormat.node_offset`), so its
containers are its rows of the stacked encode, and sends only those
containers to its plan neighbours
(:class:`~repro_torch.distributed.transport.RankTransport`).  Per-node plan
weights, drop masks and freshness are host (n,) vectors, identical on every
rank, of which a rank takes its own entry; a dropped edge carries nothing.
C-PSGD's node mean is an all-reduce, the loss metric a gather, the consensus
metric node 0's params broadcast and an all-reduce.  Every state and every
per-step loss is bit-equal to the stacked mode's, C-PSGD's params within
the all-reduce's summation order.

Unlike the JAX step, which is pure and maps whole trees, a step here walks
the leaves in JAX flatten order with the rounds inside, and finishes each
leaf — mix, optimizer update, encode (a send kernel: K1, K3, K5a, K6 or K7a),
decode into params and replicas (a receive kernel: K2, K4a, K4b, K5b, K6c or
K7b) — before it starts the next, updating params, replicas, estimates and
the optimizer moments IN PLACE.  At full width a whole-tree temporary is
gigabytes; a leaf-at-a-time step holds a few leaf-sized ones.  The rounds of
one leaf depend on that leaf only; what they share across leaves (masks,
freshness, gated weights) is computed for every round before the leaf loop.

Spans (:mod:`repro_torch.trace`, off by default): a step is the span
``step``, its per-node loss loop ``model.forward``, the backward
``model.backward``, and its metrics ``step.metrics``.  Every leaf operation
of the algorithm bodies lies in one of ``optim.update`` (the optimizer),
``gossip.mix`` (a mix, and the sum it is added to or copied into),
``gossip.encode`` (the send kernel and the ops that build what it encodes,
the optimizer's update added to ``X_half`` included), ``gossip.decode``
(every receive, the dropped rows kept and put back, a dropped edge's
zeros) or ``transport.<label>`` (each transport call).

Each leaf is encoded and decoded through ``wire.route(path, shape)``, its
sub-format under ``adaptive``.  A stateful wire (``lowrank:<r>:warm``) keeps
its codec state in ``aux[wire.aux_name]`` (``init_dist_state(...,
wire=)``), advanced in place by ``wire.encode_leaf_stateful``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.failures import (
    edge_drop_mask,
    fresh_key,
    make_drop_spec,
    update_freshness,
)
from repro_torch.distributed.gossip import (
    GossipPlan,
    GossipSchedule,
    as_schedule,
    gated_weights,
    make_gossip_plan,
    mix_leaf,
    weight_for,
)
from repro_torch.distributed.transport import Lazy, make_transport, wire_refused_shapes
from repro_torch.distributed.wire import Payload, WireFormat, leaf_seed, make_wire_format
from repro_torch.optim.optimizers import OptState, Optimizer
from repro_torch.trace import span
from repro_torch.tree import leaf_items, tree_from_items, tree_leaves, tree_map, unstack

ALGOS = ("cpsgd", "dpsgd", "naive", "dcd", "ecd", "choco", "deepsqueeze")
# the algorithms that encode through a wire format
WIRE_ALGOS = ("naive", "dcd", "ecd", "choco", "deepsqueeze")
# the algorithms that keep replicas or estimates of their neighbours
REPLICA_ALGOS = ("dcd", "ecd", "choco")

# per-algorithm wire salts of the JAX runtime (decentralized.py:421, :450,
# :480, :509, :547)
_SALT = {"naive": 1, "dcd": 2, "ecd": 3, "choco": 4, "deepsqueeze": 5}


@dataclasses.dataclass
class DistState:
    params: Any                 # stacked (n, ...) leaves
    opt: OptState               # stacked moments
    aux: Dict[str, Any]         # replica / estimate trees keyed by shift
    step: int


def _resolve_plan(plan) -> GossipSchedule:
    """A plan or schedule, or an int node count (ring), as a schedule."""
    if not isinstance(plan, (GossipPlan, GossipSchedule)):
        plan = GossipPlan.ring(int(plan))
    return as_schedule(plan)


def _check_algo(algo: str) -> None:
    if algo not in ALGOS:
        raise ValueError(f"algorithms are {ALGOS}, got {algo!r}")


def _stored(l: torch.Tensor, aux_dtype) -> torch.dtype:
    """The dtype of a replica or estimate of the params leaf ``l``: float32
    leaves in ``aux_dtype`` (when given), every other leaf in its own."""
    return aux_dtype if aux_dtype is not None and l.dtype == torch.float32 else l.dtype


def _cast_aux(l: torch.Tensor, aux_dtype) -> torch.Tensor:
    """A copy of the params leaf ``l`` as a replica or estimate leaf."""
    return l.to(_stored(l, aux_dtype), copy=True)


def _gossip_aux(algo: str, X: Any, sched: GossipSchedule, drop, wire, tp=None,
                aux_dtype=None) -> dict:
    """The aux trees of ``algo`` over the params ``X``: every replica or
    estimate an exact copy of its neighbour's params (shifted by the
    transport ``tp`` to resync, X itself at init, where every node holds the
    same params), DeepSqueeze's zero residual, fresh freshness vectors and
    the wire's initial codec state.  ``aux_dtype`` stores the replicas,
    estimates and residual (not the freshness vectors or codec state)."""
    def copy(s: int):
        if tp is None or not s:
            return tree_map(lambda l: _cast_aux(l, aux_dtype), X)
        items = leaf_items(X)
        return tree_from_items([(p, _cast_aux(l, aux_dtype)) for p, l in zip(
            [p for p, _ in items], tp.shift_tree([l for _, l in items], s))])

    aux: Dict[str, Any] = {}
    prefix = {"dcd": "rep", "ecd": "tilde", "choco": "hat"}.get(algo)
    if algo in ("ecd", "choco"):
        aux[f"{prefix}_self"] = copy(0)
    if prefix is not None:
        for s in sched.shift_union:
            aux[f"{prefix}{s:+d}"] = copy(s)
    if algo == "deepsqueeze":
        aux["err_self"] = tree_map(lambda l: torch.zeros_like(l, dtype=_stored(l, aux_dtype)),
                                   X)
    if drop is not None and algo in REPLICA_ALGOS:
        for s in sched.shift_union:
            aux[fresh_key(s, drop.salt)] = torch.ones((sched.n,), dtype=torch.float32)
    if wire is not None:
        wire = make_wire_format(wire)
        if wire.stateful:
            aux[wire.aux_name] = wire.init_aux(X)
    return aux


def init_dist_state(algo: str, params_single: Any, plan, opt: Optimizer,
                    drop=None, wire=None, group=None, aux_dtype=None) -> DistState:
    """Stack ``params_single`` over the plan's nodes (over one node, the
    rank's own, with a ``group``); one replica (DCD) or
    estimate (ECD, CHOCO) tree per shift of the schedule's union, each its
    own copy of the stacked params, or DeepSqueeze's zero residual; the
    baselines keep none.  ``drop`` (a :class:`DropSpec`, rate or
    ``"rate[:salt[:decay]]"``) adds the freshness vector of every union
    shift for DCD, ECD and CHOCO, keyed ``fresh{s:+d}@drop{salt}``.
    ``wire`` (a :class:`WireFormat` or spec) is needed when it is stateful
    (``lowrank:<r>:warm``): its codec state goes under ``aux[wire.aux_name]``.
    ``aux_dtype`` (None or ``torch.bfloat16``) stores the replicas,
    estimates and DeepSqueeze's residual, as the JAX package's plans for
    the biggest architectures do; their receives then run the kernels'
    bf16-accumulator variants, and every update rounds back into it."""
    _check_algo(algo)
    sched = _resolve_plan(plan)
    nodes = make_transport(group, sched.n).nodes
    X = tree_map(lambda p: p.detach().unsqueeze(0).repeat((nodes,) + (1,) * p.dim()),
                 params_single)
    aux = _gossip_aux(algo, X, sched, make_drop_spec(drop), wire, aux_dtype=aux_dtype)
    return DistState(params=X, opt=opt.init(X), aux=aux, step=0)


def rekey_dist_state(state: DistState, algo: str, plan, drop=None, wire=None,
                     group=None, aux_dtype=None) -> DistState:
    """Re-key the aux trees for a new ``{plan, wire}`` at a phase boundary,
    keeping params, optimizer moments and the step counter: every replica or
    estimate becomes ``roll(X, s)`` (the exact current neighbour params),
    DeepSqueeze's residual zero, the codec state ``wire.init_aux`` and every
    freshness vector ones; with a ``group`` each rank receives its
    neighbours' X (label ``resync``).  The old aux is released before the new one is
    built, so the peak holds one set of aux trees.  ``aux_dtype`` as in
    :func:`init_dist_state`.  Updates ``state`` in place and returns it."""
    _check_algo(algo)
    sched = _resolve_plan(plan)
    state.aux = {}
    state.aux = _gossip_aux(algo, state.params, sched, make_drop_spec(drop), wire,
                            make_transport(group, sched.n), aux_dtype)
    return state


def _moment_leaves(opt: OptState, n_leaves: int):
    """Per-leaf first and second moments, ``None`` where the optimizer keeps none."""
    return tuple(tree_leaves(t) if t is not None else [None] * n_leaves
                 for t in (opt.m, opt.v))


def _on_device(w, device):
    """A plan weight for the device: a scalar stays a float, an (n,) numpy
    vector becomes a float32 tensor there, once a round rather than once a
    leaf (a copy from host memory waits for the device's queue).  The
    vector is rounded to float32 in numpy, so no float64 tensor enters the
    step (the same rounding as torch's)."""
    if isinstance(w, np.ndarray):
        return torch.from_numpy(w.astype(np.float32)).to(device)
    return w


def _received(payload: Optional[Payload], like: torch.Tensor,
              read: Callable[[Payload], torch.Tensor]) -> torch.Tensor:
    """``read(payload)``, or zeros like ``like`` where a dropped edge
    brought no payload (its mixing weight is 0)."""
    with span("gossip.decode"):
        return torch.zeros_like(like) if payload is None else read(payload)


def _node_grads(loss_fn: Callable, params: Any, batch: Dict[str, torch.Tensor]):
    """Per-node losses, metrics and gradients in one backward: node ``i``
    evaluates ``loss_fn(params[i], batch[i])``; the nodes share no
    parameter, so the gradient of the summed losses is every node's own
    gradient.  Losses and each metric come back as (nodes,) vectors.  The
    nodes' slices come from one ``torch.unbind`` a leaf
    (:func:`~repro_torch.tree.unstack`), so the backward stacks each leaf's
    node gradients once instead of adding up a full-size zero-filled
    gradient a node."""
    leaves = tree_leaves(params)
    for l in leaves:
        l.requires_grad_(True)
    try:
        with torch.enable_grad():
            with span("model.forward"):
                losses, metrics = [], []
                for i, params_i in enumerate(unstack(params)):
                    loss_i, met_i = loss_fn(params_i, {k: v[i] for k, v in batch.items()})
                    losses.append(loss_i)
                    metrics.append(met_i)
                losses_t = torch.stack(losses)
            with span("model.backward"):
                losses_t.sum().backward()
        grads = [l.grad for l in leaves]
    finally:
        for l in leaves:
            l.grad = None
            l.requires_grad_(False)
    met = {k: torch.stack([m[k].detach() for m in metrics]) for k in metrics[0]}
    return losses_t.detach(), met, grads


@dataclasses.dataclass
class _Round:
    """One gossip round of a step: its plan, effective encode counter, the
    mixing weights on the device (``None``: the plan's own, unchanged) and,
    under drops, every exchanged shift's (n,) delivery mask and, stacked,
    the dropped rows of every replica shift."""
    plan: GossipPlan
    enc: int
    weights: Optional[Tuple[Any, Dict[int, Any]]] = None
    dropped: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    masks: Optional[Dict[int, torch.Tensor]] = None


def make_dist_train_step(loss_fn: Callable, algo: str, opt: Optimizer, wire, plan,
                         lr_schedule: Callable[[int], float], gamma: float = 0.5,
                         drop=None, group=None):
    """Build ``step(state, batch) -> (state, metrics)``; ``state`` is updated
    in place and returned.

    ``loss_fn(params_i, batch_i) -> (loss, metrics)`` is the per-node loss;
    ``batch`` leaves are (n, per_node_batch, ...).  ``wire`` is a
    :class:`WireFormat` or spec string (``"quant:4"``, ``"sign"``), or
    ``None`` (full precision: cpsgd and dpsgd, which ignore any wire);
    ``plan`` a :class:`GossipPlan`, :class:`GossipSchedule` or a node count
    (ring); ``lr_schedule`` a host function of the integer step.  ``gamma``
    is CHOCO's consensus stepsize (``X <- X_half + gamma*(mix(hat) -
    hat_self)``), in (0, 1]; the other algorithms ignore it.  ``drop`` (a
    :class:`DropSpec`, rate or ``"rate[:salt[:decay]]"``; None or 0: none)
    injects the deterministic edge drops described in the module
    docstring.  ``group`` (a :class:`~repro_torch.launch.mesh.NodeGroup` of
    the plan's ``n`` ranks) runs this rank's node only, its state from
    ``init_dist_state(..., group=)``.  ``step.transport`` is the step's
    transport, whose ``stats`` record what each exchange was handed, by
    label (:class:`~repro_torch.distributed.transport.TransportStats`)."""
    _check_algo(algo)
    if not 0.0 < gamma <= 1.0:
        raise ValueError(f"CHOCO consensus stepsize gamma={gamma} must lie in (0, 1]")
    gamma32 = float(np.float32(gamma))
    sched = _resolve_plan(plan)
    rounds, period, union, n = sched.rounds, sched.period, sched.shift_union, sched.n
    time_varying = sched.time_varying and period > 1
    drop = make_drop_spec(drop)
    if drop is not None and algo == "cpsgd":
        raise ValueError("drop injection models gossip-edge failure; the cpsgd AllReduce "
                         "baseline assumes the reliable datacenter fabric")
    if algo in WIRE_ALGOS:
        if wire is None:
            raise ValueError(f"{algo} encodes its gossip: give it a wire format")
        wire = make_wire_format(wire)
    else:
        wire = None
    salt = _SALT.get(algo)
    wire_aux_key = wire.aux_name if wire is not None and wire.stateful else None
    tp = make_transport(group, n)
    refused: List[frozenset] = []       # the payload whitelist, from the first step

    def _leaves(state: DistState):
        """The params' paths and leaves in flatten order with each leaf's
        wire format."""
        items = leaf_items(state.params)
        return ([p for p, _ in items], [x for _, x in items],
                [wire.route(p, x.shape) if wire is not None else None for p, x in items])

    def _encode(state: DistState, enc: int, li: int, lw: WireFormat, z: torch.Tensor) -> Payload:
        seed = leaf_seed(enc, salt, li)
        offset = 0 if tp.rank is None else lw.node_offset(z.shape, tp.rank)
        if wire_aux_key is None:
            return lw.encode(z, seed, offset)
        if wire_aux_key not in state.aux:
            raise KeyError(f"the {wire.name} wire is stateful: build the state with "
                           f"init_dist_state(..., wire=) to add {wire_aux_key!r}")
        payload, _ = wire.encode_leaf_stateful(z, seed, li, state.aux[wire_aux_key], offset)
        return payload

    def _send(rnd: "_Round", payload: Payload, shifts) -> Dict[int, Optional[Payload]]:
        """This round's neighbour payloads of the shifts (``None``: dropped)."""
        return tp.exchange(payload, shifts, rnd.masks, refuse=refused[0])

    def _plan_rounds(state: DistState, device) -> List[_Round]:
        """This step's rounds with their counters, and under drops their
        masks: freshness advanced round by round (replica algorithms), the
        gated weights and the dropped rows, all before the leaf loop."""
        if time_varying:
            todo = [(rounds[state.step % period], state.step)]
        else:
            todo = [(rnd, state.step * period + r) for r, rnd in enumerate(rounds)]
        out = []
        for rnd, enc in todo:
            if drop is None:
                weights = None if rnd.uniform else (
                    _on_device(tp.local(rnd.self_weight), device),
                    {s: _on_device(tp.local(w), device) for s, w in rnd.shifts})
                out.append(_Round(rnd, enc, weights))
                continue
            if algo in REPLICA_ALGOS:
                masks = {s: edge_drop_mask(n, s, enc, drop) for s in union}
                for s in union:
                    k = fresh_key(s, drop.salt)
                    state.aux[k] = update_freshness(state.aux[k], masks[s], drop.decay)
                gates = {s: masks[s] * state.aux[fresh_key(s, drop.salt)]
                         for s in rnd.shift_list}
                dropped = {s: torch.nonzero(masks[s] == 0).reshape(-1).to(device)
                           for s in union if not bool(masks[s].all())}
            else:
                masks = gates = {s: edge_drop_mask(n, s, enc, drop) for s in rnd.shift_list}
                dropped = {}
            self_w, ws = gated_weights(rnd, gates)
            out.append(_Round(rnd, enc, (tp.local(self_w).to(device),
                                         {s: tp.local(w).to(device) for s, w in ws.items()}),
                              dropped if tp.rank is None else {}, masks))
        return out

    def _advance(rnd: _Round, s: int, lw: WireFormat, payload: Optional[Payload],
                 acc: torch.Tensor, weight: float, acc_weight: float = 1.0) -> None:
        """Decode the neighbour payload of shift ``s`` into the replica
        ``acc`` in place, leaving the rows of the nodes whose edge dropped as
        they were (a rank whose edge dropped received ``None``)."""
        if payload is None:
            return
        rows = rnd.dropped.get(s)
        kept = acc.index_select(0, rows) if rows is not None else None
        lw.decode_axpy_(payload, acc, weight, acc_weight)
        if kept is not None:
            acc.index_copy_(0, rows, kept)

    def _cpsgd(state, grads, lr, t, X, lws, m, v, rnds):
        for li, x in enumerate(X):
            g, grads[li] = grads[li], None
            upd = opt.update_leaf(g, m[li], v[li], x, lr, t)
            del g
            with span("gossip.mix"):
                x.add_(tp.node_mean(upd).expand_as(upd))

    def _dpsgd(state, grads, lr, t, X, lws, m, v, rnds):
        for li, x in enumerate(X):
            cur = x
            for rnd in rnds:
                got = tp.exchange({"x": cur}, rnd.plan.shift_list, rnd.masks, label="dense")
                cur = mix_leaf(rnd.plan, cur, Lazy(
                    lambda s, c=cur, got=got: _received(got[s], c, lambda p: p["x"])),
                    rnd.weights)
                del got
            g, grads[li] = grads[li], None
            upd = opt.update_leaf(g, m[li], v[li], x, lr, t)
            with span("gossip.mix"):
                cur.add_(upd)
                del upd, g
                x.copy_(cur)

    def _naive(state, grads, lr, t, X, lws, m, v, rnds):
        # compress the exchanged models directly — provably non-convergent
        for li, (x, lw) in enumerate(zip(X, lws)):
            cur = x
            for rnd in rnds:
                with span("gossip.encode"):
                    payload = _encode(state, rnd.enc, li, lw, cur)
                got = _send(rnd, payload, rnd.plan.shift_list)
                dec = Lazy(lambda s, c=cur, got=got: _received(got[s], c,
                                                               lambda p: lw.decode(p, c)))
                with span("gossip.decode"):
                    own = lw.decode(payload, cur)
                cur = mix_leaf(rnd.plan, own, dec, rnd.weights)
                del payload, got, dec, own
            g, grads[li] = grads[li], None
            upd = opt.update_leaf(g, m[li], v[li], x, lr, t)
            with span("gossip.mix"):
                cur.add_(upd)
                del upd, g
                x.copy_(cur)

    def _dcd(state, grads, lr, t, X, lws, m, v, rnds):
        reps = {s: tree_leaves(state.aux[f"rep{s:+d}"]) for s in union}
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None
            for r, rnd in enumerate(rnds):
                z = mix_leaf(rnd.plan, x, {s: reps[s][li] for s in rnd.plan.shift_list},
                             rnd.weights)
                if r == 0:
                    upd = opt.update_leaf(g, m[li], v[li], x, lr, t)
                with span("gossip.encode"):
                    if r == 0:
                        z.add_(upd)                                      # X_half
                        del upd, g
                    z.sub_(x)                                            # Z = X_half - X
                    payload = _encode(state, rnd.enc, li, lw, z)
                    del z
                got = _send(rnd, payload, union)
                # one fused receive kernel per tree; every replica advances
                # with the rolled words, so rep{s} == roll(X, s)
                with span("gossip.decode"):
                    lw.decode_axpy_(payload, x, 1.0)
                    for s in union:
                        _advance(rnd, s, lw, got[s], reps[s][li], 1.0)
                del payload, got

    def _ecd(state, grads, lr, t, X, lws, m, v, rnds):
        tilde_self = tree_leaves(state.aux["tilde_self"])
        tildes = {s: tree_leaves(state.aux[f"tilde{s:+d}"]) for s in union}
        consts = []
        for rnd in rnds:
            s_t = np.float32(rnd.enc + 1)
            consts.append((float(np.float32(1.0) - np.float32(0.5) * s_t),
                           float(np.float32(0.5) * s_t), float(np.float32(2.0) / s_t),
                           float(np.float32(1.0) - np.float32(2.0) / s_t)))
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None
            for r, (rnd, (za, zb, blend, est_decay)) in enumerate(zip(rnds, consts)):
                x_next = mix_leaf(rnd.plan, tilde_self[li],
                                  {s: tildes[s][li] for s in rnd.plan.shift_list}, rnd.weights)
                if r == 0:
                    upd = opt.update_leaf(g, m[li], v[li], x, lr, t)
                with span("gossip.encode"):
                    if r == 0:
                        x_next.add_(upd)
                        del upd, g
                    # s_t is a float32 array in JAX: bf16 estimates and params
                    # promote to float32 here
                    z = za * x.to(torch.float32) + zb * x_next.to(torch.float32)
                    payload = _encode(state, rnd.enc, li, lw, z)
                    del z
                got = _send(rnd, payload, union)
                # est_decay*tilde + blend*decode in one fused pass per tree
                with span("gossip.decode"):
                    lw.decode_axpy_(payload, tilde_self[li], blend, est_decay)
                    for s in union:
                        _advance(rnd, s, lw, got[s], tildes[s][li], blend, est_decay)
                del payload, got
                with span("gossip.mix"):
                    if x_next.dtype == x.dtype:
                        x.copy_(x_next)
                    else:       # bf16 estimates mix to bf16 params, as JAX's X_next
                        X[li] = x = x_next
                    del x_next

    def _choco(state, grads, lr, t, X, lws, m, v, rnds):
        hat_self = tree_leaves(state.aux["hat_self"])
        hats = {s: tree_leaves(state.aux[f"hat{s:+d}"]) for s in union}
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None
            for r, rnd in enumerate(rnds):
                if r == 0:
                    upd = opt.update_leaf(g, m[li], v[li], x, lr, t)
                with span("gossip.encode"):
                    if r == 0:
                        x.add_(upd)                                      # X_half
                        del upd, g
                    z = x - hat_self[li]                                 # Z = X_half - hat_self
                    payload = _encode(state, rnd.enc, li, lw, z)
                    del z
                got = _send(rnd, payload, union)
                # every node decodes the words it sent, so hat_self stays equal
                # to each neighbour's hat{s} of it: hat{s} == roll(hat_self, s)
                with span("gossip.decode"):
                    lw.decode_axpy_(payload, hat_self[li], 1.0)
                    for s in union:
                        _advance(rnd, s, lw, got[s], hats[s][li], 1.0)
                del payload, got
                mixed = mix_leaf(rnd.plan, hat_self[li],
                                 {s: hats[s][li] for s in rnd.plan.shift_list}, rnd.weights)
                with span("gossip.mix"):
                    mixed.sub_(hat_self[li])
                    x.add_(mixed.mul_(weight_for(gamma32, mixed)))       # X_half + gamma*(mix - hat)
                    del mixed

    def _deepsqueeze(state, grads, lr, t, X, lws, m, v, rnds):
        err_items = leaf_items(state.aux["err_self"])
        errs = [e for _, e in err_items]
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None
            for r, rnd in enumerate(rnds):
                if r == 0:
                    upd = opt.update_leaf(g, m[li], v[li], x, lr, t)
                with span("gossip.encode"):
                    if r == 0:
                        x.add_(upd)                                      # X_half
                        del upd, g
                    if errs[li].dtype == x.dtype:
                        err = errs[li].add_(x)                           # V = X_half + err
                    else:   # a bf16 residual: V is float32, and the residual after it (JAX)
                        errs[li] = err = x + errs[li]
                    payload = _encode(state, rnd.enc, li, lw, err)
                got = _send(rnd, payload, rnd.plan.shift_list)
                with span("gossip.decode"):
                    d_self = lw.decode_axpy_(payload, torch.zeros_like(x), 1.0)
                with span("gossip.mix"):
                    if rnd.weights is None and rnd.plan.uniform:
                        # scalar weights: each neighbour's payload is decoded
                        # straight into the mix, acc + w*dec(roll(P, s)) — the
                        # JAX plan_mix's ``out + w*nbr`` of a zero-based decode
                        mixed = rnd.plan.self_weight * d_self
                        for s, w in rnd.plan.shifts:
                            with span("gossip.decode"):
                                lw.decode_axpy_(got[s], mixed, w)
                    else:
                        # per-node or gated weights: the kernels take a scalar
                        # weight, so decode each neighbour at 1.0 and mix
                        self_w, ws = rnd.weights if rnd.weights is not None else (
                            rnd.plan.self_weight, dict(rnd.plan.shifts))
                        mixed = weight_for(self_w, x) * d_self
                        for s in rnd.plan.shift_list:
                            dec = _received(got[s], x, lambda p: lw.decode_axpy_(
                                p, torch.zeros_like(x), 1.0))
                            mixed.add_(weight_for(ws[s], x) * dec)
                            del dec
                # the residual last: an identity payload is the V buffer itself
                with span("gossip.decode"):
                    lw.decode_axpy_(payload, err, -1.0)                  # err = V - dec(V)
                del payload, got
                with span("gossip.mix"):
                    x.add_(mixed.sub_(d_self))                           # X_half + (mix - D_self)
                    del mixed, d_self
        state.aux["err_self"] = tree_from_items([(p, e) for (p, _), e in zip(err_items, errs)])

    run = {"cpsgd": _cpsgd, "dpsgd": _dpsgd, "naive": _naive, "dcd": _dcd, "ecd": _ecd,
           "choco": _choco, "deepsqueeze": _deepsqueeze}[algo]

    def step(state: DistState, batch: Dict[str, torch.Tensor]) -> Tuple[DistState, Dict]:
        with span("step", state.step):
            return _step(state, batch)

    def _step(state: DistState, batch: Dict[str, torch.Tensor]) -> Tuple[DistState, Dict]:
        losses, metrics, grads = _node_grads(loss_fn, state.params, batch)
        lr = lr_schedule(state.step)
        t = state.opt.step + 1
        with torch.no_grad():
            paths, X, lws = _leaves(state)
            if not refused:     # the whitelist guards what leaves a rank
                refused.append(wire_refused_shapes(X, lws) if wire is not None
                               and tp.rank is not None else frozenset())
            m, v = _moment_leaves(state.opt, len(X))
            rnds = [] if algo == "cpsgd" else _plan_rounds(state, X[0].device)
            run(state, grads, lr, t, X, lws, m, v, rnds)
            # a leaf that changed dtype (bf16 aux: ECD's params, DeepSqueeze's
            # residual) was replaced in its list; put the lists back
            state.params = tree_from_items(list(zip(paths, X)))
            state.opt.step = t
            with span("step.metrics"):
                consensus = tp.consensus(X)
                # every node's loss and metrics, averaged in node order
                metrics = {k: tp.gather_nodes(v).mean() for k, v in metrics.items()}
                loss = tp.gather_nodes(losses).mean()
        state.step += 1
        return state, {"loss": loss, "lr": lr, "consensus": consensus, **metrics}

    step.transport = tp     # what the step hands its transport: ``tp.stats``
    return step


# ------------------------------------------------------- deprecated spellings

def gossip_shifts(topology: str, n: int) -> Tuple[float, Dict[int, float]]:
    """Deprecated: use :func:`repro_torch.distributed.gossip.make_gossip_plan`.
    The old ``(self_weight, {shift: weight})`` view of the compiled plan
    (uniform-weight topologies only)."""
    warnings.warn("gossip_shifts is deprecated; use make_gossip_plan(topology, n)",
                  DeprecationWarning, stacklevel=2)
    plan = make_gossip_plan(topology, n)
    if not plan.uniform:
        raise ValueError(f"{topology!r} compiles to per-node weights; use the plan")
    return plan.self_weight, dict(plan.shifts)


_DEPRECATED = {
    "WireCodec": "QuantWire",
    "SparseWireCodec": "SparseWire",
}


def __getattr__(name: str):
    if name in _DEPRECATED:
        from repro_torch.distributed import wire as _wire

        new = _DEPRECATED[name]
        warnings.warn(f"repro_torch.distributed.decentralized.{name} is deprecated; use "
                      f"repro_torch.distributed.wire.{new}", DeprecationWarning, stacklevel=2)
        return getattr(_wire, new)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
