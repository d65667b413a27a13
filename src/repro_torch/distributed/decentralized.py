"""Decentralized training step over a stacked node axis: DCD-PSGD, ECD-PSGD,
CHOCO-SGD and DeepSqueeze.

The port of the JAX package's ``distributed/decentralized.py`` for the
paper's two algorithms and the two error-feedback algorithms on flat plans
without drops.  State is stacked: every leaf has a leading node axis of
length ``plan.n`` on one device, and a plan shift ``s`` is
``torch.roll(payload, s, dims=0)`` of the ENCODED payload — the packed
words and scales, as the JAX runtime's collective-permute moves them.

* DCD (``_dcd_round``, ``decentralized.py:434``): one replica tree per shift
  (``rep{s:+d}``), advanced by the received compressed deltas; the invariant
  ``rep{s} == roll(X, s)`` holds exactly here, because X and every replica
  are advanced by the same kernel on the same words.
* ECD (``_ecd_round``, ``decentralized.py:463``): ``tilde_self`` plus one
  estimate per shift with Algorithm 2's ``(1 - 2/s_t, 2/s_t)`` update; the
  scalars are float32 values, as in JAX.
* CHOCO (``_choco_round``, ``decentralized.py:496``): ``hat_self`` plus one
  estimate per shift, advanced by the received compressed differences
  ``Z = X_half - hat_self``; mixing runs on the estimates with consensus
  stepsize ``gamma``.  ``hat{s} == roll(hat_self, s)`` holds exactly here.
* DeepSqueeze (``_deepsqueeze_round``, ``decentralized.py:532``): ``err_self``
  only.  The error-compensated model value ``V = X_half + err`` is encoded,
  the residual ``V - dec(V)`` is kept, and the decoded payloads are mixed:
  ``X = X_half + (mix(D) - D_self)``.  The receive side is stateless.

Unlike the JAX step, which is pure and maps whole trees, a round here walks
the leaves in JAX flatten order and finishes each leaf — mix, optimizer
update, encode (a send kernel: K1, K5a, K6 or K7a), decode into params and
replicas (a receive kernel: K2, K5b, K6c or K7b) — before it starts the
next, updating params, replicas, estimates and the optimizer moments IN
PLACE.  At full width a whole-tree temporary is gigabytes; a leaf-at-a-time
round holds a few leaf-sized ones.

Each leaf is encoded and decoded through ``wire.route(path, shape)``, its
sub-format under ``adaptive`` and the wire itself otherwise.  A stateful
wire (``lowrank:<r>:warm``) keeps its codec state in ``aux[wire.aux_name]``
(``init_dist_state(..., wire=)``), and the round encodes leaf ``li`` with
``wire.encode_leaf_stateful``, which advances that leaf's warm factor in
place — the same factor, round by round, as the JAX ``encode_tree``
(``decentralized.py:365``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.distributed.gossip import GossipPlan, make_gossip_plan, mix_leaf
from repro_torch.distributed.wire import Payload, WireFormat, leaf_seed, make_wire_format
from repro_torch.optim.optimizers import OptState, Optimizer
from repro_torch.tree import leaf_items, tree_leaves, tree_map

ALGOS = ("dcd", "ecd", "choco", "deepsqueeze")

# per-algorithm wire salts of the JAX runtime (decentralized.py:450, :480,
# :507, :549)
_SALT = {"dcd": 2, "ecd": 3, "choco": 4, "deepsqueeze": 5}


@dataclasses.dataclass
class DistState:
    params: Any                 # stacked (n, ...) leaves
    opt: OptState               # stacked moments
    aux: Dict[str, Any]         # replica / estimate trees keyed by shift
    step: int


def _resolve_plan(plan) -> GossipPlan:
    return plan if isinstance(plan, GossipPlan) else GossipPlan.ring(int(plan))


def init_dist_state(algo: str, params_single: Any, plan, opt: Optimizer,
                    wire=None) -> DistState:
    """Stack ``params_single`` over the plan's nodes; one replica (DCD) or
    estimate (ECD, CHOCO) tree per shift, each its own copy of the stacked
    params, or DeepSqueeze's zero residual.  ``wire`` (a
    :class:`WireFormat` or spec) is needed when it is stateful
    (``lowrank:<r>:warm``): its initial codec state goes under
    ``aux[wire.aux_name]``.  Stateless wires add nothing."""
    if algo not in ALGOS:
        raise ValueError(f"ported algorithms are {ALGOS}, got {algo!r}")
    plan = _resolve_plan(plan)
    n = plan.n
    X = tree_map(lambda p: p.detach().unsqueeze(0).repeat((n,) + (1,) * p.dim()),
                 params_single)

    def copy():
        return tree_map(torch.clone, X)

    if algo == "dcd":
        aux = {f"rep{s:+d}": copy() for s in plan.shift_union}
    elif algo == "ecd":
        aux = {"tilde_self": copy()}
        aux.update({f"tilde{s:+d}": copy() for s in plan.shift_union})
    elif algo == "choco":
        aux = {"hat_self": copy()}
        aux.update({f"hat{s:+d}": copy() for s in plan.shift_union})
    else:
        aux = {"err_self": tree_map(torch.zeros_like, X)}
    if wire is not None:
        wire = make_wire_format(wire)
        if wire.stateful:
            aux[wire.aux_name] = wire.init_aux(X)
    return DistState(params=X, opt=opt.init(X), aux=aux, step=0)


def _moment_leaves(opt: OptState, n_leaves: int):
    """Per-leaf first and second moments, ``None`` where the optimizer keeps none."""
    return tuple(tree_leaves(t) if t is not None else [None] * n_leaves
                 for t in (opt.m, opt.v))


def _roll_payload(payload: Payload, s: int) -> Payload:
    return {k: torch.roll(v, s, dims=0) for k, v in payload.items()}


def _node_grads(loss_fn: Callable, params: Any, batch: Dict[str, torch.Tensor]):
    """Per-node losses and gradients in one backward: node ``i`` evaluates
    ``loss_fn(params[i], batch[i])``; the nodes share no parameter, so the
    gradient of the summed losses is every node's own gradient."""
    leaves = tree_leaves(params)
    n = leaves[0].shape[0]
    for l in leaves:
        l.requires_grad_(True)
    try:
        with torch.enable_grad():
            losses, metrics = [], []
            for i in range(n):
                loss_i, met_i = loss_fn(tree_map(lambda l: l[i], params),
                                        {k: v[i] for k, v in batch.items()})
                losses.append(loss_i)
                metrics.append(met_i)
            losses_t = torch.stack(losses)
            losses_t.sum().backward()
        grads = [l.grad for l in leaves]
    finally:
        for l in leaves:
            l.grad = None
            l.requires_grad_(False)
    met = {k: torch.stack([m[k].detach() for m in metrics]).mean() for k in metrics[0]}
    return losses_t.detach(), met, grads


def make_dist_train_step(loss_fn: Callable, algo: str, opt: Optimizer, wire, plan,
                         lr_schedule: Callable[[int], float], gamma: float = 0.5):
    """Build ``step(state, batch) -> (state, metrics)``; ``state`` is updated
    in place and returned.

    ``loss_fn(params_i, batch_i) -> (loss, metrics)`` is the per-node loss;
    ``batch`` leaves are (n, per_node_batch, ...).  ``wire`` is a
    :class:`WireFormat` or spec string (``"quant:4"``, ``"sign"``), ``plan``
    a :class:`GossipPlan` or a node count (ring), ``lr_schedule`` a host
    function of the integer step.  ``gamma`` is CHOCO's consensus stepsize
    (``X <- X_half + gamma*(mix(hat) - hat_self)``), in (0, 1]; the other
    algorithms ignore it."""
    if algo not in ALGOS:
        raise ValueError(f"ported algorithms are {ALGOS}, got {algo!r}")
    if not 0.0 < gamma <= 1.0:
        raise ValueError(f"CHOCO consensus stepsize gamma={gamma} must lie in (0, 1]")
    gamma32 = float(np.float32(gamma))
    wire: WireFormat = make_wire_format(wire)
    plan = make_gossip_plan(_resolve_plan(plan))
    salt = _SALT[algo]
    wire_aux_key = wire.aux_name if wire.stateful else None

    def _leaves(state: DistState):
        """The params' leaves in flatten order with each one's wire format."""
        items = leaf_items(state.params)
        return [x for _, x in items], [wire.route(p, x.shape) for p, x in items]

    def _encode(state: DistState, li: int, lw: WireFormat, z: torch.Tensor) -> Payload:
        seed = leaf_seed(state.step, salt, li)
        if wire_aux_key is None:
            return lw.encode(z, seed)
        if wire_aux_key not in state.aux:
            raise KeyError(f"the {wire.name} wire is stateful: build the state with "
                           f"init_dist_state(..., wire=) to add {wire_aux_key!r}")
        payload, _ = wire.encode_leaf_stateful(z, seed, li, state.aux[wire_aux_key])
        return payload

    def _dcd_round(state: DistState, grads: List[torch.Tensor], lr: float, t: int):
        X, lws = _leaves(state)
        m, v = _moment_leaves(state.opt, len(X))
        reps = {s: tree_leaves(state.aux[f"rep{s:+d}"]) for s in plan.shift_union}
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None        # free each gradient once used
            z = mix_leaf(plan, x, {s: reps[s][li] for s in plan.shift_list})
            z.add_(opt.update_leaf(g, m[li], v[li], x, lr, t))   # X_half
            del g
            z.sub_(x)                                            # Z = X_half - X
            payload = _encode(state, li, lw, z)
            del z
            # receive side: one fused kernel per leaf and per tree; every
            # replica advances with the rolled words, so rep{s} == roll(X, s)
            lw.decode_axpy_(payload, x, 1.0)
            for s in plan.shift_union:
                lw.decode_axpy_(_roll_payload(payload, s), reps[s][li], 1.0)

    def _ecd_round(state: DistState, grads: List[torch.Tensor], lr: float, t: int):
        s_t = np.float32(state.step + 1)
        za, zb = float(np.float32(1.0) - np.float32(0.5) * s_t), float(np.float32(0.5) * s_t)
        blend = float(np.float32(2.0) / s_t)
        est_decay = float(np.float32(1.0) - np.float32(2.0) / s_t)
        X, lws = _leaves(state)
        m, v = _moment_leaves(state.opt, len(X))
        tilde_self = tree_leaves(state.aux["tilde_self"])
        tildes = {s: tree_leaves(state.aux[f"tilde{s:+d}"]) for s in plan.shift_union}
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None
            x_next = mix_leaf(plan, tilde_self[li], {s: tildes[s][li] for s in plan.shift_list})
            x_next.add_(opt.update_leaf(g, m[li], v[li], x, lr, t))
            del g
            z = za * x + zb * x_next
            payload = _encode(state, li, lw, z)
            del z
            # est_decay*tilde + blend*decode in one fused pass per tree
            lw.decode_axpy_(payload, tilde_self[li], blend, est_decay)
            for s in plan.shift_union:
                lw.decode_axpy_(_roll_payload(payload, s), tildes[s][li], blend, est_decay)
            x.copy_(x_next)

    def _choco_round(state: DistState, grads: List[torch.Tensor], lr: float, t: int):
        X, lws = _leaves(state)
        m, v = _moment_leaves(state.opt, len(X))
        hat_self = tree_leaves(state.aux["hat_self"])
        hats = {s: tree_leaves(state.aux[f"hat{s:+d}"]) for s in plan.shift_union}
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None
            x.add_(opt.update_leaf(g, m[li], v[li], x, lr, t))   # X_half
            del g
            z = x - hat_self[li]                                 # Z = X_half - hat_self
            payload = _encode(state, li, lw, z)
            del z
            # every node decodes the words it sent, so hat_self stays equal
            # to each neighbour's hat{s} of it: hat{s} == roll(hat_self, s)
            lw.decode_axpy_(payload, hat_self[li], 1.0)
            for s in plan.shift_union:
                lw.decode_axpy_(_roll_payload(payload, s), hats[s][li], 1.0)
            del payload
            mixed = mix_leaf(plan, hat_self[li], {s: hats[s][li] for s in plan.shift_list})
            mixed.sub_(hat_self[li])
            x.add_(mixed.mul_(gamma32))                          # X_half + gamma*(mix - hat)

    def _deepsqueeze_round(state: DistState, grads: List[torch.Tensor], lr: float, t: int):
        X, lws = _leaves(state)
        m, v = _moment_leaves(state.opt, len(X))
        errs = tree_leaves(state.aux["err_self"])
        for li, (x, lw) in enumerate(zip(X, lws)):
            g, grads[li] = grads[li], None
            x.add_(opt.update_leaf(g, m[li], v[li], x, lr, t))   # X_half
            del g
            err = errs[li].add_(x)                               # V = X_half + err
            payload = _encode(state, li, lw, err)
            d_self = lw.decode_axpy_(payload, torch.zeros_like(x), 1.0)
            # each neighbour's payload is decoded straight into the mix with
            # its weight: acc + w*dec(roll(P, s)), the JAX plan_mix's
            # ``out + w*nbr`` of a zero-based decode, without the buffer
            mixed = plan.self_weight * d_self
            for s, w in plan.shifts:
                lw.decode_axpy_(_roll_payload(payload, s), mixed, w)
            # the residual last: an identity payload is the V buffer itself
            lw.decode_axpy_(payload, err, -1.0)                  # err = V - dec(V)
            del payload
            x.add_(mixed.sub_(d_self))                           # X_half + (mix - D_self)

    round_fn = {"dcd": _dcd_round, "ecd": _ecd_round, "choco": _choco_round,
                "deepsqueeze": _deepsqueeze_round}[algo]

    def step(state: DistState, batch: Dict[str, torch.Tensor]) -> Tuple[DistState, Dict]:
        losses, metrics, grads = _node_grads(loss_fn, state.params, batch)
        lr = lr_schedule(state.step)
        t = state.opt.step + 1
        with torch.no_grad():
            round_fn(state, grads, lr, t)
            state.opt.step = t
            consensus = sum(torch.sum((l - l.mean(dim=0, keepdim=True)) ** 2)
                            for l in tree_leaves(state.params))
        state.step += 1
        return state, {"loss": losses.mean(), "lr": lr, "consensus": consensus, **metrics}

    return step
