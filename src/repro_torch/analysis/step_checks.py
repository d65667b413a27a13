"""The step analyzer: invariants of one eager distributed train step.

The port of the JAX package's ``analysis/jaxpr_checks.py``, which reads the
jaxpr and compiled HLO of a jitted step.  The port compiles nothing, so
this module runs ONE eager step and reads what it did:

- **payload whitelist** — every tensor the step hands its transport under
  the label ``wire`` is a wire container (packed words, int8 codes, f16
  halves, the per-block f32 scales and values, the low-rank factors); a
  dense f32 param leaf never rides the wire for a compressing format.  The
  transport records each ``(dtype, shape)`` it was handed
  (``step.transport.stats``), on one device or on ranks.
- **decode-kernel call count** — the calls of the receive kernels'
  wrappers (:data:`DECODE_KERNELS`) in one step equal
  ``step_decode_sites(algo, sched) * kernels_per_site``, whose replica
  share is ``sched.replica_payloads``.  Every wrapper counts its calls,
  the plain version's on the CPU included (``call_counts()`` of
  :mod:`repro_torch.kernels.quant`); on the card its launches must equal
  its calls, so no wrapper ran its plain version.
- **no f64 and no host reads** inside the step: a ``TorchDispatchMode``
  (:class:`StepWatch`) records every aten op with a float64 input or
  output, and every read of a tensor on the step's device by the host
  (``aten._local_scalar_dense``, ``aten.nonzero``, ``aten.equal``) — the
  eager counterpart of "no host callback inside the jitted step".

The JAX package's ``jit_compile_count`` (the retrace guard of the phase
loop) has no counterpart: the port runs eagerly and compiles nothing
(``launch/train.py``).  Dtypes are reported in the JAX package's short
names (``u32``, ``s8``, ``f16``, ``f32``), so both packages' reports read
alike; the port's int32 containers hold uint32 words (``kernels/ref.py``)
and are reported as ``u32``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.distributed.decentralized import init_dist_state, make_dist_train_step
from repro_torch.distributed.gossip import as_schedule, make_gossip_plan
from repro_torch.distributed.transport import wire_refused_shapes
from repro_torch.distributed.wire import IdentityWire, leaf_seed, make_wire_format
from repro_torch.kernels import quant
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.tree import leaf_items

# The wrappers a wire's ``decode_axpy_`` reaches (``distributed/wire.py``):
# the fused receives K2, K5b, K6c, K7b and their bf16-accumulator variants;
# K4a, the int8 ``quant`` receive (decode, then the axpy in torch); K4b,
# the packed ``quant`` receive of a leaf whose block is off the 128-lane
# gate.  The sparse and sign receives off the gate run plain torch.
DECODE_KERNELS = (
    "unpack_dequant_axpy_2d",
    "dequantize_2d",
    "unpack_dequant_2d",
    "unpack_sign_axpy_2d",
    "sparse_scatter_axpy_2d",
    "lowrank_axpy_2d",
    "unpack_dequant_axpy_2d_bf16",
    "unpack_sign_axpy_2d_bf16",
    "sparse_scatter_axpy_2d_bf16",
    "lowrank_axpy_2d_bf16",
)

# the JAX package's HLO dtype names (jaxpr_checks.py), by numpy name
_HLO_DTYPE = {
    "uint32": "u32", "uint16": "u16", "uint8": "u8", "int8": "s8",
    "int16": "s16", "int32": "s32", "float16": "f16", "bfloat16": "bf16",
    "float32": "f32", "float64": "f64",
}
_FLOATS = ("f32", "f64")


def short_dtype(dtype) -> str:
    """The JAX package's short name of a torch dtype (or its name): int32,
    the port's container of uint32 words, is ``u32``."""
    name = str(dtype).removeprefix("torch.")
    if name == "int32":
        name = "uint32"
    return _HLO_DTYPE.get(name, name)


# ---------------------------------------------------------------------------
# wire payload accounting
# ---------------------------------------------------------------------------


def payload_dtype_shapes(wire, params) -> set:
    """``{(dtype, shape)}`` of every container ``wire`` builds for the leaves
    of the stacked tree ``params``, each leaf through its route — built on
    the ``meta`` device from the wire itself, never modelled."""
    wire = make_wire_format(wire)
    out = set()
    for path, leaf in leaf_items(params):
        payload = wire.route(path, leaf.shape).encode(
            torch.empty(leaf.shape, dtype=leaf.dtype, device="meta"), 0)
        out |= {(short_dtype(t.dtype), tuple(t.shape)) for t in payload.values()}
    return out


def dense_leaf_shapes(params) -> set:
    return {tuple(leaf.shape) for _, leaf in leaf_items(params)
            if leaf.dtype in (torch.float32, torch.float64)}


def check_permute_payload_whitelist(handed: Sequence[Tuple[str, tuple]], wire,
                                    params) -> List[str]:
    """The acceptance contract on what the step handed its transport under
    ``wire`` (``(dtype, shape)`` pairs, short dtype names):

    - every non-float container dtype of the wire must appear (the
      compressed words are what moves);
    - no f32/f64 tensor may have the shape of a dense stacked param leaf,
      unless the wire's own payload ships a container of that shape
      (``identity`` values).

    Stacked, a container has its global node-axis shape; the per-rank
    ``(1, ...)`` form is what the rank transport refuses as it sends."""
    if not handed:
        return ["no collective-permute found: the step handed its transport "
                "nothing under 'wire'"]
    containers = payload_dtype_shapes(wire, params)
    expected = {d for d, _ in containers if d not in _FLOATS}
    allowed = {s for d, s in containers if d in _FLOATS}
    seen = {d for d, _ in handed}
    violations = [f"wire container dtype {d} never rides a collective-permute "
                  f"(saw {sorted(seen)})" for d in sorted(expected) if d not in seen]
    dense = dense_leaf_shapes(params)
    violations += [f"dense {d}{list(s)} param leaf rides a collective-permute — wire "
                   "compression is bypassed"
                   for d, s in handed if d in _FLOATS and s in dense and s not in allowed]
    return violations


# ---------------------------------------------------------------------------
# decode-kernel call accounting
# ---------------------------------------------------------------------------


def decode_sites(algo: str, sched) -> int:
    """Decode sites a step contains, the JAX package's formula: per round
    the replica-tracking algorithms (dcd/ecd/choco) decode 1 self payload +
    one payload per union shift; DeepSqueeze decodes its own payload twice
    (the residual and ``D_self``) plus one per neighbour shift of the
    round.  A time-varying schedule's trace holds every round's sites."""
    sched = as_schedule(sched)
    if algo in ("dcd", "ecd", "choco"):
        return sched.period * (1 + len(sched.shift_union))
    if algo == "deepsqueeze":
        return sum(2 + len(r.shifts) for r in sched.rounds)
    return 0


def step_decode_sites(algo: str, sched, step: int = 0) -> int:
    """Decode sites that eager step ``step`` runs: :func:`decode_sites`,
    but a time-varying schedule runs its one round ``step % period`` (whose
    replica share is ``sched.replica_payloads``)."""
    sched = as_schedule(sched)
    if not (sched.time_varying and sched.period > 1):
        return decode_sites(algo, sched)
    rnd = sched.rounds[step % sched.period]
    if algo in ("dcd", "ecd", "choco"):
        return 1 + len(sched.shift_union)
    return 2 + len(rnd.shifts) if algo == "deepsqueeze" else 0


def decode_calls(counts: Optional[Dict[str, int]] = None) -> int:
    """The calls of :data:`DECODE_KERNELS` in ``counts`` (default: the
    wrappers' ``call_counts()``)."""
    counts = quant.call_counts() if counts is None else counts
    return sum(counts[k] for k in DECODE_KERNELS)


def kernels_per_site(wire, params, salt: int = 2) -> int:
    """Calls of :data:`DECODE_KERNELS` one encode + ``decode_axpy`` of every
    leaf of the stacked tree ``params`` makes (real tensors, leaf at a
    time; ``params`` is left as it is) — measured on the wire itself, so
    its 128-lane gate is never re-modelled here."""
    wire = make_wire_format(wire)
    before = decode_calls()
    with torch.no_grad():
        for li, (path, leaf) in enumerate(leaf_items(params)):
            lw = wire.route(path, leaf.shape)
            lw.decode_axpy(lw.encode(leaf, leaf_seed(0, salt, li)), leaf, 0.5, 0.5)
    return decode_calls() - before


def expected_kernel_calls(algo: str, sched, wire, params, step: int = 0) -> int:
    if wire is None:
        return 0
    return step_decode_sites(algo, sched, step) * kernels_per_site(wire, params)


# ---------------------------------------------------------------------------
# float64 and host reads: one step under a dispatch mode
# ---------------------------------------------------------------------------

_HOST_READS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
               torch.ops.aten.equal)


class StepWatch(TorchDispatchMode):
    """Records, for every aten op run inside it (the backward's too):
    ``f64_ops``, the ops with a float64 input or output; ``host_reads``, the
    ops by which the host reads a tensor on ``device`` (its type: a host
    mask on the CPU is no read of a step on the card)."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.f64_ops: List[str] = []
        self.host_reads: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.dtype == torch.float64 for t in ins + outs):
            self.f64_ops.append(str(func))
        if func.overloadpacket in _HOST_READS and any(
                t.device.type == self.device_type for t in ins):
            self.host_reads.append(str(func))
        return out


def check_no_f64(watch: StepWatch) -> List[str]:
    return [f"f64 value inside the step: {op}" for op in sorted(set(watch.f64_ops))]


# ---------------------------------------------------------------------------
# case runner: build a step, run it once, check
# ---------------------------------------------------------------------------

# The JAX package's three-leaf testbed: a small leaf under the adaptive
# threshold (rides fp16), a kernel-eligible bulk leaf, and a matrix leaf so
# the lowrank format has a 2-D payload to factor (128 columns keep the fused
# axpy kernel's lane gate open).
_D_SMALL, _D_LARGE, _D_COLS = 32, 1024, 128
_ADAPTIVE_SPEC = "adaptive:128:small=fp16:large=quant:4"


def _toy_params(device="cpu"):
    return {"bias": torch.zeros((_D_SMALL,), device=device),
            "weight": torch.zeros((_D_LARGE,), device=device),
            "proj": torch.zeros((_D_SMALL, _D_COLS), device=device)}


def _toy_batch(n: int, m: int = 4, device="cpu"):
    return {"Ab": torch.ones((n, m, _D_SMALL), device=device),
            "Aw": torch.ones((n, m, _D_LARGE), device=device),
            "b": torch.ones((n, m), device=device)}


def _toy_loss(params, batch):
    pred = batch["Ab"] @ params["bias"] + batch["Aw"] @ params["weight"] \
        + torch.mean(batch["Ab"] @ params["proj"], dim=-1)
    loss = 0.5 * torch.mean((pred - batch["b"]) ** 2)
    return loss, {"xent": loss}


@dataclasses.dataclass(frozen=True)
class CaseReport:
    algo: str
    topology: str
    wire: Optional[str]
    drop: float
    kernel_calls: int           # calls of DECODE_KERNELS in the step
    expected_kernels: int
    permute_dtypes: Tuple[str, ...]     # what the step handed its transport
    violations: Tuple[str, ...]
    host_reads: int = 0         # host reads of tensors on the step's device
    launches: int = 0           # launches of DECODE_KERNELS (the card only)

    @property
    def ok(self) -> bool:
        return not self.violations

    def describe(self) -> str:
        return (f"{self.algo}@{self.topology}@{self.wire or 'dense'}"
                f"@drop={self.drop} kernels={self.kernel_calls}"
                f"/{self.expected_kernels} permutes={list(self.permute_dtypes)}")


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def analyze_case(algo: str, topology: str, wire_spec: Optional[str],
                 drop: float = 0.0, *, n: int = 8, device="cuda",
                 testbed: Optional[Tuple[Callable, Any, Dict[str, torch.Tensor]]] = None,
                 opt=None, lr_schedule: Optional[Callable[[int], float]] = None
                 ) -> CaseReport:
    """Build one (algo, topology, wire, drop) step on ``device``, run it
    once and check every invariant.  ``testbed`` is ``(loss_fn, params of
    one node, batch of n nodes)`` on ``device`` (default: the JAX package's
    toy testbed), ``opt`` and ``lr_schedule`` default to SGD at 0.05."""
    dev = torch.device(device)
    sched = make_gossip_plan(topology, n)
    wire = make_wire_format(wire_spec) if wire_spec else None
    loss_fn, params, batch = testbed if testbed is not None else (
        _toy_loss, _toy_params(dev), _toy_batch(n, device=dev))
    opt = sgd() if opt is None else opt
    step = make_dist_train_step(loss_fn, algo, opt, wire, sched,
                                lr_schedule or constant(0.05), drop=drop or None)
    state = init_dist_state(algo, params, sched, opt, drop=drop or None, wire=wire)
    del params
    expected = expected_kernel_calls(algo, sched, wire, state.params, state.step)

    step.transport.stats.reset()
    calls0, launches0 = quant.call_counts(), quant.launch_counts()
    watch = StepWatch(dev)
    with watch:
        state, _ = step(state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    calls = _delta(quant.call_counts(), calls0)
    launched = _delta(quant.launch_counts(), launches0)

    violations: List[str] = []
    kernel_calls = decode_calls(calls)
    if kernel_calls != expected:
        violations.append(
            f"decode-kernel calls {kernel_calls} != expected {expected} (= decode "
            "sites x kernels/site; replica share is sched.replica_payloads)")
    if dev.type == "cuda":
        violations += [f"{k}: {calls[k]} calls but {launched[k]} launches — a wrapper "
                       "ran its plain version on the card's step"
                       for k in calls if calls[k] != launched[k]]
    violations += check_no_f64(watch)
    if dev.type != "cpu" and watch.host_reads:
        violations.append(f"{len(watch.host_reads)} host reads of {dev.type} tensors "
                          f"inside the step: {sorted(set(watch.host_reads))}")

    handed = step.transport.stats.shapes
    permute_dtypes = tuple(sorted({short_dtype(d) for pairs in handed.values()
                                   for d, _ in pairs}))
    if wire is not None and not isinstance(wire, IdentityWire):
        on_wire = sorted((short_dtype(d), s) for d, s in handed.get("wire", ()))
        violations += check_permute_payload_whitelist(on_wire, wire, state.params)
    elif not any(handed.values()):
        violations.append("no collective-permute found: the step handed its transport "
                          "nothing")
    return CaseReport(algo, topology, wire_spec, drop, kernel_calls, expected,
                      permute_dtypes, tuple(violations), len(watch.host_reads),
                      decode_calls(launched))


# The JAX package's representative grid, in its order: the acceptance set
# {ring, torus, full_logn} x {quant:4, sign, adaptive}, then s8 codes at
# quant:8, packed u32 at 3 bits and sparse, chain/torus2d plans, the
# error-feedback families, a drop-rate case, and the dense dpsgd baseline.
DEFAULT_GRID: Tuple[Tuple[str, str, Optional[str], float], ...] = tuple(
    [("dcd", topo, w, 0.0)
     for topo in ("ring", "torus", "full_logn")
     for w in ("quant:4", "sign", _ADAPTIVE_SPEC)]
    + [
        ("dcd", "ring", "quant:8", 0.0),
        ("dcd", "ring", "quant:3", 0.0),
        ("dcd", "chain", "quant:4", 0.0),
        ("dcd", "torus2d", "sparse:0.25", 0.0),
        ("ecd", "torus", "quant:4", 0.0),
        ("choco", "ring", "sign", 0.0),
        ("deepsqueeze", "ring", "sign", 0.0),
        ("dcd", "ring", "lowrank:2", 0.0),
        ("dcd", "ring", "quant:4", 0.2),
        ("dpsgd", "ring", None, 0.0),
    ])


def run_sweep(grid: Optional[Sequence] = None, *, n: int = 8,
              device="cuda") -> List[CaseReport]:
    """Analyze every grid case on ``device``, one step each."""
    return [analyze_case(algo, topo, w, drop, n=n, device=device)
            for algo, topo, w, drop in (grid or DEFAULT_GRID)]


# ---------------------------------------------------------------------------
# the dryrun's summary record
# ---------------------------------------------------------------------------


def analysis_record(codec, params, payloads: int) -> Dict[str, Any]:
    """The containers one round hands to the transport for ``params``
    (encoded on meta): their dtypes, one permute a leaf and payload, and how
    many the rank exchange's whitelist would refuse (a dense param-shaped
    float tensor)."""
    if codec is None:
        return {"collective_permutes": 0, "permute_dtypes": [], "f64_free": True}
    items = leaf_items(params)
    wires = [codec.route(p, l.shape) for p, l in items]
    leaves = [l for _, l in items]
    refused = wire_refused_shapes(leaves, wires)
    dtypes, bad = set(), 0
    for leaf, w in zip(leaves, wires):
        payload = w.encode(torch.empty(leaf.shape, dtype=torch.float32, device="meta"), 0)
        for t in payload.values():
            dtypes.add(str(t.dtype).removeprefix("torch."))
            bad += int(t.dtype.is_floating_point and tuple(t.shape) in refused)
    return {"collective_permutes": payloads * len(items), "permute_dtypes": sorted(dtypes),
            "f64_free": "float64" not in dtypes, "permute_whitelist_violations": bad}
