"""Closed-loop compression control: netsim picks {wire, topology} per phase.

The port's own copy of the JAX package's ``netsim/controller.py``:

* :class:`Phase` / :class:`PhasePlan`: a step-indexed ``{topology, wire}``
  schedule with the same grammar (``"0@exp@sign;400@full_logn@quant:8"``:
  ``;``-joined ``start@topology@wire`` segments, because wire specs already
  use ``:``, ``,`` and ``=``), consumed by ``launch/train.py --phase-plan``;
* :func:`plan_phases`: scores every ``(topology, wire)`` candidate with the
  cost model (:mod:`repro_torch.netsim.cost_model`: measured wire bits of the
  port's wire formats, plan-degree-aware rounds, drop-rate-discounted
  traffic, straggler tails), then picks the fastest candidate for the early
  phase and the highest-fidelity one within ``slack`` of it for the late
  phase;
* :func:`plan_phases_measured`: the same rule over measured JSONL records
  (``step_time_s``, ``comm_tail_s`` or roofline times, with ``topology`` and
  ``wire``).

The plan is declarative: the runtime applies it by rebuilding the step at
each phase boundary and re-keying the gossip aux trees.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.netsim.cost_model import (
    PAPER_COMPUTE_S,
    LinkModel,
    comm_time,
    comm_time_tail,
    strategies_for,
)

# The default candidate grid: every topology the schedule compiler makes
# cheap, crossed with the registry's fidelity ladder (1-bit sign up to
# fp16).  Callers hand plan_phases their own grid to narrow or extend it.
DEFAULT_TOPOLOGIES: Tuple[str, ...] = ("ring", "exp", "full_logn")
DEFAULT_WIRES: Tuple[str, ...] = ("sign", "quant:3", "quant:4", "quant:8", "fp16")


@dataclasses.dataclass(frozen=True)
class Phase:
    """From step ``start`` (inclusive) until the next phase's start, gossip
    on ``topology`` encoding through ``wire``."""

    start: int
    topology: str
    wire: str

    def describe(self) -> str:
        return f"{self.start}@{self.topology}@{self.wire}"


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """Phases sorted by start; the first starts at step 0 and no two share a
    start."""

    phases: Tuple[Phase, ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("a PhasePlan needs at least one phase")
        phases = tuple(sorted(self.phases, key=lambda p: p.start))
        if phases[0].start != 0:
            raise ValueError(f"first phase must start at step 0, got {phases[0].start}")
        starts = [p.start for p in phases]
        if len(set(starts)) != len(starts):
            raise ValueError(f"duplicate phase starts: {starts}")
        object.__setattr__(self, "phases", phases)

    @staticmethod
    def parse(text: str) -> "PhasePlan":
        """``"0@exp@sign;400@full_logn@quant:8"`` -> PhasePlan."""
        phases = []
        for seg in text.split(";"):
            seg = seg.strip()
            if not seg:
                continue
            fields = seg.split("@", 2)
            if len(fields) != 3:
                raise ValueError(f"phase segment {seg!r} is not start@topology@wire")
            start, topo, wire = fields
            phases.append(Phase(int(start), topo, wire))
        return PhasePlan(tuple(phases))

    def describe(self) -> str:
        return ";".join(p.describe() for p in self.phases)

    def phase_at(self, step: int) -> Phase:
        """The phase governing ``step`` (the last one whose start <= step)."""
        cur = self.phases[0]
        for p in self.phases:
            if p.start <= step:
                cur = p
        return cur

    def segments(self, total_steps: int) -> List[Tuple[int, int, Phase]]:
        """``(start, stop, phase)`` triples covering ``[0, total_steps)``."""
        out = []
        for i, p in enumerate(self.phases):
            stop = self.phases[i + 1].start if i + 1 < len(self.phases) else total_steps
            if p.start < total_steps:
                out.append((p.start, min(stop, total_steps), p))
        return out

    def records(self) -> List[Dict[str, Any]]:
        """JSON-ready rows, one a phase."""
        return [dataclasses.asdict(p) for p in self.phases]


# ------------------------------------------------------------ candidate cost

def candidate_iter_time(model_bytes: float, n: int, wire: Any, topology: str,
                        link: LinkModel, *, algo: str = "choco",
                        compute_s: float = PAPER_COMPUTE_S) -> float:
    """Modeled seconds/iteration of one ``(topology, wire)`` candidate on
    ``link`` — the SAME accounting the reporting surfaces print: measured
    wire bits from the real payload containers, plan-degree-aware rounds and
    replica-payload charges per algorithm family, expected-traffic discount
    at the link's drop rate, and the lognormal straggler tail (the expected
    max over in-flight edges) when the link has one."""
    from repro_torch.distributed.gossip import make_gossip_plan
    from repro_torch.distributed.wire import make_wire_format

    plan = make_gossip_plan(topology, n)
    w = make_wire_format(wire)
    strat = strategies_for(model_bytes, n, w, plan=plan,
                           drop_rate=link.drop_rate,
                           algo=algo)["decentralized_lp"]
    if link.straggler > 0.0:
        comm = comm_time_tail(strat, link,
                              n_edges=max(1, int(plan.degree)))["mean"]
    else:
        comm = comm_time(strat, link.condition())
    return compute_s + comm


def candidate_fidelity(wire: Any) -> float:
    """Fidelity rank of a wire spec: its measured bulk bits/element (higher
    = closer to full precision; ``identity`` measures 32)."""
    from repro_torch.distributed.wire import make_wire_format

    return float(make_wire_format(wire).wire_bits_per_element())


# ------------------------------------------------------- modeled controller

def plan_phases(model_bytes: float, n: int, link: LinkModel, *,
                total_steps: int, algo: str = "choco",
                topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
                wires: Sequence[str] = DEFAULT_WIRES,
                early_frac: float = 0.5, slack: float = 1.5,
                compute_s: float = PAPER_COMPUTE_S) -> PhasePlan:
    """Pick ``{topology, wire}`` per training phase from the cost model.

    Decision rule (two phases — the DECo-SGD shape without its staleness
    axis):

    * **Early** (steps ``[0, early_frac * total_steps)``): the candidate with
      the minimum modeled iteration time — early training tolerates
      aggressive compression, so pure speed wins (ties break toward higher
      fidelity, then denser topology).
    * **Late** (the rest): the highest-fidelity candidate whose iteration
      time is within ``slack ×`` the fastest — spend the slack budget on
      bits and mixing density to push down the consensus error floor.

    Degenerates gracefully: if the fastest candidate is also the most
    faithful affordable one, the two phases merge into a single segment.
    """
    assert total_steps > 0 and 0.0 < early_frac <= 1.0 and slack >= 1.0
    scored = []
    for topo in topologies:
        for wire in wires:
            t = candidate_iter_time(model_bytes, n, wire, topo, link,
                                    algo=algo, compute_s=compute_s)
            scored.append((t, candidate_fidelity(wire), topo, wire))
    # fastest first; ties prefer more bits, then the later (denser) topology
    scored.sort(key=lambda r: (r[0], -r[1]))
    t_best = scored[0][0]
    early = scored[0]
    affordable = [r for r in scored if r[0] <= slack * t_best]
    late = max(affordable, key=lambda r: (r[1], -r[0]))
    switch = int(early_frac * total_steps)
    if (late[2], late[3]) == (early[2], early[3]) or switch >= total_steps \
            or switch == 0:
        return PhasePlan((Phase(0, late[2], late[3]),))
    return PhasePlan((Phase(0, early[2], early[3]),
                      Phase(switch, late[2], late[3])))


# ------------------------------------------------------ measured controller

def load_dryrun_records(path: str) -> List[Dict[str, Any]]:
    """Parse a ``launch/dryrun.py --json`` JSONL file into records."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def record_iter_time(rec: Dict[str, Any],
                     compute_s: float = PAPER_COMPUTE_S) -> Optional[float]:
    """Measured (or roofline-derived) seconds/iteration of one dryrun record.

    Preference order: an explicit ``step_time_s`` (real executions), then the
    straggler-aware ``comm_tail_s`` + compute, then the roofline component
    sum (``t_compute_s + t_memory_s + t_collective_s``).  Returns None when
    the record carries no usable time (e.g. serve records)."""
    if rec.get("step_time_s") is not None:
        return float(rec["step_time_s"])
    tail = rec.get("comm_tail_s")
    if tail is not None:   # comm_time_tail dict ({mean,p50,p95}) or a scalar
        return compute_s + (float(tail["mean"]) if isinstance(tail, dict)
                            else float(tail))
    parts = [rec.get(k) for k in ("t_compute_s", "t_memory_s",
                                  "t_collective_s")]
    if any(p is not None for p in parts):
        return float(sum(p or 0.0 for p in parts))
    return None


def plan_phases_measured(records: Sequence[Dict[str, Any]], *,
                         total_steps: int, early_frac: float = 0.5,
                         slack: float = 1.5,
                         compute_s: float = PAPER_COMPUTE_S) -> PhasePlan:
    """The :func:`plan_phases` decision rule over measured dryrun records.

    Each record must carry ``topology`` + ``wire`` (every train dryrun
    record does) and a usable time (:func:`record_iter_time`); fidelity
    comes from the record's measured ``wire_bits_per_element`` when present.
    The controller thereby closes the loop on the SAME JSONL audit trail
    dryrun writes — model once, measure, re-plan."""
    assert total_steps > 0 and 0.0 < early_frac <= 1.0 and slack >= 1.0
    scored = []
    for rec in records:
        t = record_iter_time(rec, compute_s=compute_s)
        if t is None or "topology" not in rec or "wire" not in rec:
            continue
        fid = rec.get("wire_bits_per_element")
        fid = float(fid) if fid is not None else candidate_fidelity(rec["wire"])
        scored.append((t, fid, rec["topology"], rec["wire"]))
    if not scored:
        raise ValueError("no dryrun record carries topology/wire and a "
                         "usable iteration time")
    scored.sort(key=lambda r: (r[0], -r[1]))
    t_best = scored[0][0]
    early = scored[0]
    affordable = [r for r in scored if r[0] <= slack * t_best]
    late = max(affordable, key=lambda r: (r[1], -r[0]))
    switch = int(early_frac * total_steps)
    if (late[2], late[3]) == (early[2], early[3]) or switch >= total_steps \
            or switch == 0:
        return PhasePlan((Phase(0, late[2], late[3]),))
    return PhasePlan((Phase(0, early[2], early[3]),
                      Phase(switch, late[2], late[3])))
