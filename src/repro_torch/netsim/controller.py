"""Phase plans: a step-indexed ``{topology, wire}`` schedule.

The port's copy of :class:`Phase` and :class:`PhasePlan` from the JAX
package's ``netsim/controller.py``, with the same grammar
(``"0@exp@sign;400@full_logn@quant:8"``: ``;``-joined
``start@topology@wire`` segments, because wire specs already use ``:``,
``,`` and ``=``).  ``launch/train.py --phase-plan`` consumes it; the
controller that chooses a plan from the network cost model
(``plan_phases``) is not part of the port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple


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
