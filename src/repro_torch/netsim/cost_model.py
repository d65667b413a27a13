"""Analytic network cost model: per-iteration communication time vs
(bandwidth, latency) for each synchronization strategy (paper Figs. 2-3).

The port's own copy of the JAX package's ``netsim/cost_model.py`` (numpy
only, the same calls with the same arguments, so every figure equals JAX's);
``failure_trace`` replays the port's ``edge_drop_mask``, which is bit-equal
to JAX's.

The paper measures wall-clock epoch time on 8 EC2 GPUs while throttling the NIC
with ``tc``.  We have no real network, so we model the communication phase the
way the paper's systems discussion does:

* AllReduce (ring, full precision): 2(n-1)/n * M bytes through each NIC per
  iteration, 2(n-1) latency-bound sequential steps.
* Decentralized gossip: one payload exchange per **plan shift** — the
  :class:`~repro_torch.distributed.gossip.GossipPlan`'s ``degree`` is the number of
  node-axis collective-permutes per step, so bytes = degree * M * (wire/32)
  and latency = degree rounds.  The default (no plan) is the paper's ring:
  degree 2, bytes = 2 * M * (wire_bits/32) — bit-identical to the historical
  hardcoded-ring figures.  A torus plan charges 4 rounds/payloads.
* Compressed decentralized (DCD/ECD): same round structure, payload shrunk by
  the wire ratio — which is taken from the *real* payload containers, not a
  formula: int8 codes + per-block scales ~ 8.03/32 at 8 bits, bit-packed uint32
  words ~ 4.03/32 at 4 bits, and fp32/fp16 values + bit-packed indices for the
  sparsifiers (see ``strategies_for``, which asks the compressor — or the wire
  format directly — for its measured wire bits/element).  Every wire format
  measures its figure from payload nbytes — there is no modeled figure left.

comm_time = latency * rounds + bytes / bandwidth ;  iter_time = compute + comm.

That point estimate models the *reliable, uniform* fabric of a datacenter —
every permute arrives, every link is the same.  Real slow networks are
neither, so the model also carries per-edge **link models**
(:class:`LinkModel`): a lognormal straggler tail on each in-flight edge's
transfer time (a synchronous gossip round finishes when its SLOWEST edge
does — ``sample_comm_times`` takes the max over in-flight edges per round,
so the expected round time grows with both the tail parameter and the edge
count), and a per-edge drop probability.  Dropped payloads shrink the
*expected* traffic (``strategies_for(..., drop_rate=r)`` charges the
decentralized strategies ``degree * (1 - r)`` expected payloads; the
synchronous round barrier — and hence the latency charge — remains), and
:func:`failure_trace` replays the exact PCG drop masks the runtime and the
stacked reference consume, so the simulator's failure trace is the same
trace, not a statistical cousin.  With ``straggler=0`` and ``drop_rate=0``
every figure is bit-identical to the point model above.

These figures are no longer reporting-only: :mod:`repro_torch.netsim.controller`
closes the loop, scoring ``(topology, wire)`` candidates with exactly the
:func:`strategies_for`/:func:`comm_time`/:func:`comm_time_tail` accounting
below (or with measured dryrun JSONL records) and emitting the per-phase
``{topology, wire}`` plan that ``launch/train.py --phase-plan`` executes —
the model both prices a run after the fact and picks the next one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetworkCondition:
    bandwidth_bps: float      # per-link bandwidth, bits/s
    latency_s: float          # one-way link latency, seconds

    def describe(self) -> str:
        gbps = self.bandwidth_bps / 1e9
        return f"{gbps:g}Gbps/{self.latency_s*1e3:g}ms"


@dataclasses.dataclass(frozen=True)
class CommStrategy:
    name: str
    bytes_per_iter: float     # through each node's NIC
    latency_rounds: int       # sequential latency-bound rounds


def strategies(model_bytes: float, n: int,
               wire_bits: float = 8.03, degree: int = 2,
               lp_degree: Optional[int] = None) -> Dict[str, CommStrategy]:
    """``degree``: gossip payload rounds per iteration — the plan's number of
    node-axis shifts (ring 2, circulant torus 4).  Both the bytes through each
    NIC and the latency-bound rounds scale with it; the AllReduce baselines
    are degree-independent.  ``lp_degree`` (default: ``degree``) charges the
    compressed decentralized strategy separately: the replica-tracking
    DCD/ECD runtime rolls every encoded delta once per aux tree, which equals
    the graph degree for flat plans but not for multi-round schedules (see
    ``GossipSchedule.replica_payloads``)."""
    M = model_bytes
    lp = degree if lp_degree is None else lp_degree
    return {
        "allreduce": CommStrategy("allreduce", 2 * (n - 1) / n * M, 2 * (n - 1)),
        "decentralized_fp": CommStrategy("decentralized_fp", degree * M, degree),
        "decentralized_lp": CommStrategy("decentralized_lp",
                                         lp * M * wire_bits / 32, lp),
        # naive centralized quantized (for completeness; paper omits it)
        "allreduce_lp": CommStrategy("allreduce_lp", 2 * (n - 1) / n * M * wire_bits / 32,
                                     2 * (n - 1)),
    }


def expected_payloads(degree: float, drop_rate: float = 0.0) -> float:
    """Expected delivered payload exchanges per iteration under a per-edge
    drop probability: ``degree * (1 - drop_rate)`` — each of the ``degree``
    payload permutes is delivered independently with probability
    ``1 - drop_rate`` (the drop mask is per directed edge per round)."""
    assert 0.0 <= drop_rate < 1.0, drop_rate
    return degree * (1.0 - drop_rate)


def strategies_for(model_bytes: float, n: int, wire,
                   plan: Optional[object] = None,
                   drop_rate: float = 0.0,
                   algo: Optional[str] = None) -> Dict[str, CommStrategy]:
    """Strategies whose low-precision wire bits come from the actual payload
    containers: ``wire`` is anything with a measured ``wire_bits_per_element``
    — a :class:`~repro_torch.distributed.wire.WireFormat` or a compressor view —
    (bit-stream-packed uint32 words at 2..7 bits, int8 at 8, fp32/fp16 values
    + packed uint index words for the fixed-capacity sparsifiers).  ``plan``
    (a :class:`~repro_torch.distributed.gossip.GossipPlan` or
    :class:`~repro_torch.distributed.gossip.GossipSchedule`) sets the gossip degree:
    latency rounds and payload exchanges both follow ``plan.degree`` (ring=2,
    matching the historical default bit for bit; circulant torus=4).  A
    multi-round schedule splits the charge honestly: ``decentralized_fp``
    (D-PSGD rolls per round-shift) pays ``sum(round.degree)`` per iteration —
    ``full_logn`` pays log2(n) rounds where the dense ``full``/``star`` plans
    pay n-1, the high-latency O(log n)-vs-O(n) win; ``decentralized_lp``
    (replica-tracking DCD/ECD roll every delta once per union-shift aux tree)
    pays ``plan.replica_payloads`` — for compressed gossip the O(log n) win
    lives on the time-varying ``exp`` schedule (log2(n) payloads/step vs
    n-1), while per-step ``full_logn`` trades payload count for the log-sized
    aux memory.

    ``drop_rate`` keeps the figures honest under injected failures: the
    decentralized strategies' *bytes* shrink to the expected delivered
    payload count (:func:`expected_payloads` — ``degree * (1 - drop_rate)``
    expected rounds' worth of traffic), while the latency charge keeps the
    full round count (a synchronous gossip round barrier happens whether or
    not its payload arrives).  The AllReduce baselines model the reliable
    datacenter fabric and never drop.  At ``drop_rate=0`` every figure is
    bit-identical to the seed model.

    ``algo`` refines the ``decentralized_lp`` payload charge per algorithm:
    the replica/estimate trackers (dcd, ecd, choco — every family whose
    receive side rolls one compressed payload per union-shift aux tree)
    pay ``replica_payloads``; the stateless compressed gossips (naive,
    deepsqueeze — one error-compensated model payload per neighbor, no
    receive-side state) pay the per-round ``degree``.  ``algo=None`` keeps
    the historical replica-tracking charge."""
    degree = 2 if plan is None else int(plan.degree)
    if plan is None or algo in ("naive", "deepsqueeze", "dpsgd"):
        lp_degree = degree
    else:
        lp_degree = int(getattr(plan, "replica_payloads", degree))
    out = strategies(model_bytes, n,
                     wire_bits=float(wire.wire_bits_per_element()),
                     degree=degree, lp_degree=lp_degree)
    if drop_rate:
        deliver = expected_payloads(1.0, drop_rate)
        for k in ("decentralized_fp", "decentralized_lp"):
            out[k] = dataclasses.replace(
                out[k], bytes_per_iter=out[k].bytes_per_iter * deliver)
    return out


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-edge link model: a :class:`NetworkCondition` median plus the two
    failure-realism knobs.

    ``straggler``: sigma of the lognormal multiplicative jitter on each
    in-flight edge's per-round transfer time (0 = the deterministic point
    model).  The straggler *tail* bites through the synchronous round
    barrier: a round finishes when its slowest in-flight edge does, and the
    expected max of ``n`` lognormals grows with both sigma and n.
    ``drop_rate``: per-edge per-round drop probability — the same figure the
    runtime's ``DropSpec.rate`` injects; feed it to
    ``strategies_for(..., drop_rate=...)`` for the expected-traffic charge
    and to :func:`failure_trace` for the exact mask replay.
    """

    bandwidth_bps: float
    latency_s: float
    straggler: float = 0.0
    drop_rate: float = 0.0

    @classmethod
    def from_condition(cls, net: NetworkCondition, straggler: float = 0.0,
                       drop_rate: float = 0.0) -> "LinkModel":
        return cls(bandwidth_bps=net.bandwidth_bps, latency_s=net.latency_s,
                   straggler=straggler, drop_rate=drop_rate)

    def condition(self) -> NetworkCondition:
        """The median point — what the deterministic model sees."""
        return NetworkCondition(self.bandwidth_bps, self.latency_s)

    def describe(self) -> str:
        base = self.condition().describe()
        return f"{base}/straggler={self.straggler:g}/drop={self.drop_rate:g}"


def sample_comm_times(s: CommStrategy, link: LinkModel, n_edges: int,
                      n_samples: int = 256, seed: int = 0) -> np.ndarray:
    """Per-iteration communication time as a *distribution sample* (shape
    ``(n_samples,)``) instead of a point.

    Each of the strategy's ``latency_rounds`` sequential rounds moves
    ``bytes_per_iter / latency_rounds`` through every NIC with ``n_edges``
    transfers in flight; the round completes when the slowest finishes:
    ``t_round = max_e (latency + round_bytes*8/bw) * exp(straggler * z_e)``
    with ``z_e ~ N(0,1)`` iid per (sample, round, edge).  Sampling is
    deterministic in ``seed`` (numpy PCG64).  ``straggler=0`` collapses every
    sample to exactly :func:`comm_time` of the median condition."""
    base = link.latency_s + \
        8 * s.bytes_per_iter / s.latency_rounds / link.bandwidth_bps
    if link.straggler == 0.0:
        return np.full(n_samples, base * s.latency_rounds)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n_samples, s.latency_rounds, n_edges))
    return (base * np.exp(link.straggler * z)).max(axis=2).sum(axis=1)


def comm_time_tail(s: CommStrategy, link: LinkModel, n_edges: int,
                   n_samples: int = 256, seed: int = 0) -> Dict[str, float]:
    """Mean / median / p95 of the sampled per-iteration comm time."""
    t = sample_comm_times(s, link, n_edges, n_samples=n_samples, seed=seed)
    return {"mean": float(t.mean()), "p50": float(np.median(t)),
            "p95": float(np.percentile(t, 95))}


def straggler_curve(s: CommStrategy, net: NetworkCondition, compute_s: float,
                    iters_per_epoch: int, n_edges: int,
                    sigmas: Sequence[float] = (0.0, 0.25, 0.5, 1.0),
                    n_samples: int = 256, seed: int = 0
                    ) -> List[Dict[str, float]]:
    """Epoch-time-vs-straggler-tail curve: one row per sigma, each carrying
    the mean and p95 epoch time under that tail (compute is not overlapped,
    as in the paper's runs)."""
    rows = []
    for sigma in sigmas:
        link = LinkModel.from_condition(net, straggler=float(sigma))
        tail = comm_time_tail(s, link, n_edges, n_samples=n_samples, seed=seed)
        rows.append({
            "straggler": float(sigma),
            "epoch_s_mean": iters_per_epoch * (compute_s + tail["mean"]),
            "epoch_s_p95": iters_per_epoch * (compute_s + tail["p95"]),
        })
    return rows


def failure_trace(plan: Any, drop: Any, n_steps: int) -> List[Dict[Tuple[int, int], np.ndarray]]:
    """Replay the exact per-edge delivery masks the runtime and the stacked
    reference consume: ``trace[t][(enc_step, shift)]`` is the (n,) 0/1 mask
    of the directed edges ``i <- i-shift`` in the round with effective
    counter ``enc_step`` executed at training step ``t`` — computed by the
    same :func:`repro_torch.distributed.failures.edge_drop_mask` PCG draw, so the
    simulator, the runtime, and the reference agree on one failure trace."""
    from repro_torch.distributed.failures import edge_drop_mask, make_drop_spec
    from repro_torch.distributed.gossip import as_schedule

    sched = as_schedule(plan)
    spec = make_drop_spec(drop)
    out: List[Dict[Tuple[int, int], np.ndarray]] = []
    for t in range(n_steps):
        if sched.time_varying and sched.period > 1:
            rounds = [(sched.rounds[t % sched.period], t)]
        else:
            rounds = [(r, t * sched.period + i)
                      for i, r in enumerate(sched.rounds)]
        masks: Dict[Tuple[int, int], np.ndarray] = {}
        for rnd, enc in rounds:
            for s in rnd.shift_list:
                masks[(enc, s)] = np.ones(sched.n, np.float32) if spec is None \
                    else edge_drop_mask(sched.n, s, enc, spec).numpy()
        out.append(masks)
    return out


def comm_time(s: CommStrategy, net: NetworkCondition) -> float:
    return s.latency_rounds * net.latency_s + 8 * s.bytes_per_iter / net.bandwidth_bps


def iter_time(s: CommStrategy, net: NetworkCondition, compute_s: float) -> float:
    """Communication is not overlapped with compute in the paper's runs."""
    return compute_s + comm_time(s, net)


def epoch_time(s: CommStrategy, net: NetworkCondition, compute_s: float,
               iters_per_epoch: int) -> float:
    return iters_per_epoch * iter_time(s, net, compute_s)


# Paper's experimental frame: ResNet-20 (~0.27M params, fp32) on CIFAR-10,
# batch 128/node, 8 nodes => 48 iterations/epoch; ~50ms/iter GPU compute (K80).
RESNET20_BYTES = 0.27e6 * 4
PAPER_ITERS_PER_EPOCH = 50000 // (128 * 8)
PAPER_COMPUTE_S = 0.05

BEST_NETWORK = NetworkCondition(bandwidth_bps=1.4e9, latency_s=0.13e-3)
LOW_BW = NetworkCondition(bandwidth_bps=50e6, latency_s=0.13e-3)
HIGH_LAT = NetworkCondition(bandwidth_bps=1.4e9, latency_s=5e-3)
WORST = NetworkCondition(bandwidth_bps=50e6, latency_s=5e-3)
