"""Compression sweep: how aggressive can DCD vs ECD go? (paper §5.4 / Fig. 4)

The port of the JAX package's ``examples/compare_compression.py``, with all
of its modes and flags.  Sweeps wire-format specs (quantization bits {8, 4,
3, 2} and the sparse value+index codec, random-k and top-k) on rings of 8
and 16 nodes and reports the distance to the global optimum next to the
theoretical DCD budget ``alpha < (1-rho)/(2 mu)``.  Every row is one
``make_wire_format`` spec; the stacked operator is its ``compressor_for``
view, and every wire figure is measured from the payload's containers.

``--topology`` runs the sweep on any ``make_gossip_plan`` spec; for a round
schedule the stacked reference runs its effective dense W, and the header
prints the netsim high-latency comparison against the dense plan.

``--drop-rate R`` runs the failure sweep: every algorithm through the
stacked :class:`~repro_torch.core.algorithms.GossipReference` under the
runtime's deterministic per-edge drop masks, at rates {0, R, min(2.5R,
0.75)} (with ``--straggler``, also the epoch-time-vs-straggler-tail curve).

``--error-feedback`` (or ``--algo``/``--wire``) runs {dcd, ecd, choco,
deepsqueeze} at biased ~1-bit specs (``sign``, ``sparse:0.05:topk``)
against the D-PSGD fp32 plateau; a row that ends above the loss at init is
marked DIVERGED.

``--pareto`` runs the adaptive-wire pareto sweep and exits nonzero when no
``adaptive:`` spec strictly dominates a uniform one (fewer measured bytes at
equal or lower excess loss).  ``--lowrank`` runs DCD with ``lowrank:<r>``
wires on a matrix leaf and exits nonzero when a measured bits/element
misses the ``32 r (m+n)/(m n)`` budget.

The problems come from ``torch.Generator``s seeded as the JAX package seeds
its keys, so the tables differ from the JAX package's by their draws.
Everything runs on ``--device`` (the GPU unless ``--device cpu``).

    python -m repro_torch.examples.compare_compression [--quick] [--device cpu]
    python -m repro_torch.examples.compare_compression --quick --pareto
    python -m repro_torch.examples.compare_compression --quick --lowrank
    python -m repro_torch.examples.compare_compression --topology full_logn
    python -m repro_torch.examples.compare_compression --drop-rate 0.2 --quick
    python -m repro_torch.examples.compare_compression --error-feedback
    python -m repro_torch.examples.compare_compression --quick --algo choco --wire sign
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import compressor_for, spectral_info
from repro_torch.core.algorithms import Algorithm, GossipReference, average_model
from repro_torch.core.compression import measured_alpha
from repro_torch.core.testbed import make_problem, run
from repro_torch.distributed.gossip import (
    GOSSIP_TOPOLOGIES,
    GossipPlan,
    GossipSchedule,
    make_gossip_plan,
)
from repro_torch.distributed.wire import make_wire_format
from repro_torch.netsim import BEST_NETWORK, HIGH_LAT, comm_time, straggler_curve, strategies_for

# fixed-capacity sparsifiers: random-k's error scales with ||z|| itself
# (alpha = sqrt(1/p - 1) > 1 for p < 0.5), so DCD diverges at p=0.25, the
# failure the paper's alpha condition is about; top-k keeps alpha < 1
SPECS = [
    ("8b", "quant:8:32"),
    ("4b", "quant:4:32"),
    ("3b", "quant:3:32"),
    ("2b", "quant:2:32"),
    ("rk.5", "sparse:0.5"),
    ("rk.25", "sparse:0.25"),
    ("top.25", "sparse:0.25:topk"),
]

# the failure sweep's contenders: DCD's, ECD's and CHOCO's replicas go stale
# on dropped edges; D-PSGD and DeepSqueeze keep no cross-node state
DROP_CONFIGS = [
    ("dcd 4b", "dcd", "quant:4:32"),
    ("ecd 4b", "ecd", "quant:4:32"),
    ("naive 4b", "naive", "quant:4:32"),
    ("choco 1b", "choco", "sign"),
    ("dsq 1b", "deepsqueeze", "sign"),
    ("dpsgd fp", "dpsgd", None),
]

# biased ~1-bit compression that plain difference compression cannot take
EF_SPECS = [
    ("sign", "sign"),
    ("top.05", "sparse:0.05:topk"),
]
EF_ALGOS = ("dcd", "ecd", "choco", "deepsqueeze")

# uniform specs at descending fidelity, and the adaptive combinators that
# send the small stiff leaf at fp16 and the large soft one at low bits
PARETO_SPECS = [
    ("fp16", "fp16"),
    ("q8", "quant:8:32"),
    ("q4", "quant:4:32"),
    ("q3", "quant:3:32"),
    ("ad4", "adaptive:128:small=fp16:large=quant:4:32"),
    ("ad3", "adaptive:128:small=fp16:large=quant:3:32"),
]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def drop_sweep(args, T: int) -> list:
    """Convergence-vs-drop-rate table on the stacked reference, under the
    runtime's per-edge masks and renormalized mixing rows.  Returns
    ``(n, tag, rate, final_dist_opt)`` rows."""
    r = args.drop_rate
    rates = sorted({0.0, r, min(2.5 * r, 0.75)})
    out = []
    for n in (8,) if args.quick else (8, 16):
        plan = make_gossip_plan(args.topology, n)
        problem = make_problem(_gen(1), n=n, m=256, d=32, hetero=0.2, noise=0.1,
                               device=args.device)
        print(f"\n{args.topology} n={n}: final dist-to-opt vs drop rate "
              f"(deterministic per-edge masks, salt={args.drop_salt})")
        print(f"{'config':>9} " + " ".join(f"{f'drop={x:g}':>12}" for x in rates))
        for tag, name, spec in DROP_CONFIGS:
            wire = make_wire_format(spec) if spec else None
            row = []
            for rate in rates:
                drop = f"{rate}:{args.drop_salt}" if rate else None
                ref = GossipReference(name=name, plan=plan, wire=wire, drop=drop,
                                      gamma=args.gamma)
                row.append(run(problem, ref, T=T, lr=0.01, eval_every=T)["final_dist_opt"])
                out.append((n, tag, rate, row[-1]))
            print(f"{tag:>9} " + " ".join(f"{v:>12.3e}" for v in row))
    if args.straggler > 0.0:
        n = 8
        plan = make_gossip_plan(args.topology, n)
        strat = strategies_for(4096 * 4.0, n, make_wire_format("quant:4:32"), plan=plan,
                               drop_rate=r)["decentralized_lp"]
        print(f"\nepoch-time-vs-straggler-tail, {args.topology} n={n}, 4-bit wire, "
              f"drop={r:g}:")
        for row in straggler_curve(strat, BEST_NETWORK, compute_s=1e-3, iters_per_epoch=100,
                                   n_edges=plan.degree,
                                   sigmas=(0.0, args.straggler / 2, args.straggler,
                                           2 * args.straggler)):
            print(f"  sigma={row['straggler']:<5g} epoch mean={row['epoch_s_mean']:.3f}s "
                  f"p95={row['epoch_s_p95']:.3f}s")
    return out


def error_feedback_sweep(args, T: int) -> list:
    """{dcd, ecd, choco, deepsqueeze} x biased ~1-bit wire specs against the
    D-PSGD fp32 plateau; ``--algo``/``--wire`` restrict the grid to one row
    or column.  Returns ``(n, algo, tag, final_loss)`` rows."""
    algos = [args.algo] if args.algo else list(EF_ALGOS)
    specs = [(args.wire, args.wire)] if args.wire else list(EF_SPECS)
    z = torch.randn((4096,), generator=_gen(0))
    out = []
    for n in (8,) if args.quick else (8, 16):
        plan = make_gossip_plan(args.topology, n)
        W = np.asarray(plan.mixing_matrix())
        problem = make_problem(_gen(1), n=n, m=256, d=32, hetero=0.2, noise=0.1,
                               device=args.device)
        seed_loss = float(problem.global_loss(torch.zeros((problem.dim,),
                                                          device=problem.A.device)))
        base = run(problem, Algorithm(name="dpsgd", W=W), T=T, lr=0.01, eval_every=T)
        sweep = [(tag, compressor_for(make_wire_format(spec))) for tag, spec in specs]
        print(f"\n{args.topology} n={n}: error-feedback sweep, final global loss "
              f"(T={T}, lr=0.01, choco gamma={args.gamma:g})")
        print(f"  loss at init: {seed_loss:.3e}   D-PSGD fp32 plateau: "
              f"{base['final_loss']:.3e}")
        print(f"{'algo':>12} " + " ".join(
            f"{f'{tag}({comp.wire_bits_per_element((z.numel(),)):.2f}b)':>16}"
            for tag, comp in sweep))
        for name in algos:
            row = []
            for tag, comp in sweep:
                kw = {"gamma": args.gamma} if name == "choco" else {}
                loss = run(problem, Algorithm(name=name, W=W, compressor=comp, **kw), T=T,
                           lr=0.01, eval_every=T)["final_loss"]
                mark = " DIVERGED" if not np.isfinite(loss) or loss > seed_loss else ""
                row.append(f"{loss:>7.3e}{mark:>9}")
                out.append((n, name, tag, loss))
            print(f"{name:>12} " + " ".join(f"{c:>16}" for c in row))
    return out


def pareto_sweep(args=None, *, seed: int = 0, topology: str = "ring", verbose: bool = True,
                 device="cuda"):
    """The adaptive-wire headline: a loss-vs-bytes pareto frontier where a
    per-leaf ``adaptive:`` spec strictly dominates a uniform spec.

    A small stiff leaf (32 coords, design columns scaled 3.0, gradient
    noise sigma 1.0) sits next to a large soft one (1024 coords, scaled
    0.3, sigma 0.1).  DCD quantizes gossip differences, whose size at
    stationarity follows each leaf's gradient noise, so a uniform 4-bit wire
    pays its quantization penalty on the small leaf, the one that costs
    almost nothing at fp16.  The metric is the excess global loss over the
    pooled least-squares optimum, averaged over the last 75 of 150 steps;
    bytes are the measured ``wire_nbytes`` of the encoded payload per step
    and node.  Runs the stacked :class:`GossipReference`.

    ``pareto_sweep(seed=s, verbose=False)`` re-derives the problem and the
    gradient-noise stream from ``seed`` and returns the ``(adaptive_tag,
    beaten_tags)`` dominance pairs, raising :class:`SystemExit` when there
    are none, the gate of ``--pareto`` at seed 0."""
    if args is not None:
        topology, device = args.topology, args.device

    T, W_EVAL = 150, 75
    n, m, d_b, d_w = 8, 128, 32, 1024
    lr, sigma_b, sigma_w = 0.2, 1.0, 0.1
    g = _gen(seed)
    Ab = 3.0 * torch.randn((n, m, d_b), generator=g) / np.sqrt(m)
    Aw = 0.3 * torch.randn((n, m, d_w), generator=g) / np.sqrt(m)
    x_b = torch.randn((d_b,), generator=g)
    x_w = torch.randn((d_w,), generator=g)
    het = 0.5 * torch.randn((n, m), generator=g)
    y = torch.einsum("nmd,d->nm", Ab, x_b) + torch.einsum("nmd,d->nm", Aw, x_w) + het

    # the pooled least-squares optimum over all n*m rows
    Xd = np.concatenate([np.concatenate([Ab[i].numpy(), Aw[i].numpy()], axis=1)
                         for i in range(n)])
    sol, *_ = np.linalg.lstsq(Xd, y.numpy().reshape(-1), rcond=None)
    opt = {"bias": torch.from_numpy(sol[:d_b].astype(np.float32)).to(device),
           "weight": torch.from_numpy(sol[d_b:].astype(np.float32)).to(device)}
    Ab, Aw, y = Ab.to(device), Aw.to(device), y.to(device)

    def grads(X, noise: torch.Generator):
        """Every node's gradient of ``0.5 mean((Ab pb + Aw pw - y)^2)``
        plus its gradient noise (drawn on the CPU, then moved)."""
        r = torch.einsum("nmd,nd->nm", Ab, X["bias"]) \
            + torch.einsum("nmd,nd->nm", Aw, X["weight"]) - y
        gb = torch.einsum("nm,nmd->nd", r, Ab) / m
        gw = torch.einsum("nm,nmd->nd", r, Aw) / m
        nb = torch.randn(gb.shape, generator=noise).to(device)
        nw = torch.randn(gw.shape, generator=noise).to(device)
        return {"bias": gb + sigma_b * nb, "weight": gw + sigma_w * nw}

    def global_loss(pm) -> float:
        pred = torch.einsum("nmd,d->nm", Ab, pm["bias"]) \
            + torch.einsum("nmd,d->nm", Aw, pm["weight"])
        return float(0.5 * torch.mean((pred - y) ** 2))

    L_opt = global_loss(opt)
    plan = make_gossip_plan(topology, n)
    p0 = {"bias": torch.zeros((d_b,), device=device), "weight": torch.zeros((d_w,),
                                                                             device=device)}
    rows = []
    for tag, spec in PARETO_SPECS:
        wire = make_wire_format(spec)
        ref = GossipReference(name="dcd", plan=plan, wire=wire)
        state, step = ref.init(p0), ref.step_fn()
        noise = _gen(777 + seed)        # the same noise stream for every spec
        excess = []
        for t in range(T):
            state = step(state, grads(state.params, noise), t, lr)
            if t >= T - W_EVAL:
                excess.append(global_loss(average_model(state.params)) - L_opt)
        nbytes = wire.wire_nbytes(state.params) / n * plan.replica_payloads
        rows.append({"tag": tag, "spec": spec, "bytes": nbytes, "loss": float(np.mean(excess)),
                     "adaptive": spec.startswith("adaptive:")})

    # pareto front: no other config with <= bytes and <= loss (one strict)
    def dominated(a, b):
        return (b["bytes"] <= a["bytes"] and b["loss"] <= a["loss"]
                and (b["bytes"] < a["bytes"] or b["loss"] < a["loss"]))

    dom_pairs = []
    if verbose:
        print(f"\npareto frontier, dcd on {topology} n={n} (T={T}, lr={lr:g}, seed={seed}, "
              f"excess loss over pooled optimum, mean of last {W_EVAL} steps):")
        print(f"{'config':>6} {'bytes/step/node':>16} {'excess loss':>12} {'front':>6}  notes")
    for r in sorted(rows, key=lambda r: r["bytes"]):
        front = not any(dominated(r, o) for o in rows if o is not r)
        notes = ""
        if r["adaptive"]:
            beats = [o["tag"] for o in rows if not o["adaptive"]
                     and r["bytes"] < o["bytes"] and r["loss"] <= o["loss"]]
            if beats:
                notes = "DOMINATES " + ",".join(beats)
                dom_pairs.append((r["tag"], beats))
        if verbose:
            print(f"{r['tag']:>6} {r['bytes']:>16.0f} {r['loss']:>12.4e} "
                  f"{'*' if front else '':>6}  {notes}")
    if not dom_pairs:
        raise SystemExit(f"pareto regression (seed={seed}): no adaptive config strictly "
                         "dominates a uniform spec (fewer bytes at equal-or-better loss)")
    if verbose:
        print("adaptive wins: " + "; ".join(f"{a} beats {','.join(bs)}" for a, bs in dom_pairs))
    return dom_pairs


def lowrank_sweep(args, T: int) -> list:
    """DCD with ``lowrank:<r>`` wires on a problem whose parameter is a
    matrix leaf, each node pulled by a fixed zero-mean heterogeneous
    gradient: the steady-state consensus distance shows how well the rank-r
    factors track the differences between nodes.  Prints it next to the
    measured bits/element and the ``32 r (m+n) / (m n)`` budget, and raises
    :class:`SystemExit` when a measured lowrank figure misses its budget.
    Returns ``(spec, measured, consensus)`` rows."""
    device = args.device
    n, mr, nc = 8, 64, 128
    plan = make_gossip_plan(args.topology, n)
    g = _gen(3)
    Gp = torch.randn((n, mr, nc), generator=g)
    Gb = torch.randn((n, mr), generator=g)
    grads = {"proj": (Gp - Gp.mean(dim=0, keepdim=True)).to(device),
             "bias": (Gb - Gb.mean(dim=0, keepdim=True)).to(device)}
    p0 = {"proj": torch.zeros((mr, nc), device=device), "bias": torch.zeros((mr,),
                                                                             device=device)}
    print(f"\nlow-rank wire, dcd on {args.topology} n={n}, proj leaf ({mr}, {nc}), "
          f"zero-mean heterogeneous pull (T={T}):")
    print(f"{'config':>14} {'meas b/elem':>12} {'budget':>8} {'consensus dist':>15}")
    bad, out = [], []
    for spec in ("fp16", "lowrank:2", "lowrank:2:warm", "lowrank:4:warm"):
        wire = make_wire_format(spec)
        ref = GossipReference(name="dcd", plan=plan, wire=wire)
        state, step = ref.init(p0), ref.step_fn()
        for t in range(T):
            state = step(state, grads, t, 0.05)
        X = state.params["proj"]
        dist = float(torch.mean((X - X.mean(dim=0, keepdim=True)) ** 2))
        meas = wire.wire_bits_per_element((1, mr, nc))
        if spec.startswith("lowrank"):
            r = int(spec.split(":")[1])
            budget = 32.0 * r * (mr + nc) / (mr * nc)
            if abs(meas - budget) > 1e-6:
                bad.append((spec, meas, budget))
            btxt = f"{budget:8.3f}"
        else:
            btxt = f"{'--':>8}"
        print(f"{spec:>14} {meas:>12.3f} {btxt} {dist:>15.3e}")
        out.append((spec, meas, dist))
    if bad:
        raise SystemExit("lowrank wire-honesty regression: measured bits/element off "
                         "budget: " + "; ".join(f"{s} measured {m:.3f} != {b:.3f}"
                                                for s, m, b in bad))
    return out


def bits_sweep(args, T: int) -> list:
    """The Fig. 4 table: DCD and ECD at every spec of :data:`SPECS`.
    Returns ``(n, tag, dcd_dist, ecd_dist)`` rows."""
    z = torch.randn((4096,), generator=_gen(0))
    sweep = [(tag, compressor_for(make_wire_format(spec))) for tag, spec in SPECS]
    out = []
    for n in (8,) if args.quick else (8, 16):
        gossip = make_gossip_plan(args.topology, n)
        W = np.asarray(gossip.mixing_matrix())
        info = spectral_info(W)
        print(f"\n{args.topology} n={n}:  spectral gap={info.spectral_gap:.3f}  "
              f"DCD alpha budget={info.dcd_alpha_max():.3f}")
        if isinstance(gossip, GossipSchedule):
            # same effective W in O(log n) permute rounds an iteration
            # instead of the dense plan's O(n), as netsim comm time at the
            # high-latency point: D-PSGD pays the graph degree, DCD/ECD one
            # payload roll per aux tree (plan.replica_payloads)
            dense = GossipPlan.from_mixing_matrix(W, max_shifts=n)
            wire4 = make_wire_format("quant:4:1024")
            M = z.numel() * 4.0
            s_s = strategies_for(M, n, wire4, plan=gossip)
            s_d = strategies_for(M, n, wire4, plan=dense)
            for strat, label in (("decentralized_fp", "D-PSGD fp32"),
                                 ("decentralized_lp", "DCD/ECD 4-bit")):
                t_s, t_d = comm_time(s_s[strat], HIGH_LAT), comm_time(s_d[strat], HIGH_LAT)
                print(f"  {gossip.name} vs dense, {label}: {s_s[strat].latency_rounds} vs "
                      f"{s_d[strat].latency_rounds} payload rounds/iter -> "
                      f"comm@{HIGH_LAT.describe()} {t_s*1e3:.1f}ms vs {t_d*1e3:.1f}ms "
                      f"({t_d/t_s:.1f}x)")
        problem = make_problem(_gen(1), n=n, m=256, d=32, hetero=0.2, noise=0.1,
                               device=args.device)
        print(f"{'comp':>7} {'wire b/elem':>12} {'alpha':>8} {'dcd dist_opt':>14} "
              f"{'ecd dist_opt':>14}")
        for tag, comp in sweep:
            bits = comp.wire_bits_per_element((z.numel(),))
            alpha = measured_alpha(comp, _gen(2), z)
            res = {name: run(problem, Algorithm(name=name, W=W, compressor=comp), T=T,
                             lr=0.01, eval_every=T)["final_dist_opt"]
                   for name in ("dcd", "ecd")}
            flag = "  <-- alpha over DCD budget" if alpha > info.dcd_alpha_max() else ""
            print(f"{tag:>7} {bits:>12.2f} {alpha:>8.3f} {res['dcd']:>14.3e} "
                  f"{res['ecd']:>14.3e}{flag}")
            out.append((n, tag, res["dcd"], res["ecd"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="smoke: n=8 only, 150 steps (no convergence claims)")
    ap.add_argument("--topology", default="ring", choices=list(GOSSIP_TOPOLOGIES),
                    help="gossip plan/schedule spec; a schedule sweeps its effective dense W "
                         "and prints the O(log n) round win")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="run the failure sweep instead: convergence vs drop rate "
                         "{0, R, 2.5R} on the stacked reference")
    ap.add_argument("--drop-salt", type=int, default=0,
                    help="stream salt for the deterministic drop masks")
    ap.add_argument("--straggler", type=float, default=0.0,
                    help="also print the epoch-time-vs-straggler-tail curve at this "
                         "lognormal sigma (failure sweep only)")
    ap.add_argument("--lowrank", action="store_true",
                    help="run the low-rank smoke: dcd with lowrank:<r> wires on a "
                         "matrix-leaf problem, measured bits/element gated against the "
                         "32r(m+n)/(mn) budget (exits nonzero if off)")
    ap.add_argument("--pareto", action="store_true",
                    help="run the adaptive-wire pareto sweep (exits nonzero unless a "
                         "per-leaf adaptive spec strictly dominates a uniform spec)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="run the error-feedback sweep: {dcd, ecd, choco, deepsqueeze} x "
                         "biased ~1-bit wire specs vs the D-PSGD fp32 plateau")
    ap.add_argument("--algo", default=None, choices=list(EF_ALGOS),
                    help="restrict the error-feedback sweep to one algorithm "
                         "(implies --error-feedback)")
    ap.add_argument("--wire", default=None,
                    help="restrict the error-feedback sweep to one wire spec, e.g. sign "
                         "or sparse:0.05:topk (implies --error-feedback)")
    ap.add_argument("--gamma", type=float, default=0.2,
                    help="CHOCO consensus stepsize; must shrink with the compressor's "
                         "delta (0.2 is stable for every spec here; 0.5 diverges at "
                         "top-5%%)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    T = 150 if args.quick else 600

    if args.lowrank:
        return lowrank_sweep(args, T=30 if args.quick else 150)
    if args.pareto:
        return pareto_sweep(args)
    if args.drop_rate > 0.0:
        return drop_sweep(args, T)
    if args.error_feedback or args.algo or args.wire:
        return error_feedback_sweep(args, T)
    return bits_sweep(args, T)


if __name__ == "__main__":
    main()
