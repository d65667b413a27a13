"""The program's spans in a run of a cell: host and device time by layer.

    python3 bench/spans.py --workload <name> --seed <n> --seconds <s>

From the root of a checkout, on a CUDA card.  The cell is set up as
``bench/run.py`` sets it up (its first steps with tracing off), then four
windows of ``--seconds`` run in turn with the program's spans
(:mod:`repro_torch.trace`) off, on, off, on, each closing its batch call
with a synchronize as a ``--trace 1`` window does; then
:data:`~bench.harness.PROFILED_STEPS` steps run under ``torch.profiler``
twice, spans off, then on.  The last line of standard output is one JSON
object: each window's mean step and spans a step, the self host
milliseconds a step of each span over the traced windows, both profiles'
summaries (:func:`bench.harness.trace_summary`) and, of the traced one,
:func:`span_summary`; the ``bench/metrics`` readers' values off and on; and
what a span costs on the host, off and on.

:func:`span_summary` attributes each device operation to the innermost
program span open when its launch started (the CUDA runtime call with the
same correlation id; the operation's own start where none matches), by
time and not by thread, so the launches the autograd engine makes on its
own thread during ``model.backward`` land there; and names each idle gap
of the device after the innermost program span open at its middle, or the
benchmark's span where none is.  ``bench/run.py --trace 1`` does not turn
the spans on: its harness would need to (``PERF.md``, open questions).
The readers of the per-layer metrics that read spans find nothing in its
records and return ``None``.
"""
from __future__ import annotations

import heapq
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

UNCOVERED = "(no span)"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
# the metrics that read spans, beside the ones they are compared with
READERS = ("model.host_ms_per_step", "model.device_ms_per_step", "optim.device_ms_per_step",
           "gossip.host_ms_per_step", "gossip.device_ms_per_step",
           "step.metrics_ms_per_step", "data.launches_per_step", "device.idle_share",
           "device.launches_per_step", "kernels.wire_ms_per_step", "kernels.wire_roofline",
           "data.ms_per_step", "step.mfu")


def _names() -> tuple:
    """The program's span names; none where the program has no spans."""
    try:
        from repro_torch.trace import NAMES
    except ImportError:
        return ()
    return NAMES


def gossip_span(name: str) -> bool:
    """A span of the gossip layer: the rounds and every exchange, not the
    metrics' transport."""
    return name.startswith(("gossip.", "transport.")) and name != "transport.metric"


def self_ms(spans, steps: int) -> Dict[str, float]:
    """Self host milliseconds a step of each span name (its time less its
    child spans'), from :func:`repro_torch.trace.collect`'s spans."""
    child = [0] * len(spans)
    for _, _, parent, t0, t1 in spans:
        if parent is not None:
            child[parent] += t1 - t0
    out: Dict[str, float] = {}
    for (name, _, _, t0, t1), c in zip(spans, child):
        out[name] = out.get(name, 0.0) + (t1 - t0 - c) / 1e6 / steps
    return out


def _innermost(spans, times) -> List[Optional[str]]:
    """The innermost of the nested ``(start, end, name)`` ``spans`` open at
    each of the ascending ``times`` (the one that started last), or None."""
    spans = sorted(spans)
    out, running, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            heapq.heappush(running, (-spans[j][0], spans[j][1], spans[j][2]))
            j += 1
        while running and running[0][1] < t:
            heapq.heappop(running)
        out.append(running[0][2] if running else None)
    return out


def span_summary(host, device, launched: Dict[int, int]) -> dict:
    """From host events ``(start_ns, end_ns, name)``, device events
    ``(start_ns, end_ns, name, correlation_id)`` and the start of each
    runtime launch call by correlation id: ``spans``, ``{name: [device
    seconds, kernel launches]}`` of each program span name (and
    :data:`UNCOVERED`); ``idle_gaps``, the ten largest sums of the device's
    idle seconds by ``"<where>: <what>"``; ``step_idle_named``, the share of
    the idle seconds that :func:`bench.harness.trace_summary` finds inside
    ``bench.step`` that a program span names; ``clock_skew_ms``, the first
    percentile of the delays from launch to start, taken off the device's
    timestamps.  A gap after which the device ran an operation launched
    before the gap began is the device's own (the host was ahead): ``<the
    innermost span at that launch>: queued``.  Any other gap waited for the
    host: ``<the innermost span at its middle>: <the host op then>``
    (:func:`bench.harness._host_during`).  The innermost span is a program
    span, else the benchmark's.  Gaps of a few microseconds between
    back-to-back launches fall on either side of that line with the offset
    left after ``clock_skew_ms``; their span is the same either way.  Empty
    without program spans."""
    from bench import harness

    names = _names()
    prog = [h for h in host if h[2] in names]
    if not prog:
        return {}
    marked = {name for _, _, name in host}
    work = [d for d in device if d[1] > d[0] and d[2] not in marked]
    # the profiler can map the device's clock onto the host's a few ms off;
    # most launches of these cells find the device idle and start within
    # microseconds, so the lowest percentile of launch-to-start delays is
    # that offset (a lone op that seems to start before its launch is not)
    delays = sorted(s - launched[c] for s, _, _, c in work if c in launched)
    skew = delays[len(delays) // 100] if delays else 0
    dev = [(s - skew, e - skew, name, launched.get(c, s - skew)) for s, e, name, c in work]
    at = sorted((t, s, e, name) for s, e, name, t in dev)
    rows: Dict[str, list] = {}
    for (_, s, e, name), where in zip(at, _innermost(prog, [a[0] for a in at])):
        row = rows.setdefault(where or UNCOVERED, [0.0, 0])
        row[0] += (e - s) / 1e9
        row[1] += harness._is_kernel(name)
    bench = sorted(h for h in host if h[2] in harness.SPANS)
    gaps = _gaps(bench, [(s, e, t) for s, e, _, t in dev])
    mids = [(g0 + g1) // 2 for g0, g1, _ in gaps]
    ops = sorted(h for h in host if h[2] not in harness.SPANS and h[2] not in names)
    queued = [t is not None and t <= g0 for g0, _, t in gaps]
    when = [t if q else mid for (_, _, t), q, mid in zip(gaps, queued, mids)]
    order = sorted(range(len(gaps)), key=when.__getitem__)
    where: List[Optional[str]] = [None] * len(gaps)
    for i, span in zip(order, _innermost(prog + bench, [when[i] for i in order])):
        where[i] = span
    idle: Dict[str, int] = {}
    step_idle = named = 0
    for (g0, g1, _), now, span, q in zip(gaps, harness._host_during(ops, bench, mids), where,
                                         queued):
        outer, op = now.split(": ", 1)
        key = f"{span or outer}: {'queued' if q else op}"
        idle[key] = idle.get(key, 0) + (g1 - g0)
        if outer == "bench.step":
            step_idle += g1 - g0
            named += (g1 - g0) if span in names else 0
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"spans": rows, "idle_gaps": [[k, v / 1e9] for k, v in top],
            "step_idle_named": named / step_idle if step_idle else None,
            "clock_skew_ms": skew / 1e6}


def _gaps(bench, busy) -> List[tuple]:
    """The device's idle intervals inside the benchmark's spans' window, as
    :func:`bench.harness.trace_summary` finds them, from the ``(start, end,
    launch)`` of each device operation: ``(start, end, launch)`` of each
    gap, ``launch`` that of the operation that ends it (None for the last)."""
    lo, hi = bench[0][0], max(e for _, e, _ in bench)
    merged: List[list] = []
    for s, e, t in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, t])
    out, prev = [], lo
    for s, e, t in merged:
        g1 = min(max(s, lo), hi)
        if g1 > prev:
            out.append((prev, g1, t))
        prev = min(max(e, lo), hi)
    if hi > prev:
        out.append((prev, hi, None))
    return out


# --------------------------------------------------- what the readers read

def _rows(rec, which: Callable[[str], bool]) -> Optional[list]:
    prof = rec.get("profile")
    if not prof or not prof.get("spans"):
        return None
    return [row for name, row in prof["spans"].items() if which(name)]


def device_ms(rec, which: Callable[[str], bool]) -> Optional[float]:
    """Device milliseconds a profiled step of the operations launched inside
    the spans whose name ``which`` takes; None without a traced profile."""
    rows = _rows(rec, which)
    return None if rows is None else 1e3 * sum(r[0] for r in rows) / rec["profile"]["steps"]


def launches(rec, which: Callable[[str], bool]) -> Optional[float]:
    """Kernels a profiled step launched inside the spans ``which`` takes."""
    rows = _rows(rec, which)
    return None if rows is None else sum(r[1] for r in rows) / rec["profile"]["steps"]


def host_ms(rec, which: Callable[[str], bool]) -> Optional[float]:
    """Self host milliseconds a step of the spans ``which`` takes over the
    traced window; None without spans."""
    spans = rec.get("spans")
    return None if not spans else sum(ms for name, ms in spans.items() if which(name))


# ------------------------------------------------------------------- a run

def profile_steps(prog, steps: int) -> dict:
    """:func:`bench.harness.profile_steps` keeping what :func:`span_summary`
    reads: the profile's summary and, with program spans, their summary
    (its ``idle_gaps`` in place of the summary's, kept as ``bench_idle_gaps``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench import harness

    losses = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function(harness.SPANS[0]):
                batch = prog.batch()
            with record_function(harness.SPANS[1]):
                losses.append(prog.step(batch))
    host, device, launched = [], [], {}
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        elif kind == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), e.name()))
            if e.name().startswith(LAUNCH_CALLS):
                launched[e.correlation_id()] = e.start_ns()
    out = {"steps": steps, "losses": losses,
           **harness.trace_summary(host, [d[:3] for d in device])}
    out["bench_idle_gaps"] = out["idle_gaps"]
    return {**out, **span_summary(host, device, launched)}


def off_cost_ns(on: bool, n: int = 200_000) -> float:
    """Host nanoseconds one span adds, with tracing ``on`` or off (against
    an empty loop)."""
    from repro_torch import trace

    trace.enable(on)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with trace.span("step"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        pass
    t2 = time.perf_counter_ns()
    trace.enable(False)
    trace.collect()
    return ((t1 - t0) - (t2 - t1)) / n


def measure(root: pathlib.Path, workload: str, seed: int, seconds: float,
            device="cuda") -> dict:
    import torch

    from repro_torch import trace

    from bench import cells, harness

    cell = cells.find(root, workload)
    prog = harness.Program(cell, seed, torch.device(device))
    harness.first_steps(prog, cell, seed)
    wins = {False: [], True: []}
    out = {"workload": workload, "seed": seed, "windows": []}
    for on in (False, True, False, True):
        trace.enable(on)
        win = harness.window(prog, seconds, spans=True)
        trace.enable(False)
        spans = trace.collect()
        wins[on].append((win, spans))
        out["windows"].append({"spans_on": on, "steps": win["steps"],
                               "mean_step_s": sum(win["step_s"]) / len(win["step_s"]),
                               "spans_a_step": len(spans) / win["steps"]})
    profs = {}
    for on in (False, True):
        trace.enable(on)
        profs[on] = profile_steps(prog, harness.PROFILED_STEPS)
        trace.enable(False)
        trace.collect()
    shapes = [tuple(leaf.shape) for _, leaf in prog.leaves()]
    harness.free(prog)
    for on, runs in wins.items():
        win = {k: sum((w[k] for w, _ in runs), []) for k in ("losses", "data_s", "step_s")}
        win.update(steps=sum(w["steps"] for w, _ in runs),
                   window_s=sum(w["window_s"] for w, _ in runs), sent_bytes=0)
        rec = harness.record(cell, win, profs[on], shapes)
        if on:
            rec["spans"] = {}
            for w, spans in runs:
                for name, ms in self_ms(spans, win["steps"]).items():
                    rec["spans"][name] = rec["spans"].get(name, 0.0) + ms
            out["self_host_ms"] = rec["spans"]
        prof = {k: v for k, v in profs[on].items() if k != "losses"}
        out["profile_on" if on else "profile_off"] = prof
        out["metrics_on" if on else "metrics_off"] = {
            name: cells.metric_reader(root, name)(rec) for name in READERS}
    out["span_ns_off"], out["span_ns_on"] = off_cost_ns(False), off_cost_ns(True)
    out["device"] = torch.cuda.get_device_name(0) if torch.cuda.is_available() else device
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    if not torch.cuda.is_available():
        print("bench/spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(json.dumps(measure(root, args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
