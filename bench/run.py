"""Benchmark of repro_torch, the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is the ``workloads`` entry of
``BENCHMARK.json`` named ``--workload``; its files are found by name
(:mod:`bench.cells`).  The run makes its weights and batches from
``--seed``, sets up and warms up the program's training step (counted in
``setup_s``), measures whole steps for ``--seconds``, and judges the
program's first steps against the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted`` (steps),
``failed`` (steps whose loss is not finite), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, the window's ``step_s`` (host seconds of
each step, batch included), and last ``checks``: each compared number
and its limit, which also end standard error.

A cell whose traffic names a ``backend`` runs on ranks, one process and
card a gossip node (:mod:`bench.ranks`).

It exits 2 and prints no result without a CUDA device (or fewer than the
cell asks for), and 3 when a module of JAX or of the JAX package ``repro``
is loaded once the window has closed, in this process or in a rank's.  The
program keeps its kernel libraries in ``build/repro_torch/`` inside the
checkout.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    """One run of ``workload`` on ``device``; the result object."""
    import torch

    from bench import cells, harness

    cell = cells.find(root, workload)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog = harness.Program(cell, seed, device)
    got = harness.first_steps(prog, cell, seed)
    setup_s = time.perf_counter() - started
    win = harness.window(prog, seconds, spans=trace)
    prof = harness.profile_steps(prog, harness.PROFILED_STEPS) if trace else None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    shapes = [tuple(leaf.shape) for _, leaf in prog.leaves()]
    harness.free(prog)
    del prog
    verdict = harness.judge(cell, seed, got, device)
    return harness.result(root, cell, win, prof, shapes, setup_s, peak, verdict, device, 1)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from bench import cells

    try:
        cell = cells.find(ROOT, args.workload)
    except (KeyError, FileNotFoundError) as err:
        print(f"bench: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    if "backend" in cell.traffic:
        from bench import ranks

        result = ranks.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           STARTED)
    else:
        result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                     STARTED)
    return finish(result)


def finish(result: dict) -> int:
    """Print ``result`` and return 0; or, where this process or a rank
    (``result["loaded"]``) holds a module of JAX or of ``repro`` now that the
    window has closed, name it on standard error, print no result and
    return 3."""
    found = sorted(set(forbidden_modules()) | set(result.pop("loaded", [])))
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = _power_limit()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
