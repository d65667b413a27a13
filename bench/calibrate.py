"""The readings a cell's limits are set from, at the cell's own size.

    python3 bench/calibrate.py --workload <name> --seeds 1 2 3 ... [--faulty 3]

For each seed, the plain reference's record of the first steps, and the
numbers of :mod:`bench.compare` for: the program (a sound run); the control,
the reference itself computed with float8 projections put in the program's
place; and, on the first ``--faulty`` seeds, each fault of
:mod:`bench.faults` planted under the program.  No window is measured.  A
cell on ranks reads on its ranks (:func:`bench.ranks.readings`).  One
JSON line a reading on standard output, and the largest sound and the
smallest control and fault reading of each number at the end.  Not part of
a benchmark run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(root, workload: str, seeds, faulty: int, device, faults=None, group=None):
    """Yield ``(kind, seed, numbers)`` for the sound runs, the control and
    the faults; with ``group`` this process is one rank of a rank cell, and
    the numbers are the group's."""
    import torch

    from bench import cells, faults as planted, harness, weights
    from bench.reference import train as reference

    cell = cells.find(root, workload)
    names = list(planted.FAULTS) if faults is None else list(faults)
    node = None if group is None else group.rank
    for k, seed in enumerate(seeds):
        if torch.device(device).type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        params0 = weights.make(cell.config, seed, device)
        want = reference.run(cell.config, cell.traffic, seed, params0, harness.CHECK_STEPS,
                             device, node=node)
        runs = [("sound", None)] + ([(f, f) for f in names] if k < faulty else [])
        for kind, fault in runs:
            with planted.FAULTS[fault]() if fault else contextlib.nullcontext():
                prog = harness.Program(cell, seed, device, group)
                got = harness.first_steps(prog, cell, seed)
                harness.free(prog)
            yield kind, seed, {**harness.numbers(got, want, prog.total), **_worst(got, want)}
        if k < faulty:
            got = reference.run(cell.config, cell.traffic, seed, params0, harness.CHECK_STEPS,
                                device, precision="fp8", node=node)
            yield "control", seed, harness.numbers(got, want, prog.total)
        del params0


def _worst(got: dict, want: dict) -> dict:
    """The three leaves of the largest gradient and change norm gaps, with
    the reference's norms: where a number's reading comes from."""
    from bench import compare

    out = {}
    for key, keep in (("grad_norms", None), ("change_norms", compare.moving_leaves(want))):
        gaps = compare.leaf_gaps(got[key], want[key], keep)
        out[f"worst_{key}"] = [[p, gaps[p], want[key][p]]
                               for p in sorted(gaps, key=gaps.get, reverse=True)[:3]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faulty", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import cells, ranks

    on_ranks = "backend" in cells.find(ROOT, args.workload).traffic
    found = (ranks.readings if on_ranks else readings)(ROOT, args.workload, args.seeds,
                                                         args.faulty, args.device, args.faults)
    summary: dict = {}
    for kind, seed, nums in found:
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **nums,
                          "t": time.time()}), flush=True)
        pick = max if kind == "sound" else min
        for name, value in nums.items():
            if name.startswith("worst_"):
                continue
            old = summary.setdefault(kind, {}).get(name)
            summary[kind][name] = value if old is None else pick(old, value)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
