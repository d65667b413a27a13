"""CLI gate: ``python -m repro_torch.analysis.lint [--sweep] [--device D]``.

The default run imports no torch and no jax: every ``RL###`` rule over the
port's files, exit 1 on any finding.  ``--sweep`` (the counterpart of the
JAX package's ``--jaxpr``) also runs one step of each case of the
representative (algorithm x topology x wire x drop) grid on ``--device``
(``cuda``, the default, or ``cpu``) through the step analyzer
(:mod:`repro_torch.analysis.step_checks`), one ``analysis[ok|FAIL]`` line a
case, exit 1 on any failing case.

Keep this module importable without torch: ``step_checks`` is imported
only for ``--sweep``.
"""
from __future__ import annotations

import argparse
import pathlib
import sys


def _default_root() -> pathlib.Path:
    # src/repro_torch/analysis/lint.py -> repo root is three levels above src/.
    root = pathlib.Path(__file__).resolve().parents[3]
    if (root / "src" / "repro_torch").is_dir():
        return root
    return pathlib.Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="stdlib AST lint of the port + optional step-analyzer sweep")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--sweep", action="store_true",
                    help="also run one step of every case of the representative grid "
                         "through the step analyzer (imports torch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the sweep's device (default: cuda)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    from repro_torch.analysis.staticcheck import RULES, lint_tree

    if args.list_rules:
        for r in sorted(RULES.values(), key=lambda r: r.id):
            scope = r.scope if not r.paths else f"{r.scope} {'/'.join(r.paths)}"
            print(f"{r.id}  [{scope}]  {r.title}")
        return 0

    root = pathlib.Path(args.root) if args.root else _default_root()
    findings = lint_tree(root)
    for f in findings:
        print(f)
    failed = bool(findings)
    print(f"staticcheck: {len(findings)} finding(s) over {root}")

    if args.sweep:
        from repro_torch.analysis import step_checks

        reports = step_checks.run_sweep(device=args.device)
        bad = 0
        for rep in reports:
            print(f"analysis[{'ok' if rep.ok else 'FAIL'}] {rep.describe()}")
            for v in rep.violations:
                print(f"  - {v}")
            bad += not rep.ok
        print(f"step sweep: {len(reports)} case(s) on {args.device}, {bad} failing")
        failed = failed or bad > 0

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
