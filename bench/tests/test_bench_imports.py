"""No module a benchmark run reaches imports JAX or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port), and
the reference and the model families import nothing of the port."""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys
import time
import types

from bench import harness, ranks, run
from bench.tests.tiny import RANK_CELLS, ROOT, toy_root

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported_tops(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def _sources(*dirs):
    return [p for d in dirs for p in sorted(d.rglob("*.py")) if "tests" not in p.parts[-2:]]


def test_no_run_module_imports_jax_or_the_jax_package():
    files = _sources(ROOT / "bench", ROOT / "src" / "repro_torch")
    assert len(files) > 50
    bad = {str(p): sorted(_imported_tops(p) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_port():
    """The reference and the model families' files, which it runs (not the
    families' loader)."""
    families = [p for p in _sources(ROOT / "bench" / "families") if p.name != "__init__.py"]
    assert families
    files = _sources(ROOT / "bench" / "reference") + families
    for p in files:
        assert "repro_torch" not in _imported_tops(p), p
        assert _imported_tops(p) <= {"__future__", "math", "numpy", "torch", "bench"}, p


def test_a_run_loads_no_jax_module(tmp_path):
    """A toy run in a fresh interpreter leaves no module of JAX or of
    ``repro`` in ``sys.modules``."""
    code = (
        "import pathlib, sys, time\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from bench.tests.tiny import toy_root\n"
        "from bench import run\n"
        f"root = toy_root(pathlib.Path({str(tmp_path)!r}))\n"
        "run.run(root, 'toy-ssm.dcd-q8', 3, 0.1, False, 'cpu', time.perf_counter())\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _rank_run_loading_jax(group, *args):
    """A rank's run in which rank 1 loads a module named ``jax`` during its
    steps."""
    if group.rank == 1:
        step = harness.Program.step

        def loading(self, batch):
            sys.modules.setdefault("jax", types.ModuleType("jax"))
            return step(self, batch)

        harness.Program.step = loading
    return ranks._rank_run(group, *args)


def test_a_module_loaded_on_a_rank_fails_the_run(tmp_path, monkeypatch, capsys):
    """A module of JAX that one rank loads during the window, and not the
    process that prints the result, makes the run exit 3 with no result."""
    root = toy_root(tmp_path)
    monkeypatch.setattr(ranks, "_rank_run", _rank_run_loading_jax)
    result = ranks.run(root, next(iter(RANK_CELLS)), 5, 0.1, False, time.perf_counter(),
                       device="cpu")
    assert result["loaded"] == ["jax"]
    assert run.finish(result) == 3
    assert capsys.readouterr().out == ""
