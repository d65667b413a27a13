"""Stdlib-only AST lint engine with an ``RL###`` rule registry.

The port of the JAX package's ``analysis/staticcheck``: no torch and no jax
import anywhere in this package, so it runs on a bare python install.
Rules come in two scopes:

- ``file`` rules get ``(rel_path, ast_tree, source)`` for every scanned
  ``.py`` file and yield :class:`Finding`s.  A rule may restrict itself to
  path prefixes via ``paths=("src/repro_torch/",)``.
- ``tree`` rules get the repo root once and check cross-file contracts
  (salt uniqueness, wire-registry completeness).

It scans the port's own files (:data:`SCAN_GLOBS`): the package, its tests
and ``chip_smoke.py``.  ``lint_source`` exists so tests can feed negative
fixtures (snippets that must trigger a rule) without touching disk;
``lint_tree`` is the CLI's clean-tree gate.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import warnings
from typing import Callable, Iterator, List, Optional, Tuple

# Files scanned for file-scope rules: globs relative to the repo root.
SCAN_GLOBS = ("src/repro_torch/**/*.py", "tests/test_torch_*.py", "chip_smoke.py")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint violation, formatted ``path:line: RL### message``."""

    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    scope: str  # "file" | "tree"
    check: Optional[Callable]  # None for engine-implemented rules (RL001/2)
    paths: Tuple[str, ...] = ()  # path-prefix filter for file rules; () = all


RULES: dict[str, Rule] = {}


def rule(rule_id: str, title: str, *, scope: str = "file",
         paths: Tuple[str, ...] = ()) -> Callable:
    """Register a rule function under ``rule_id`` (decorator)."""

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(rule_id, title, scope, fn, tuple(paths))
        return fn

    return deco


def _register_engine_rules() -> None:
    # RL001/RL002 are implemented by the engine itself (the parse/compile
    # step below), but still live in the registry so the catalog and the
    # per-rule fixture tests can enumerate them.
    RULES["RL001"] = Rule("RL001", "syntax error (E9-equivalent)", "file", None)
    RULES["RL002"] = Rule(
        "RL002",
        "illegal statement placement, e.g. break outside loop "
        "(F70x-equivalent)",
        "file",
        None,
    )


_register_engine_rules()


def lint_source(source: str, rel_path: str) -> List[Finding]:
    """Lint one file's source text; ``rel_path`` is repo-relative posix.

    The path decides which path-scoped rules apply, so fixture tests can
    opt snippets in or out of the package-only contract rules.
    """
    try:
        tree = ast.parse(source, filename=rel_path)
    except SyntaxError as e:
        return [Finding(rel_path, e.lineno or 1, "RL001",
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    try:
        # ast.parse accepts e.g. a bare `break`; bytecode compilation is
        # where CPython rejects misplaced statements.  Nothing executes.
        # CPython also emits SyntaxWarnings here (`is` with a literal...)
        # for patterns RL004/RL005 already report — keep stderr quiet.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", SyntaxWarning)
            compile(source, rel_path, "exec", dont_inherit=True)
    except SyntaxError as e:
        findings.append(Finding(rel_path, e.lineno or 1, "RL002",
                                f"illegal statement: {e.msg}"))
    for r in sorted(RULES.values(), key=lambda r: r.id):
        if r.scope != "file" or r.check is None:
            continue
        if r.paths and not rel_path.startswith(r.paths):
            continue
        findings.extend(r.check(rel_path, tree, source))
    return sorted(findings)


def lint_file(path: pathlib.Path, rel_path: str) -> List[Finding]:
    return lint_source(path.read_text(), rel_path)


def iter_py_files(root: pathlib.Path) -> Iterator[Tuple[pathlib.Path, str]]:
    """Every file of :data:`SCAN_GLOBS` under ``root``, once, in path order."""
    found = {}
    for pattern in SCAN_GLOBS:
        for p in root.glob(pattern):
            if p.is_file() and "__pycache__" not in p.parts:
                found[p.relative_to(root).as_posix()] = p
    for rel in sorted(found):
        yield found[rel], rel


def lint_tree(root) -> List[Finding]:
    """Run every rule over the repo at ``root``; empty list == clean."""
    root = pathlib.Path(root)
    findings: List[Finding] = []
    for path, rel in iter_py_files(root):
        findings.extend(lint_file(path, rel))
    for r in sorted(RULES.values(), key=lambda r: r.id):
        if r.scope == "tree":
            findings.extend(r.check(root))
    return sorted(findings)


# Importing the rule modules populates RULES as a side effect.
from repro_torch.analysis.staticcheck import basics as _basics  # noqa: E402,F401
from repro_torch.analysis.staticcheck import contracts as _contracts  # noqa: E402,F401
