"""Generic correctness rules: the pyflakes-critical subset (E9/F63/F7/F82)
the pyproject ruff config selects, reimplemented on stdlib ``ast`` so the
gate runs in containers without a ruff binary.  The JAX package's RL003,
RL004 and RL005, with the same findings and messages.

RL001 (syntax error) and RL002 (illegal statement placement) live in the
engine itself — they are parse/compile failures, not AST visits.
"""
from __future__ import annotations

import ast
import builtins
from typing import Iterator

from repro_torch.analysis.staticcheck import Finding, rule

_BUILTIN_NAMES = frozenset(dir(builtins)) | {
    "__file__", "__name__", "__doc__", "__spec__", "__loader__",
    "__package__", "__builtins__", "__debug__", "__path__",
    "__annotations__", "__dict__", "__class__", "__module__",
    "__qualname__",
}


def _bound_names(tree: ast.AST):
    """Every name bound anywhere in the module, or None on ``import *``.

    Scope-free by design: a name bound in any function counts as bound
    everywhere.  That makes RL003 strictly weaker than pyflakes F821 but
    free of false positives — right for a blocking gate.
    """
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.arg):
            names.add(node.arg)
        elif isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            names.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                if alias.name == "*":
                    return None
                names.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            names.update(node.names)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            names.add(node.name)
        elif isinstance(node, ast.MatchAs) and node.name:
            names.add(node.name)
        elif isinstance(node, ast.MatchStar) and node.name:
            names.add(node.name)
        elif isinstance(node, ast.MatchMapping) and node.rest:
            names.add(node.rest)
    return names


@rule("RL003", "undefined name (F821-equivalent, bound-anywhere)")
def undefined_names(rel_path: str, tree: ast.AST,
                    source: str) -> Iterator[Finding]:
    bound = _bound_names(tree)
    if bound is None:  # star import: every name is potentially bound
        return
    reported = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                and node.id not in bound
                and node.id not in _BUILTIN_NAMES
                and node.id not in reported):
            reported.add(node.id)
            yield Finding(rel_path, node.lineno, "RL003",
                          f"undefined name '{node.id}'")


_LITERAL_NODES = (ast.Tuple, ast.List, ast.Dict, ast.Set, ast.JoinedStr)


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        # `is None` / `is True` are idiomatic and excluded (like F632).
        return not (node.value is None or isinstance(node.value, bool))
    return isinstance(node, _LITERAL_NODES)


@rule("RL004", "`is` comparison with a literal (F632-equivalent)")
def is_literal(rel_path: str, tree: ast.AST,
               source: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left] + node.comparators
        for i, op in enumerate(node.ops):
            if isinstance(op, (ast.Is, ast.IsNot)) and (
                    _is_literal(operands[i]) or _is_literal(operands[i + 1])):
                yield Finding(rel_path, node.lineno, "RL004",
                              "`is` comparison with a literal always has a "
                              "fixed truth value; use == / !=")


@rule("RL005", "assert on a non-empty tuple (F631-equivalent)")
def assert_tuple(rel_path: str, tree: ast.AST,
                 source: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assert) and isinstance(node.test, ast.Tuple)
                and node.test.elts):
            yield Finding(rel_path, node.lineno, "RL005",
                          "assert on a non-empty tuple is always true — "
                          "did you mean `assert cond, msg`?")
