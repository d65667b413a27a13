"""The port's contract rules: determinism, wire salts, confinement of the
process group and the kernel libraries, and wire-registry completeness.

The JAX package's contract rules, pointed at the port's structure.  File
rules are scoped to ``src/repro_torch/`` — tests and ``chip_smoke.py`` may
use ad-hoc RNG and call the kernel libraries directly.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Iterator, Optional

from repro_torch.analysis.staticcheck import Finding, rule

PACKAGE = "src/repro_torch/"

# ---------------------------------------------------------------------------
# RL010 — unseeded numpy or torch RNG under src/repro_torch/
# ---------------------------------------------------------------------------

# Constructors that are fine *when given an explicit seed argument*.
_RNG_CTORS = frozenset({
    "default_rng", "RandomState", "SeedSequence", "Philox", "PCG64",
    "SFC64", "Generator",
})
# Module-level numpy global-state RNG: never acceptable in the package — it
# is unseeded process state, invisible to the (step, salt, leaf) contract.
_GLOBAL_RNG_FNS = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "bytes", "normal", "uniform", "choice", "shuffle",
    "permutation", "standard_normal", "binomial", "poisson", "beta",
    "gamma", "exponential", "laplace", "get_state", "set_state",
})
# torch calls that seed a global generator from OS entropy.
_TORCH_ENTROPY_SEEDS = frozenset({"torch.seed", "torch.random.seed"})


def _np_random_attr(func: ast.AST):
    """Return the attribute name X for ``np.random.X`` / ``numpy.random.X``."""
    if (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Attribute)
            and func.value.attr == "random"
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id in ("np", "numpy")):
        return func.attr
    return None


def _numpy_random_imports(tree: ast.AST) -> set:
    """Names imported directly from ``numpy.random``."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("numpy.random"):
            for alias in node.names:
                names.add(alias.asname or alias.name)
    return names


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a chain of attributes on a name, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


@rule("RL010", "unseeded numpy or torch RNG under src/repro_torch/", paths=(PACKAGE,))
def unseeded_rng(rel_path: str, tree: ast.AST, source: str) -> Iterator[Finding]:
    direct = _numpy_random_imports(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _dotted(node.func) in _TORCH_ENTROPY_SEEDS:
            yield Finding(rel_path, node.lineno, "RL010",
                          f"{_dotted(node.func)}() seeds a global generator from OS "
                          "entropy — use an explicitly seeded torch.Generator")
            continue
        attr = _np_random_attr(node.func)
        if attr is None and isinstance(node.func, ast.Name) and \
                node.func.id in direct:
            attr = node.func.id
        if attr is None:
            continue
        if attr in _GLOBAL_RNG_FNS:
            yield Finding(rel_path, node.lineno, "RL010",
                          f"numpy global-state RNG np.random.{attr}() — use "
                          "an explicitly seeded Generator")
        elif attr in _RNG_CTORS and not node.args and not node.keywords:
            yield Finding(rel_path, node.lineno, "RL010",
                          f"np.random.{attr}() without a seed draws from OS "
                          "entropy — pass an explicit seed")


# ---------------------------------------------------------------------------
# RL011 — time/entropy-derived seeds under src/repro_torch/
# ---------------------------------------------------------------------------

# The JAX package's sinks, and torch's ``manual_seed`` (``torch.manual_seed``
# and ``<generator>.manual_seed``).
_SEED_SINKS = frozenset({
    "key", "PRNGKey", "seed", "default_rng", "RandomState",
    "SeedSequence", "fold_in", "manual_seed",
})
_ENTROPY_FNS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "urandom", "uuid1", "uuid4", "getrandbits",
    "token_bytes", "token_hex", "randbytes",
})


def _call_name(func: ast.AST):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


@rule("RL011", "time/entropy-derived seed under src/repro_torch/", paths=(PACKAGE,))
def time_derived_seed(rel_path: str, tree: ast.AST,
                      source: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _call_name(node.func) in _SEED_SINKS):
            continue
        args = list(node.args) + [kw.value for kw in node.keywords]
        for arg in args:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call) and \
                        _call_name(sub.func) in _ENTROPY_FNS:
                    yield Finding(
                        rel_path, node.lineno, "RL011",
                        f"seed derived from {_call_name(sub.func)}() — "
                        "seeds must be deterministic (step, salt, leaf)")


# ---------------------------------------------------------------------------
# RL021 — the process group and the kernel libraries, confined
# ---------------------------------------------------------------------------

# torch.distributed lives in distributed/ (the rank transport) and in
# launch/mesh.py (the process group's home); the kernel libraries (built
# and bound by kernels/build.py) are reached from kernels/ only.
_DIST_ALLOWED = (PACKAGE + "distributed/", PACKAGE + "launch/mesh.py")
_KERNELS_ALLOWED = (PACKAGE + "kernels/",)


def _is_torch_distributed(module: str) -> bool:
    return module == "torch.distributed" or module.startswith("torch.distributed.")


@rule("RL021",
      "torch.distributed confined to distributed/ and launch/mesh.py, kernel "
      "libraries to kernels/", paths=(PACKAGE,))
def confined_primitives(rel_path: str, tree: ast.AST,
                        source: str) -> Iterator[Finding]:
    dist_ok = rel_path.startswith(_DIST_ALLOWED)
    kernels_ok = rel_path.startswith(_KERNELS_ALLOWED)
    seen = set()

    def hit(node, symbol, where):
        if (node.lineno, symbol) not in seen:
            seen.add((node.lineno, symbol))
            yield Finding(rel_path, node.lineno, "RL021",
                          f"use of {symbol} outside {where} — the process group and "
                          "the kernel libraries are confined so wire honesty "
                          "stays auditable")

    dist_where = "distributed/ and launch/mesh.py"
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and not dist_ok:
            mod = node.module or ""
            if _is_torch_distributed(mod) or (mod == "torch" and any(
                    a.name == "distributed" for a in node.names)):
                yield from hit(node, "torch.distributed", dist_where)
        elif isinstance(node, ast.Import) and not dist_ok:
            if any(_is_torch_distributed(a.name) for a in node.names):
                yield from hit(node, "torch.distributed", dist_where)
        elif isinstance(node, ast.Attribute) and not dist_ok and \
                _dotted(node) == "torch.distributed":
            yield from hit(node, "torch.distributed", dist_where)
        elif isinstance(node, ast.Call) and not kernels_ok and \
                isinstance(node.func, ast.Attribute):
            name = _dotted(node.func)
            if name == "build.load" or node.func.attr.endswith("_launch"):
                yield from hit(node, f"{name or node.func.attr}()", "kernels/")


# ---------------------------------------------------------------------------
# RL020 — the wire-salt table and the salts of leaf_seed (tree)
# ---------------------------------------------------------------------------

_SALTS_FILE = PACKAGE + "distributed/decentralized.py"
_SALTS_NAME = "_SALT"
_SEEDED_DIRS = (PACKAGE + "distributed", PACKAGE + "core")


def _parse_salts(tree: ast.AST):
    """``(dict node, {family: (salt, line)})`` of the ``_SALT = {...}``
    literal, or None if absent."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == _SALTS_NAME for t in node.targets):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                    out[k.value] = (v.value, getattr(v, "lineno", node.lineno))
            return out
    return None


def _literal_salts(tree: ast.AST):
    """``[(line, salt)]`` of every ``leaf_seed(step, salt, leaf)`` call whose
    salt is an integer literal."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _call_name(node.func) == "leaf_seed"):
            continue
        salt = node.args[1] if len(node.args) >= 2 else next(
            (kw.value for kw in node.keywords if kw.arg == "salt"), None)
        if isinstance(salt, ast.Constant) and isinstance(salt.value, int):
            yield node.lineno, salt.value


@rule("RL020", "wire salts: one table of distinct salts, no literal salt at a seed",
      scope="tree")
def wire_salt_uniqueness(root: pathlib.Path) -> Iterator[Finding]:
    salts_path = root / _SALTS_FILE
    if not salts_path.is_file():
        yield Finding(_SALTS_FILE, 1, "RL020",
                      "wire-salt contract file missing — if the salt table "
                      "moved, update repro_torch.analysis.staticcheck.contracts")
        return
    table = _parse_salts(ast.parse(salts_path.read_text()))
    if table is None:
        yield Finding(_SALTS_FILE, 1, "RL020", f"{_SALTS_NAME} dict literal not found")
        return
    by_salt = {}
    for family, (salt, line) in sorted(table.items()):
        if salt in by_salt:
            yield Finding(_SALTS_FILE, line, "RL020",
                          f"salt collision: families {by_salt[salt]!r} and "
                          f"{family!r} share wire salt {salt}")
        by_salt.setdefault(salt, family)
    for d in _SEEDED_DIRS:
        for p in sorted((root / d).rglob("*.py")):
            rel = p.relative_to(root).as_posix()
            for line, salt in _literal_salts(ast.parse(p.read_text())):
                yield Finding(rel, line, "RL020",
                              f"leaf_seed(...) with the literal salt {salt} — take it "
                              f"from {_SALTS_NAME} so the runtime and the reference "
                              "cannot diverge")


# ---------------------------------------------------------------------------
# RL022 — registered WireFormat completeness (tree)
# ---------------------------------------------------------------------------

_WIRE_FILE = PACKAGE + "distributed/wire.py"
_WIRE_DOC = "docs/wire-formats.md"


def _registrations(tree: ast.AST):
    """[(name, ctor_class_name, line)] from register_wire_format calls."""
    regs = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "register_wire_format"
                and len(node.args) >= 2
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[1], ast.Name)):
            regs.append((node.args[0].value, node.args[1].id, node.lineno))
    return regs


def _wire_spec_isinstance_classes(tree: ast.AST):
    """Class names appearing in isinstance() checks inside wire_spec()."""
    classes = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "wire_spec":
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == "isinstance"
                        and len(sub.args) == 2):
                    second = sub.args[1]
                    elts = second.elts if isinstance(second, ast.Tuple) \
                        else [second]
                    classes.update(e.id for e in elts
                                   if isinstance(e, ast.Name))
    return classes


@rule("RL022", "registered WireFormat completeness", scope="tree")
def wire_registry_completeness(root: pathlib.Path) -> Iterator[Finding]:
    wire_path = root / _WIRE_FILE
    if not wire_path.is_file():
        yield Finding(_WIRE_FILE, 1, "RL022",
                      "wire registry file missing — if the registry moved, "
                      "update repro_torch.analysis.staticcheck.contracts")
        return
    tree = ast.parse(wire_path.read_text())
    regs = _registrations(tree)
    if not regs:
        yield Finding(_WIRE_FILE, 1, "RL022",
                      "no register_wire_format() calls found")
        return
    covered = _wire_spec_isinstance_classes(tree)
    doc_path = root / _WIRE_DOC
    doc_text = doc_path.read_text() if doc_path.is_file() else ""
    for name, ctor, line in regs:
        if ctor not in covered:
            yield Finding(_WIRE_FILE, line, "RL022",
                          f"registered wire format {name!r} ({ctor}) has no "
                          "isinstance branch in wire_spec() — specs would "
                          "not round-trip")
        if f"`{name}" not in doc_text:
            yield Finding(_WIRE_FILE, line, "RL022",
                          f"registered wire format {name!r} has no anchor "
                          f"in {_WIRE_DOC}")
