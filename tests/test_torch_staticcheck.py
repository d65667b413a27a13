"""repro_torch.analysis.staticcheck — the port's stdlib-only lint gate,
against the JAX package's (``tests/test_staticcheck.py``).

- the linter and its CLI import neither torch nor jax (a subprocess with
  both imports poisoned);
- every registered rule has a negative fixture that makes it fire, and the
  path-scoped rules stay quiet outside their scope;
- the tree rules (RL020 salts, RL022 wire registry) on tmp_path mini-repos;
- the port's files are clean and the CLI exits 0;
- differential: the generic and determinism rules (RL001-RL005, RL010,
  RL011) give the JAX package's findings on every fixture of both files,
  and the port's salt table is the JAX package's.
"""
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import staticcheck as jsc
from repro.core.algorithms import _WIRE_SALTS
from repro_torch.analysis.staticcheck import RULES, Finding, iter_py_files, lint_source, lint_tree
from repro_torch.analysis.staticcheck.contracts import _SALTS_FILE, _WIRE_DOC, _WIRE_FILE
from repro_torch.distributed.decentralized import _SALT
from test_staticcheck import FILE_RULE_FIXTURES as JAX_FIXTURES
from test_torch_families import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}


def rules_of(findings):
    return {f.rule for f in findings}


def test_lint_imports_neither_torch_nor_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['torch'] = None\n"
        "import repro_torch.analysis.lint as m\n"
        "from repro_torch.analysis.staticcheck import lint_source\n"
        "assert callable(m.main)\n"
        "assert lint_source('x = 1\\n', 'src/repro_torch/x.py') == []\n"
        "assert lint_source('v = undefined_q\\n', 'src/repro_torch/x.py')[0].rule == 'RL003'\n"
        "print('NOTORCH_OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV)
    assert out.returncode == 0, out.stderr
    assert "NOTORCH_OK" in out.stdout


# ---------------------------------------------------------------------------
# negative fixtures: snippets that must fire each file-scope rule
# ---------------------------------------------------------------------------

# rule id -> [(rel_path the snippet pretends to live at, source)]
FILE_RULE_FIXTURES = {
    "RL001": [("src/repro_torch/x.py", "def f(:\n    pass\n")],
    "RL002": [("src/repro_torch/x.py", "break\n")],
    "RL003": [("src/repro_torch/x.py", "y = undefined_name_xyz + 1\n"),
              ("tests/test_torch_x.py", "def test_a():\n    assert missing_fixture\n")],
    "RL004": [("src/repro_torch/x.py", "flag = (x is 'a')\nx = 1\n")],
    "RL005": [("src/repro_torch/x.py", "assert (1 == 1, 'msg')\n")],
    "RL010": [("src/repro_torch/x.py", "import numpy as np\nv = np.random.rand(3)\n"),
              ("src/repro_torch/x.py", "import torch\ntorch.seed()\n"),
              ("src/repro_torch/x.py", "import torch\ns = torch.random.seed()\n"),
              ("src/repro_torch/x.py", "import numpy as np\ng = np.random.default_rng()\n")],
    "RL011": [("src/repro_torch/x.py",
               "import time, torch\ng = torch.Generator().manual_seed(int(time.time()))\n"),
              ("src/repro_torch/x.py", "import os, torch\ntorch.manual_seed(os.urandom(4)[0])\n"),
              ("src/repro_torch/x.py",
               "import time, numpy as np\nr = np.random.default_rng(time.time_ns())\n")],
    "RL021": [("src/repro_torch/core/x.py", "import torch.distributed as dist\n"),
              ("src/repro_torch/launch/train.py",
               "import torch\ntorch.distributed.destroy_process_group()\n"),
              ("src/repro_torch/models/x.py", "from torch import distributed\n"),
              ("src/repro_torch/distributed/x.py",
               "from repro_torch.kernels import build\nlib = build.load('quant')\n"),
              ("src/repro_torch/core/x.py", "err = lib.quantize_pack_2d_launch(0, 0)\n")],
}


@pytest.mark.parametrize("rule_id,case", [(r, i) for r in sorted(FILE_RULE_FIXTURES)
                                          for i in range(len(FILE_RULE_FIXTURES[r]))])
def test_file_rule_fires_on_fixture(rule_id, case):
    rel, src = FILE_RULE_FIXTURES[rule_id][case]
    assert rule_id in rules_of(lint_source(src, rel))


def test_every_rule_has_a_negative_fixture():
    tree_rules = {"RL020", "RL022"}  # exercised via tmp_path repos below
    assert set(FILE_RULE_FIXTURES) | tree_rules == set(RULES)
    assert {r.id for r in RULES.values() if r.scope == "tree"} == tree_rules


def test_findings_format_and_order():
    f = Finding("src/repro_torch/a.py", 3, "RL004", "msg")
    assert str(f) == "src/repro_torch/a.py:3: RL004 msg"
    findings = lint_source("assert (1, 'm')\nz = (q is 'a')\nq = 1\n", "src/repro_torch/x.py")
    assert findings == sorted(findings)
    assert rules_of(findings) == {"RL004", "RL005"}


# ---------------------------------------------------------------------------
# clean idioms and path scoping
# ---------------------------------------------------------------------------

CLEAN_SOURCES = [
    "import time\nimport numpy as np\nrng = np.random.default_rng(0)\nt0 = time.time()\n",
    "import torch\ng = torch.Generator(device='cpu').manual_seed(3)\nt = torch.manual_seed(0)\n",
    "from os.path import *\nq = join('a')\n",
]


@pytest.mark.parametrize("src", CLEAN_SOURCES)
def test_clean_idioms(src):
    assert lint_source(src, "src/repro_torch/x.py") == []


def test_path_scoping_of_contract_rules():
    """The package-only rules stay quiet for tests and chip_smoke.py; the
    process group is allowed in distributed/ and launch/mesh.py, the
    kernel libraries in kernels/."""
    rng = "import numpy as np\nimport torch\nv = np.random.rand(3)\ntorch.seed()\n"
    assert rules_of(lint_source(rng, "src/repro_torch/x.py")) == {"RL010"}
    assert lint_source(rng, "tests/test_torch_x.py") == []
    assert lint_source(rng, "chip_smoke.py") == []
    dist = "import torch.distributed as dist\ndist.barrier()\n"
    assert "RL021" in rules_of(lint_source(dist, "src/repro_torch/launch/train.py"))
    assert lint_source(dist, "src/repro_torch/distributed/transport.py") == []
    assert lint_source(dist, "src/repro_torch/launch/mesh.py") == []
    assert lint_source(dist, "chip_smoke.py") == []
    lib = "from repro_torch.kernels import build\nerr = build.load('sign').sign_pack_2d_launch(0)\n"
    assert "RL021" in rules_of(lint_source(lib, "src/repro_torch/distributed/wire.py"))
    assert lint_source(lib, "src/repro_torch/kernels/quant.py") == []
    assert lint_source(lib, "tests/test_torch_cuda.py") == []
    # repro_torch.distributed is the port's package, not torch.distributed
    own = "from repro_torch.distributed.wire import make_wire_format\n"
    assert lint_source(own, "src/repro_torch/core/x.py") == []


def test_scan_covers_the_port_files_only():
    rels = [rel for _, rel in iter_py_files(ROOT)]
    assert "chip_smoke.py" in rels
    assert "src/repro_torch/analysis/staticcheck/contracts.py" in rels
    assert "tests/test_torch_staticcheck.py" in rels
    assert not any(r.startswith("src/repro/") or r == "tests/test_staticcheck.py"
                   for r in rels)
    assert rels == sorted(set(rels))


# ---------------------------------------------------------------------------
# differential against the JAX package's rules
# ---------------------------------------------------------------------------

SHARED_RULES = ("RL001", "RL002", "RL003", "RL004", "RL005", "RL010", "RL011")


def _jax_side(rel: str) -> str:
    return rel.replace("src/repro_torch/", "src/repro/", 1)


def _port_side(rel: str) -> str:
    return rel.replace("src/repro/", "src/repro_torch/", 1) \
        if not rel.startswith("src/repro_torch/") else rel


def _shared(findings):
    return [(f.line, f.rule, f.message) for f in findings if f.rule in SHARED_RULES]


JAX_CLEAN = [
    "import time\nimport numpy as np\nrng = np.random.default_rng(0)\nt0 = time.time()\n",
    "from os.path import *\nq = join('a')\n",
    "assert (1, 'm')\nz = (q is 'a')\nq = 1\n",
    "import numpy as np\nv = np.random.rand(3)\n",
    "from jax.experimental import pallas as pl\n",
]
# every fixture of both files that is not torch's own form
DIFFERENTIAL = sorted(
    {(rel, src) for rel, src in JAX_FIXTURES.values()}
    | {(rel, src) for pairs in FILE_RULE_FIXTURES.values() for rel, src in pairs
       if "torch" not in src}
    | {(p, src) for src in JAX_CLEAN + CLEAN_SOURCES[:1] + CLEAN_SOURCES[2:]
       for p in ("src/repro/x.py", "tests/test_x.py")})


@pytest.mark.parametrize("rel,src", DIFFERENTIAL)
def test_shared_rules_give_the_jax_findings(rel, src):
    got = lint_source(src, _port_side(rel))
    want = jsc.lint_source(src, _jax_side(_port_side(rel)))
    assert _shared(got) == _shared(want)


def test_torch_forms_are_the_ports_own():
    """torch.seed() and manual_seed(time) fire in the port only."""
    for rel, src in FILE_RULE_FIXTURES["RL010"][1:3] + FILE_RULE_FIXTURES["RL011"][:2]:
        assert _shared(jsc.lint_source(src, _jax_side(rel))) == []
        assert _shared(lint_source(src, rel)) != []


def test_salt_table_is_the_jax_packages():
    assert _SALT == _WIRE_SALTS
    assert len(set(_SALT.values())) == len(_SALT)


# ---------------------------------------------------------------------------
# tree rules against tmp_path mini-repos
# ---------------------------------------------------------------------------

GOOD_SALTS = '_SALT = {"naive": 1, "dcd": 2}\n'
GOOD_SEEDS = "def encode(enc, salt, li):\n    return leaf_seed(enc, salt, li)\n"


def _salt_repo(tmp_path, salts_src, seeds_src=GOOD_SEEDS, where="core/algorithms.py"):
    (tmp_path / _SALTS_FILE).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / _SALTS_FILE).write_text(salts_src)
    seeds = tmp_path / "src" / "repro_torch" / where
    seeds.parent.mkdir(parents=True, exist_ok=True)
    seeds.write_text(seeds_src)
    return tmp_path


def _rl020(root):
    return [f for f in lint_tree(root) if f.rule == "RL020"]


def test_rl020_clean_mini_repo(tmp_path):
    assert _rl020(_salt_repo(tmp_path, GOOD_SALTS)) == []


def test_rl020_salt_collision_in_table(tmp_path):
    msgs = [f.message for f in _rl020(_salt_repo(tmp_path, '_SALT = {"naive": 1, "dcd": 1}\n'))]
    assert any("collision" in m for m in msgs), msgs


@pytest.mark.parametrize("call,where", [("leaf_seed(enc, 2, li)", "core/algorithms.py"),
                                        ("leaf_seed(enc, salt=3, leaf_index=li)",
                                         "distributed/wire.py")])
def test_rl020_literal_salt(tmp_path, call, where):
    root = _salt_repo(tmp_path, GOOD_SALTS, f"def encode(enc, li):\n    return {call}\n", where)
    found = _rl020(root)
    assert [f.path for f in found] == [f"src/repro_torch/{where}"]
    assert "literal salt" in found[0].message


def test_rl020_literal_salt_outside_the_runtime_is_fine(tmp_path):
    root = _salt_repo(tmp_path, GOOD_SALTS, "s = leaf_seed(0, 2, 0)\n", "examples/x.py")
    assert _rl020(root) == []


def test_rl020_missing_contract_file(tmp_path):
    msgs = [f.message for f in _rl020(tmp_path)]
    assert any("missing" in m for m in msgs), msgs


def test_rl020_table_not_a_literal(tmp_path):
    msgs = [f.message for f in _rl020(_salt_repo(tmp_path, "_SALT = dict(dcd=2)\n"))]
    assert any("not found" in m for m in msgs), msgs


WIRE_OK = (
    "class QuantWire: pass\n"
    "def register_wire_format(name, ctor, positional=()): pass\n"
    'register_wire_format("quant", QuantWire)\n'
    "def wire_spec(w):\n"
    "    if isinstance(w, QuantWire):\n"
    '        return "quant"\n'
)


def _wire_repo(tmp_path, wire_src, doc_text="the `quant:<bits>` format\n"):
    (tmp_path / _WIRE_FILE).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / _WIRE_FILE).write_text(wire_src)
    (tmp_path / _WIRE_DOC).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / _WIRE_DOC).write_text(doc_text)
    return tmp_path


def _rl022(root):
    return [f.message for f in lint_tree(root) if f.rule == "RL022"]


def test_rl022_clean_mini_repo(tmp_path):
    assert _rl022(_wire_repo(tmp_path, WIRE_OK)) == []


def test_rl022_missing_wire_spec_branch(tmp_path):
    msgs = _rl022(_wire_repo(tmp_path, WIRE_OK.replace("isinstance(w, QuantWire)", "False")))
    assert any("round-trip" in m for m in msgs), msgs


def test_rl022_missing_doc_anchor(tmp_path):
    msgs = _rl022(_wire_repo(tmp_path, WIRE_OK, doc_text="nothing relevant\n"))
    assert any("anchor" in m for m in msgs), msgs


def test_rl022_missing_registry_file(tmp_path):
    msgs = _rl022(tmp_path)
    assert any("missing" in m for m in msgs), msgs


# ---------------------------------------------------------------------------
# the port's files are clean — the gate the CLI enforces
# ---------------------------------------------------------------------------

def test_port_tree_is_clean():
    findings = lint_tree(ROOT)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_clean_tree_exits_zero():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                          "--root", str(ROOT)], capture_output=True, text=True, env=ENV)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "staticcheck: 0 finding(s)" in out.stdout


def test_cli_lists_rules_and_fails_on_a_finding(tmp_path):
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--list-rules"],
                         capture_output=True, text=True, env=ENV)
    assert out.returncode == 0 and len(out.stdout.splitlines()) == len(RULES)
    bad = tmp_path / "src" / "repro_torch" / "x.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("v = undefined_q\n")
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                          "--root", str(tmp_path)], capture_output=True, text=True, env=ENV)
    assert out.returncode == 1
    assert "src/repro_torch/x.py:1: RL003 undefined name 'undefined_q'" in out.stdout
