"""Import hygiene of the PyTorch port: no JAX, and nothing of the JAX package.

An AST walk over ``src/repro_torch/**`` and ``chip_smoke.py``; strings and
comments that mention jax or repro are not imports and pass.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _bad_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _forbidden(alias.name):
                    yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and _forbidden(arg.value):
                    yield node.lineno, arg.value


def test_port_files_exist():
    assert len(PORT_FILES) > 10 and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert list(_bad_imports(path)) == []


def test_checker_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.kernels import quant\n"
                 "import repro_torch\nx = 'import jax'  # import repro\n"
                 "import importlib\nimportlib.import_module('repro.configs')\n")
    assert [m for _, m in _bad_imports(f)] == ["jax.numpy", "repro.kernels", "repro.configs"]
