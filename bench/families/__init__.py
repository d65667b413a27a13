"""A model family of the benchmark: one file, ``bench/families/<family>.py``,
found by the name a configuration's ``family`` gives.

A family file provides, for a configuration ``cfg`` (its JSON as a dict):

* ``arch(cfg)``: the ``ArchConfig`` keyword arguments beyond the common ones
  (name, family, depth, widths, vocabulary, ``rope_theta``), as plain
  values; a nested spec is a dict under its ``ArchConfig`` field's name
  (``ssm``, ``mla``, ``moe``);
* ``layout(cfg, proj)``: the block leaves, ``{path: (shape, init)}`` in the
  order their random values are drawn; ``init`` is a scale for a random
  leaf, ``"ones"``, ``"zeros"``, or a function ``(shape, device)`` that
  makes the leaf.  ``proj(d_in, d_out, lead=(n_layers,))`` is a projection
  stacked over ``lead`` and scaled by ``1/sqrt(d_in)``.  Each top-level key
  is a stack of layers over its leading axis; the layers run stack by stack
  in the order the layout first names them;
* ``matmul_params_per_layer(cfg)``: each layer's parameters that a token's
  matrix products use, a list over the layers;
* ``mixer_flops_per_token(cfg, seq_len)``: each layer's forward and
  backward operations a token beyond those products (attention's scores,
  the SSD scan's chunk products), a list over the layers;
* ``block(h, lp, cfg, precision)``: one layer of the plain reference on
  ``lp``, the layer's slice of its stack; ``(h, aux)``, ``aux`` the loss
  terms it adds (0.0 where none).

A family file imports nothing of the program and nothing of JAX; its
reference uses the primitives of :mod:`bench.reference.model`.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]


@functools.lru_cache(maxsize=None)
def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"bench_family_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get(name: str, root: pathlib.Path = ROOT):
    """The module ``bench/families/<name>.py`` of the benchmark at ``root``;
    ``ValueError`` naming the files there when it has none."""
    here = pathlib.Path(root) / "bench" / "families"
    path = here / f"{name}.py"
    if not path.is_file():
        have = sorted(p.name for p in here.glob("*.py") if p.name != "__init__.py")
        raise ValueError(f"no model family {name!r}: bench/families has {have}")
    return _load(path.resolve())


def of(cfg: dict):
    """The family of the configuration ``cfg``, in the benchmark it was found
    in (``cfg["bench_root"]``, set by :func:`bench.cells.find`; this one's
    when unset)."""
    return get(cfg["family"], cfg.get("bench_root", ROOT))
