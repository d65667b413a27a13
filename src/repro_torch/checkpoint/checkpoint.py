"""Checkpoints of state trees: ``.npz`` plus a JSON manifest.

The port of the JAX package's ``checkpoint/checkpoint.py``, in the same
format, so that either package restores the other's files.  A tree
(nested dicts, dataclasses such as ``DistState`` and ``OptState``, tensors,
and Python ints such as the step counters) flattens to ``/``-joined path
keys as JAX's ``tree_flatten_with_path`` names them: a dict key as itself, a
dataclass field as ``.name`` (JAX's attribute key), e.g. ``.params/blocks/wq``,
``.opt/.step``, ``.aux/rep+1/embed``, ``.aux/fresh+1@drop0``.  ``None``
holds no leaf.  A Python int is stored as a 0-d int32 array, as JAX holds
its step counters.

Every leaf is stored as a numpy array with its dtype's name in the
manifest; a dtype numpy lacks (``bfloat16``, the float8 types) is stored as
a raw-bit view of the same width and restored through ``Tensor.view``, so
neither side needs ``ml_dtypes``.  Writes go to temporary names and are
renamed into place, so a crashed save leaves the last checkpoint whole; the
last ``keep`` checkpoints of a directory are kept.

Restore is driven by the template ``like``: each leaf is read under the
template's key, checked for shape, cast to the template's dtype and put on
the template leaf's device.

Across ranks (one process a gossip node, each holding its node's slice with
a node axis of 1): ``save(..., group=)`` is called by every rank, and rank 0
gathers every node-stacked leaf in rank order and writes the file the
stacked mode writes; ``restore(..., node=i)`` reads that file into rank
``i``'s template, keeping rows ``i``.  Every tensor is node-stacked but the
freshness vectors (``.aux/fresh...``), host (n,) vectors every rank holds
whole.  State whose key encodes its configuration
fails loudly on a mismatch: a ``wire_lowrank:<r>`` codec state at another
rank, or a freshness vector ``fresh{s}@drop{salt}`` under another drop
salt, raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# dtypes numpy lacks, by width: the unsigned numpy type their bits are
# stored as, and the signed type that carries them into torch
_RAW_BITS = {1: (np.uint8, np.uint8), 2: (np.uint16, np.int16), 4: (np.uint32, np.int32)}
# dtypes stored as themselves
_NUMPY_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.float16, torch.float32, torch.float64)


def _items(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``[(key, leaf), ...]`` of a tree, keys as JAX's ``_path_str`` joins
    them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _items(tree[k], prefix + (str(k),))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _items(getattr(tree, f.name), prefix + (f".{f.name}",))]
    return [("/".join(prefix), tree)]


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return "int32"


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, dtype=np.int32)
    t = leaf.detach().cpu()
    if t.dtype in _NUMPY_DTYPES:
        return t.numpy()
    stored, carrier = _RAW_BITS[t.element_size()]
    return t.view(getattr(torch, np.dtype(carrier).name)).numpy().view(stored)


def _from_numpy(arr: np.ndarray, stored: Optional[str], like: Any) -> Any:
    if not isinstance(like, torch.Tensor):
        return int(arr)
    if stored and stored != str(arr.dtype):
        # raw-bit view back to the stored dtype (e.g. bfloat16)
        _, carrier = _RAW_BITS[arr.dtype.itemsize]
        t = torch.from_numpy(arr.view(carrier)).view(getattr(torch, stored))
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _rebuild(tree: Any, values: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Any:
    """``tree`` with each leaf replaced by ``values[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), values, prefix + (f".{f.name}",))
            for f in dataclasses.fields(tree) if f.init})
    return values["/".join(prefix)]


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")


def _node_stacked(key: str, leaf: Any) -> bool:
    """A tensor leaf with one row a node (all but the freshness vectors)."""
    return isinstance(leaf, torch.Tensor) and not key.startswith(".aux/fresh")


def save(ckpt_dir: str, step: int, tree: Any, metadata: Optional[dict] = None,
         keep: int = 3, group=None) -> Optional[str]:
    """Write ``tree`` as checkpoint ``step`` of ``ckpt_dir``; returns its path.
    With ``group`` (a :class:`~repro_torch.launch.mesh.NodeGroup`) every rank
    calls it with its own slice: rank 0 gathers and writes, returning the
    path, and every rank returns once the file is written (the others with
    None)."""
    items = _items(tree)
    if group is not None:
        from repro_torch.distributed.transport import RankTransport

        tp = RankTransport(group)
        items = [(k, tp.gather_to_root(v) if _node_stacked(k, v) else v) for k, v in items]
        path = _write(ckpt_dir, step, items, metadata, keep) if group.rank == 0 else None
        group.barrier()
        return path
    return _write(ckpt_dir, step, items, metadata, keep)


def _write(ckpt_dir: str, step: int, items, metadata: Optional[dict], keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat, dtypes = {}, {}
    for key, leaf in items:
        flat[key] = _to_numpy(leaf)
        dtypes[key] = _dtype_name(leaf)
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    manifest = {"step": step, "keys": sorted(flat), "dtypes": dtypes,
                "metadata": metadata or {}}
    with open(path + ".json.tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    os.replace(path + ".json.tmp", path + ".json")
    _gc(ckpt_dir, keep)
    return path


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            node: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (shape-checked); returns
    ``(tree, manifest)``.  ``node``: ``like`` is that rank's slice, and each
    node-stacked leaf of the file gives its rows ``node``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _path(ckpt_dir, step)
    with open(path + ".json") as f:
        manifest = json.load(f)
    values = {}
    with np.load(path) as data:
        for key, leaf in _items(like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if node is not None and _node_stacked(key, leaf):
                arr = arr[node:node + 1]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: shape {arr.shape} != expected {shape}")
            values[key] = _from_numpy(arr, manifest.get("dtypes", {}).get(key), leaf)
    return _rebuild(like, values), manifest


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in _steps(ckpt_dir)[:-keep] if keep else []:
        for suffix in (".npz", ".npz.json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"ckpt_{s:08d}{suffix}"))
            except FileNotFoundError:
                pass
