"""Nested-dict parameter trees in the JAX package's flatten order.

Parameters are nested ``dict``s of tensors keyed exactly like the JAX tree.
JAX flattens a dict by sorted key, recursively; the wire seeds every leaf by
its index in that order (``leaf_seed(step, salt, leaf_index)``), so every
tree walk in the port goes through :func:`leaf_items`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def leaf_items(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in JAX flatten order (sorted keys, depth first);
    paths are ``/``-joined keys, e.g. ``blocks/attn/wk``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out.extend(leaf_items(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaf_items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def unstack(tree: Any) -> List[Any]:
    """The slices of a stacked tree along its leading axis (a model's layers,
    the gossip nodes' parameters), each leaf split by one ``torch.unbind``.
    In the backward pass autograd then stacks the slices' gradients once a
    leaf, where indexing each slice (``leaf[i]``) would write a zero tensor of
    the whole leaf for every slice and add them up: O(n^2) bytes for n
    slices."""
    cols = tree_map(lambda l: torch.unbind(l, 0), tree)
    return [tree_map(lambda c: c[i], cols) for i in range(len(tree_leaves(cols)[0]))]


def tree_from_items(items: List[Tuple[str, Any]]) -> Dict[str, Any]:
    """Inverse of :func:`leaf_items`."""
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out
