"""Carry parameters between the JAX package and the port.

``params_from_jax`` takes the JAX package's parameter tree with its leaves
as numpy arrays (the caller converts them; this module imports no JAX) and
returns the port's nested dict of float32 tensors with the same keys.
``leaf_paths`` gives the port's leaf order, which is JAX's flatten order —
the order the wire seeds leaves by.  ``algo_state_from_jax`` carries a
stacked-reference ``AlgoState`` the same way, and ``dist_state_from_jax``
the runtime's ``DistState``, so that both packages step from the same state.
``cache_from_jax`` carries the decode caches, so that one decode step of
each package can be held against the other.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.algorithms import AlgoState
from repro_torch.distributed.decentralized import DistState
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.encdec import CrossCache
from repro_torch.models.ssm import SSMCache
from repro_torch.optim.optimizers import OptState
from repro_torch.tree import leaf_items, tree_map


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device),
                    tree_of_numpy)


def algo_state_from_jax(state: Any, device="cuda") -> AlgoState:
    """The JAX package's ``AlgoState`` with its leaves as numpy arrays (a
    nested dict or one array as ``params`` and ``aux``, ``aux`` possibly
    None; ``step`` a 0-d array) -> the port's ``AlgoState``, every leaf its
    own float32 copy on ``device``."""
    aux = None if state.aux is None else params_from_jax(state.aux, device)
    return AlgoState(params=params_from_jax(state.params, device),
                     step=int(np.asarray(state.step)), aux=aux)


def _tensor(a: Any, device) -> torch.Tensor:
    """A numpy leaf as its own tensor of the same dtype; ``bfloat16`` (an
    ``ml_dtypes`` array) through its raw bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def dist_state_from_jax(state: Any, device="cuda", node: Optional[int] = None) -> DistState:
    """The JAX runtime's ``DistState`` with its leaves as numpy arrays
    (params, the optimizer's ``OptState``, the aux trees with freshness
    vectors and codec state, the step) -> the port's ``DistState``.  Every
    leaf keeps its dtype and becomes its own tensor on ``device``, but the
    freshness vectors, which the port keeps on the host.  ``node``: the
    state of that node's rank, every stacked leaf cut to its rows
    ``node:node+1`` (the freshness vectors stay whole)."""
    rows = slice(None) if node is None else slice(node, node + 1)

    def tree(t):
        return None if t is None else tree_map(lambda a: _tensor(np.asarray(a)[rows], device), t)

    aux = {k: (_tensor(v, "cpu") if k.startswith("fresh") else tree(v))
           for k, v in state.aux.items()}
    opt = OptState(step=int(np.asarray(state.opt.step)), m=tree(state.opt.m),
                   v=tree(state.opt.v))
    return DistState(params=tree(state.params), opt=opt, aux=aux,
                     step=int(np.asarray(state.step)))


def leaf_paths(params: Any) -> List[str]:
    return [path for path, _ in leaf_items(params)]


def _cache_pos(pos: Any) -> int:
    """A stacked JAX position (one int32 a layer) -> the port's one host
    integer; every layer of a cache has the same position."""
    pos = np.asarray(pos)
    if pos.size and not (pos == pos.flat[0]).all():
        raise ValueError(f"layers of one cache at different positions: {pos}")
    return int(pos.flat[0]) if pos.size else 0


def cache_from_jax(caches: Any, device="cuda") -> Any:
    """The JAX package's decode caches with their leaves as numpy arrays (a
    dict of ``KVCache``, ``MLACache``, ``SSMCache`` or ``CrossCache``, each
    leaf stacked on the layer axes) -> the port's, every tensor its own copy
    on ``device`` with its dtype (bf16 through its raw bits)."""
    if isinstance(caches, dict):
        return {k: cache_from_jax(v, device) for k, v in caches.items()}
    fields = set(getattr(caches, "_fields", ())) or set(vars(caches))
    if {"c_kv", "k_rope"} <= fields:
        return MLACache(c_kv=_tensor(caches.c_kv, device), k_rope=_tensor(caches.k_rope, device),
                        pos=_cache_pos(caches.pos))
    if {"h", "conv"} <= fields:
        return SSMCache(h=_tensor(caches.h, device), conv=_tensor(caches.conv, device),
                        pos=_cache_pos(caches.pos))
    if "pos" in fields:
        return KVCache(k=_tensor(caches.k, device), v=_tensor(caches.v, device),
                       pos=_cache_pos(caches.pos), window=caches.window)
    return CrossCache(k=_tensor(caches.k, device), v=_tensor(caches.v, device))
