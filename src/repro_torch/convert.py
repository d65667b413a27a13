"""Carry parameters between the JAX package and the port.

``params_from_jax`` takes the JAX package's parameter tree with its leaves
as numpy arrays (the caller converts them; this module imports no JAX) and
returns the port's nested dict of float32 tensors with the same keys.
``leaf_paths`` gives the port's leaf order, which is JAX's flatten order —
the order the wire seeds leaves by.  ``algo_state_from_jax`` carries a
stacked-reference ``AlgoState`` the same way, so that both packages step
from the same state.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.core.algorithms import AlgoState
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


def leaf_paths(params: Any) -> List[str]:
    return [path for path, _ in leaf_items(params)]
