"""Carry parameters between the JAX package and the port.

``params_from_jax`` takes the JAX package's parameter tree with its leaves
as numpy arrays (the caller converts them; this module imports no JAX) and
returns the port's nested dict of float32 tensors with the same keys.
``leaf_paths`` gives the port's leaf order, which is JAX's flatten order —
the order the wire seeds leaves by.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.tree import leaf_items, tree_map


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device),
                    tree_of_numpy)


def leaf_paths(params: Any) -> List[str]:
    return [path for path, _ in leaf_items(params)]
