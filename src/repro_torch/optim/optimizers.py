"""SGD and AdamW on nested-dict parameter trees, leaf by leaf.

The port of the JAX package's ``optim/optimizers.py`` with the same
arithmetic.  The JAX optimizers map the whole tree at once; here the unit is
one leaf (``update_leaf``), so the decentralized round can take each leaf's
update, mix, encode and decode before it touches the next leaf and never
holds a whole-tree update temporary.  ``update`` is the tree form.  Moment
buffers are updated in place; the step counter and the scalars derived from
it live on the host, rounded to float32 as JAX rounds them.  AdamW's leaf
update is one kernel on the card (``kernels/adamw.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels.adamw import adamw_update
from repro_torch.trace import span
from repro_torch.tree import leaf_items, tree_from_items, tree_leaves, tree_map


@dataclasses.dataclass
class OptState:
    step: int
    m: Any = None       # momentum / first moment (tree), or None
    v: Any = None       # second moment (tree, adam only), or None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], OptState]
    # (grad, m, v, param, lr, t) -> update; m and v updated in place.
    # ``t`` is the 1-based step this update belongs to.
    update_leaf: Callable[..., torch.Tensor]

    def update(self, grads: Any, state: OptState, params: Any,
               lr: float) -> Tuple[Any, OptState]:
        """Tree form: ``(updates, state)`` with ``state.step`` advanced."""
        t = state.step + 1
        g_items, p_items = leaf_items(grads), leaf_items(params)
        m_items = leaf_items(state.m) if state.m is not None else [(p, None) for p, _ in g_items]
        v_items = leaf_items(state.v) if state.v is not None else [(p, None) for p, _ in g_items]
        upd = [(path, self.update_leaf(g, m, v, p, lr, t))
               for (path, g), (_, m), (_, v), (_, p) in zip(g_items, m_items, v_items, p_items)]
        state.step = t
        return tree_from_items(upd), state


def sgd(momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        m = tree_map(torch.zeros_like, params) if momentum else None
        return OptState(step=0, m=m)

    def update_leaf(g, m, v, p, lr, t):
        with span("optim.update"):
            if weight_decay:
                g = g + weight_decay * p
            if momentum:
                m.mul_(momentum).add_(g)
                eff = g + momentum * m if nesterov else m
                return -lr * eff
            # JAX's lr is a float32 array, so the update is float32 whatever
            # the gradient's dtype (bf16 params under ECD with bf16 estimates)
            return -lr * g.to(torch.float32)

    return Optimizer("sgd", init, update_leaf)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return OptState(step=0, m=tree_map(torch.zeros_like, params),
                        v=tree_map(torch.zeros_like, params))

    def update_leaf(g, m, v, p, lr, t):
        # one kernel a leaf on the card, the eager body on the CPU
        with span("optim.update"):
            return adamw_update(g, m, v, p, b1=b1, b2=b2, eps=eps,
                                weight_decay=weight_decay, lr=lr, t=t)

    return Optimizer("adamw", init, update_leaf)


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum, over the leaves in flatten order, of each leaf's
    float32 sum of squares (a 0-d float32 tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``."""
    n = global_norm(grads)
    scale = torch.clamp(torch.full_like(n, max_norm) / (n + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), n


def make_optimizer(name: str, **kw) -> Optimizer:
    makers: dict = {"sgd": sgd, "adamw": adamw}
    if name not in makers:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(makers)}")
    return makers[name](**kw)
