"""The paper's algorithms in their stacked form (the port of the JAX
package's ``core/algorithms.py``).

Every local model lives in a tree whose leaves carry a leading node axis
``n``: ``X[i] = x^{(i)}``, and gossip ``X W`` is a tensordot with the small
mixing matrix.  Steps:

* ``cpsgd``  — centralized AllReduce SGD (paper §5 "Centralized").
* ``dpsgd``  — full-precision D-PSGD: ``X_{t+1} = X_t W - lr G``.
* ``naive``  — D-PSGD over naively compressed models (Supp. D; must fail).
* ``dcd``    — Algorithm 1, difference compression.
* ``ecd``    — Algorithm 2, extrapolation compression.
* ``choco``  — CHOCO-SGD: compressed differences to replica estimates,
  consensus stepsize gamma.
* ``deepsqueeze`` — DeepSqueeze: error-compensated compression of the model
  value.

The math is the JAX package's, but a step walks the leaves in flatten order
and finishes each leaf before the next, updating the state's trees IN PLACE
(the JAX step is pure and builds new trees).  At full width a stacked tree
is gigabytes; the functional form would hold X, G, X_half, Z, C(Z) and
X_new at once, a leaf at a time holds one leaf of each transient.  So
``step(state, grads, key, lr)`` consumes ``state``: it returns the same
object, advanced.

``key`` is an integer step counter (the wire's (step, salt, leaf) seeding,
payloads bit-equal to the JAX package's) or a ``torch.Generator``; see
``core/compression.py``.  ``GossipReference`` (the stacked mirror of the
runtime with drops and schedules) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.compression import Compressor, IdentityCompressor
from repro_torch.tree import leaf_items, tree_leaves, tree_map


def _mix_leaf(W: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``sum_j W_ij x_j`` over the node axis of one stacked leaf (a new tensor)."""
    w = torch.as_tensor(np.asarray(W, dtype=np.float32), device=leaf.device)
    return torch.tensordot(w, leaf.to(torch.float32), dims=([1], [0])).to(leaf.dtype)


def mix(W, X: Any) -> Any:
    """``(X W^T)_i = sum_j W_ij x_j`` applied leaf-wise over the node axis."""
    return tree_map(lambda leaf: _mix_leaf(W, leaf), X)


@dataclasses.dataclass
class AlgoState:
    params: Any                 # stacked tree (nested dicts or one tensor), leading axis n
    step: int = 1               # starts at 1, as the paper's t
    aux: Any = None             # ecd: estimates X_tilde; choco: X_hat; deepsqueeze: E


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A decentralized training algorithm = init + step over stacked state."""

    name: str
    W: np.ndarray
    compressor: Compressor = IdentityCompressor()
    gamma: float = 0.5          # CHOCO consensus stepsize, valid on (0, 1]

    def __post_init__(self):
        if self.name not in _STEPS:
            raise ValueError(f"algorithms are {ALGORITHMS}, got {self.name!r}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"CHOCO consensus stepsize gamma must be in (0, 1], got "
                             f"{self.gamma}")

    @property
    def n_nodes(self) -> int:
        return self.W.shape[0]

    def init(self, params_single: Any) -> AlgoState:
        """Copy a single model to all ``n`` nodes (paper: x_1^{(i)} = x_1); the
        estimates of ECD and CHOCO start as their own copy of X, DeepSqueeze's
        residual at zero."""
        n = self.n_nodes

        def stack():
            return tree_map(lambda p: p.detach().unsqueeze(0).repeat((n,) + (1,) * p.dim()),
                            params_single)

        X = stack()
        aux = None
        if self.name in ("ecd", "choco"):
            aux = stack()
        elif self.name == "deepsqueeze":
            aux = tree_map(torch.zeros_like, X)
        return AlgoState(params=X, step=1, aux=aux)

    def step_fn(self) -> Callable[[AlgoState, Any, Any, float], AlgoState]:
        fn, W, comp, gamma = _STEPS[self.name], self.W, self.compressor, self.gamma

        def step(state: AlgoState, grads: Any, key: Any, lr: float) -> AlgoState:
            items = leaf_items(state.params)
            aux = tree_leaves(state.aux) if state.aux is not None else [None] * len(items)
            ctx = _Ctx(W=W, comp=comp, key=key, lr=float(np.float32(lr)),
                       gamma=float(np.float32(gamma)), step=state.step)
            with torch.no_grad():
                for li, ((path, x), g, a) in enumerate(zip(items, tree_leaves(grads), aux)):
                    fn(ctx, li, path, x, g.to(x.dtype), a)
            state.step += 1
            return state

        return step


@dataclasses.dataclass(frozen=True)
class _Ctx:
    W: np.ndarray
    comp: Compressor
    key: Any
    lr: float                   # f32 values, as the JAX step's f32 scalars
    gamma: float
    step: int

    def C(self, z: torch.Tensor, li: int, path: str) -> torch.Tensor:
        return self.comp.apply_leaf(self.key, z, li, path)

    def lr_g(self, g: torch.Tensor) -> torch.Tensor:
        return self.lr * g


# --------------------------------------------------------------------------
# Individual algorithm steps: one leaf each, in place
# --------------------------------------------------------------------------

def cpsgd_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """Centralized: every node applies the exact average gradient."""
    x.sub_(c.lr_g(g.mean(dim=0, keepdim=True)))


def dpsgd_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """X_{t+1} = X_t W - lr G."""
    x.copy_(_mix_leaf(c.W, x).sub_(c.lr_g(g)))


def naive_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """X_{t+1} = C(X_t) W - lr G — does NOT converge."""
    x.copy_(_mix_leaf(c.W, c.C(x, li, path)).sub_(c.lr_g(g)))


def dcd_leaf(c: _Ctx, li, path, x, g, aux) -> None:
    """Algorithm 1: X_half = X W - lr G; Z = X_half - X; X_{t+1} = X + C(Z).
    Every replica would advance by the same compressed delta as its true
    model, so the stacked form keeps none."""
    z = _mix_leaf(c.W, x).sub_(c.lr_g(g)).sub_(x)
    x.add_(c.C(z, li, path))


def ecd_leaf(c: _Ctx, li, path, x, g, xt) -> None:
    """Algorithm 2, with ``aux`` the shared estimates X_tilde and ``s = t + 1``:
    X_{t+1} = X_tilde W - lr G; Z = (1 - s/2) X_t + (s/2) X_{t+1};
    X_tilde' = (1 - 2/s) X_tilde + (2/s) C(Z).  The scalars are f32, as in
    the JAX step."""
    s = np.float32(c.step + 1)
    za, zb = float(np.float32(1.0) - np.float32(0.5) * s), float(np.float32(0.5) * s)
    decay = float(np.float32(1.0) - np.float32(2.0) / s)
    blend = float(np.float32(2.0) / s)
    x_new = _mix_leaf(c.W, xt).sub_(c.lr_g(g))
    z = za * x + zb * x_new
    cz = c.C(z, li, path)
    del z
    xt.copy_(decay * xt + blend * cz)
    x.copy_(x_new)


def choco_leaf(c: _Ctx, li, path, x, g, xh) -> None:
    """CHOCO-SGD, ``aux`` the shared estimates X_hat: X_half = X - lr G;
    X_hat' = X_hat + C(X_half - X_hat); X_new = X_half + gamma (X_hat' W - X_hat')."""
    x.sub_(c.lr_g(g))
    xh.add_(c.C(x - xh, li, path))
    m = _mix_leaf(c.W, xh).sub_(xh)
    x.add_(c.gamma * m)


def deepsqueeze_leaf(c: _Ctx, li, path, x, g, e) -> None:
    """DeepSqueeze, ``aux`` the residual E: X_half = X - lr G; V = X_half + E;
    D = C(V); E' = V - D; X_new = X_half + D W - D.  The residual last: an
    identity payload is the V buffer itself."""
    x.sub_(c.lr_g(g))
    e.add_(x)                                       # V
    d = c.C(e, li, path)
    x.add_(_mix_leaf(c.W, d).sub_(d))
    e.sub_(d)


_STEPS = {
    "cpsgd": cpsgd_leaf,
    "dpsgd": dpsgd_leaf,
    "naive": naive_leaf,
    "dcd": dcd_leaf,
    "ecd": ecd_leaf,
    "choco": choco_leaf,
    "deepsqueeze": deepsqueeze_leaf,
}

ALGORITHMS = tuple(_STEPS)


def make_algorithm(name: str, n_nodes: int, topology: str = "ring",
                   compressor: Optional[Compressor] = None, gamma: float = 0.5) -> Algorithm:
    """An :class:`Algorithm` on the named topology's mixing matrix."""
    W = topo.make_topology(topology, n_nodes)
    topo.check_mixing_matrix(W)
    return Algorithm(name=name, W=W, compressor=compressor or IdentityCompressor(),
                     gamma=gamma)


# --------------------------------------------------------------------------
# Diagnostics
# --------------------------------------------------------------------------

def consensus_distance(X: Any) -> torch.Tensor:
    """``sum_i ||x_i - x_bar||²``, the quantity bounded by (27)/(36) in the paper."""
    return sum(torch.sum((leaf - leaf.mean(dim=0, keepdim=True)) ** 2)
               for leaf in tree_leaves(X))


def average_model(X: Any) -> Any:
    """The paper's output: ``(1/n) sum_i x_T^{(i)}``."""
    return tree_map(lambda leaf: leaf.mean(dim=0), X)
