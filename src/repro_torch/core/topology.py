"""Mixing matrices ``W`` and their spectral constants (numpy only).

The port's copy of the JAX package's ``core/topology.py``: ring, chain,
fully connected, star and 2-D torus graphs, Metropolis-Hastings weights and
the name registry of :func:`make_topology`;
Assumption 1.2-1.3 of the paper — ``W`` symmetric doubly stochastic with
spectral gap ``1 - rho > 0``, ``rho = max(|lambda_2|, |lambda_n|)``, and
``mu = max_{i>=2} |lambda_i - 1|`` for DCD-PSGD's compression budget.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def ring(n: int) -> np.ndarray:
    """Uniform-weight ring: self + two neighbors at 1/3 (the paper's setup)."""
    if n == 1:
        return np.ones((1, 1))
    if n == 2:
        return np.full((2, 2), 0.5)
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] = 1.0 / 3
        W[i, (i - 1) % n] = 1.0 / 3
        W[i, (i + 1) % n] = 1.0 / 3
    return W


def chain(n: int) -> np.ndarray:
    """Path graph with Metropolis-Hastings weights."""
    A = np.zeros((n, n), dtype=bool)
    for i in range(n - 1):
        A[i, i + 1] = A[i + 1, i] = True
    return metropolis(A)


def fully_connected(n: int) -> np.ndarray:
    return np.full((n, n), 1.0 / n)


def star(n: int) -> np.ndarray:
    """Hub-and-spoke with Metropolis-Hastings weights."""
    A = np.zeros((n, n), dtype=bool)
    A[0, 1:] = A[1:, 0] = True
    return metropolis(A)


def torus2d(rows: int, cols: int) -> np.ndarray:
    """2-D torus: self + 4 neighbors at 1/5 (duplicates collapse on small dims)."""
    n = rows * cols
    W = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            nbrs = {
                ((r - 1) % rows) * cols + c,
                ((r + 1) % rows) * cols + c,
                r * cols + (c - 1) % cols,
                r * cols + (c + 1) % cols,
            }
            nbrs.discard(i)
            w = 1.0 / (len(nbrs) + 1)
            W[i, i] = w
            for j in nbrs:
                W[i, j] += w
            W[i] /= W[i].sum()
    # symmetrize (duplicates can break symmetry on degenerate sizes)
    W = (W + W.T) / 2
    W /= W.sum(axis=1, keepdims=True)
    return W


def metropolis(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights for an undirected adjacency matrix."""
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if adj[i, j]:
                W[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


@dataclasses.dataclass(frozen=True)
class SpectralInfo:
    rho: float           # max(|lambda_2|, |lambda_n|)  — Assumption 1.3
    mu: float            # max_{i>=2} |lambda_i - 1|    — Theorem 1
    spectral_gap: float  # 1 - rho

    def dcd_alpha_max(self) -> float:
        """Largest compression alpha DCD-PSGD tolerates: (1-rho)/(2 mu)."""
        if self.mu == 0:
            return np.inf
        return self.spectral_gap / (2.0 * self.mu)


def spectral_info(W: np.ndarray) -> SpectralInfo:
    lam = np.linalg.eigvalsh(W)[::-1]  # descending
    if not np.isclose(lam[0], 1.0, atol=1e-8):
        raise ValueError(f"W not stochastic: lam1={lam[0]}")
    rho = float(max(abs(lam[1]), abs(lam[-1]))) if len(lam) > 1 else 0.0
    mu = float(np.max(np.abs(lam[1:] - 1.0))) if len(lam) > 1 else 0.0
    return SpectralInfo(rho=rho, mu=mu, spectral_gap=1.0 - rho)


def check_mixing_matrix(W: np.ndarray, atol: float = 1e-8) -> None:
    """Validate Assumption 1.2/1.3; raises ValueError on violation."""
    if not np.allclose(W, W.T, atol=atol):
        raise ValueError("W must be symmetric")
    if not np.allclose(W.sum(axis=1), 1.0, atol=atol):
        raise ValueError("rows must sum to 1")
    if not np.allclose(W.sum(axis=0), 1.0, atol=atol):
        raise ValueError("cols must sum to 1")
    if not (W >= -atol).all():
        raise ValueError("W must be nonnegative")
    if W.shape[0] > 1 and spectral_info(W).rho >= 1.0 - 1e-12:
        raise ValueError("graph must be connected")


TOPOLOGIES = {
    "ring": ring,
    "chain": chain,
    "full": fully_connected,
    "star": star,
}


def make_topology(name: str, n: int) -> np.ndarray:
    """``W`` of a registered topology; ``torus*`` is the most nearly square
    2-D torus on ``n`` nodes."""
    if name.startswith("torus"):
        r = int(np.floor(np.sqrt(n)))
        while n % r:
            r -= 1
        return torus2d(r, n // r)
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; registered: {sorted(TOPOLOGIES)} "
                         f"and torus")
    return TOPOLOGIES[name](n)
