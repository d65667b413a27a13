"""Mixing matrices ``W`` and their spectral constants (numpy only).

The port's copy of the ring slice of the JAX package's ``core/topology.py``:
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
