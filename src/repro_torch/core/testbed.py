"""Convex testbed with a known optimum (the port of the JAX package's
``core/testbed.py``).

Distributed least squares: ``f_i(x) = ||A_i x - b_i||² / (2 m)`` on
node-local data ``(A_i, b_i)``; the optimum of ``f = (1/n) sum_i f_i`` is
``x* = (sum A_i^T A_i)^{-1} (sum A_i^T b_i)``.  Stochastic gradients sample
rows, so the gradient variance sigma² is controlled and the data are
heterogeneous across nodes (zeta² > 0), Assumption 1.4's regime.

Randomness comes from explicit ``torch.Generator``s.  :func:`run` draws the
minibatch rows and the compression seeds from one CPU generator, so a run on
the card sees the same draws as the same run on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.algorithms import Algorithm, average_model, consensus_distance


@dataclasses.dataclass(frozen=True)
class LeastSquares:
    A: torch.Tensor   # (n, m, d) node-local design matrices
    b: torch.Tensor   # (n, m)
    batch: int = 8

    @property
    def n_nodes(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[2]

    def optimum(self) -> torch.Tensor:
        AtA = torch.einsum("nmd,nme->de", self.A, self.A)
        Atb = torch.einsum("nmd,nm->d", self.A, self.b)
        return torch.linalg.solve(AtA, Atb)

    def global_loss(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.einsum("nmd,d->nm", self.A, x) - self.b
        return 0.5 * torch.mean(torch.sum(r ** 2, dim=1) / self.A.shape[1])

    def batch_rows(self, generator: torch.Generator) -> torch.Tensor:
        """(n, batch) row indices drawn uniformly from ``generator``, on A's device."""
        n, m, _ = self.A.shape
        idx = torch.randint(0, m, (n, self.batch), generator=generator,
                            device=generator.device)
        return idx.to(self.A.device)

    def stoch_grads(self, generator: Optional[torch.Generator], X: torch.Tensor, *,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Minibatch gradient per node; X stacked (n, d).  The rows are
        ``idx`` when given, else drawn from ``generator``."""
        if idx is None:
            idx = self.batch_rows(generator)
        Ab = torch.gather(self.A, 1, idx[:, :, None].expand(-1, -1, self.dim))  # (n, batch, d)
        bb = torch.gather(self.b, 1, idx)                                       # (n, batch)
        r = torch.einsum("nbd,nd->nb", Ab, X) - bb
        return torch.einsum("nb,nbd->nd", r, Ab) / self.batch


def make_problem(generator: torch.Generator, n: int = 8, m: int = 256, d: int = 32,
                 hetero: float = 1.0, noise: float = 0.1, batch: int = 8,
                 device="cuda") -> LeastSquares:
    """``hetero`` scales the per-node distribution shift (zeta), ``noise`` the
    label noise.  Drawn on the generator's device, then moved to ``device``."""
    g = dict(generator=generator, device=generator.device)
    A = torch.randn((n, m, d), **g)
    A = A + hetero * torch.randn((n, 1, d), **g)                  # node-specific shift
    x_true = torch.randn((d,), **g)
    b = torch.einsum("nmd,d->nm", A, x_true) + noise * torch.randn((n, m), **g)
    return LeastSquares(A=A.to(device), b=b.to(device), batch=batch)


def run(problem: LeastSquares, algo: Algorithm, T: int, lr: float, seed: int = 0,
        eval_every: int = 10) -> dict:
    """Run T steps on the problem's device; return the loss, consensus and
    distance-to-optimum trajectories.  Each step draws its minibatch rows,
    then the compression seeds, from one CPU generator seeded with ``seed``."""
    if algo.n_nodes != problem.n_nodes:
        raise ValueError(f"{algo.n_nodes} nodes for a {problem.n_nodes}-node problem")
    gen = torch.Generator().manual_seed(seed)
    state = algo.init(torch.zeros((problem.dim,), device=problem.A.device))
    step = algo.step_fn()
    xstar = problem.optimum()
    hist = {"step": [], "loss": [], "consensus": [], "dist_opt": []}
    for t in range(T):
        grads = problem.stoch_grads(gen, state.params)
        state = step(state, grads, gen, lr)
        if (t + 1) % eval_every == 0 or t == T - 1:
            xbar = average_model(state.params)
            hist["step"].append(t + 1)
            hist["loss"].append(float(problem.global_loss(xbar)))
            hist["consensus"].append(float(consensus_distance(state.params)))
            hist["dist_opt"].append(float(torch.sum((xbar - xstar) ** 2)))
    hist["final_loss"] = hist["loss"][-1]
    hist["final_dist_opt"] = hist["dist_opt"][-1]
    hist["opt_loss"] = float(problem.global_loss(xstar))
    return hist
