"""Quickstart: compressed decentralized training (the paper's Fig. 1).

Trains 8 decentralized nodes on a convex problem with a known optimum and
shows that DCD-PSGD and ECD-PSGD with 8-bit stochastic quantization on the
wire converge to the global optimum like full precision, while naive
compression of the exchanged models stalls.  The sizes of the JAX package's
``examples/quickstart.py``: n 8, m 256, d 32, ``RandomQuantizer(bits=8,
block_size=32)``, T 800, lr 0.02.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.core import RandomQuantizer, make_algorithm
from repro_torch.core.testbed import LeastSquares, make_problem, run

N, T, LR = 8, 800, 0.02

# (row label, algorithm, bits of the RandomQuantizer or None)
FIG1 = (("cpsgd (AllReduce baseline)", "cpsgd", None),
        ("dpsgd (full-precision gossip)", "dpsgd", None),
        ("dcd   (8-bit difference compression)", "dcd", 8),
        ("ecd   (8-bit extrapolation compression)", "ecd", 8),
        ("naive (8-bit models on the wire)", "naive", 8))


def fig1_problem(device="cuda") -> LeastSquares:
    return make_problem(torch.Generator().manual_seed(0), n=N, m=256, d=32, hetero=0.2,
                        noise=0.1, device=device)


def run_row(problem: LeastSquares, algo: str, bits=None, T: int = T,
            eval_every: int = 400) -> Dict:
    """One row of the table: ``algo`` on the ring, ``RandomQuantizer(bits,
    block_size=32)`` on the wire when ``bits`` is given."""
    comp = RandomQuantizer(bits=bits, block_size=32) if bits else None
    return run(problem, make_algorithm(algo, N, "ring", comp), T=T, lr=LR,
               eval_every=eval_every)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = fig1_problem(args.device)
    print(f"global optimum loss: {float(problem.global_loss(problem.optimum())):.4f}\n")
    for label, algo, bits in FIG1:
        hist = run_row(problem, algo, bits)
        print(f"{label:42s} final_loss={hist['final_loss']:.4f} "
              f"dist_to_opt={hist['final_dist_opt']:.2e}")
    print("\nDCD/ECD match full precision; naive compression stalls (paper Fig. 1).")


if __name__ == "__main__":
    main()
