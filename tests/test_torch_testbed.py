"""The port's convex testbed (``repro_torch.core.testbed``) and the Fig. 1
quickstart, held against the JAX package on the CPU.

The problem data are the JAX package's (``make_problem(key(0))``, the
problem of tests/test_algorithms.py) handed over as numpy arrays, so the
optimum, the loss and the minibatch gradients are compared on the same data
and the same rows.  The convergence claims are the JAX tests' thresholds,
met by the port's own ``run`` (its own random draws).
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import testbed as jt
from repro_torch.core import RandomQuantizer, make_algorithm
from repro_torch.core import testbed as tt

N, LR, T = 8, 0.02, 800


@pytest.fixture(scope="module")
def problems():
    jp = jt.make_problem(jax.random.key(0), n=N, m=256, d=32, hetero=0.2, noise=0.1, batch=8)
    tp = tt.LeastSquares(A=torch.from_numpy(np.array(jp.A)),
                         b=torch.from_numpy(np.array(jp.b)), batch=8)
    return jp, tp


def test_optimum_loss_and_gradients_match_jax(problems):
    jp, tp = problems
    np.testing.assert_allclose(tp.optimum().numpy(), np.asarray(jp.optimum()), rtol=1e-4,
                               atol=1e-5)
    x = np.random.default_rng(0).standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(float(tp.global_loss(torch.from_numpy(x))),
                               float(jp.global_loss(jnp.asarray(x))), rtol=1e-5)
    X = np.random.default_rng(1).standard_normal((N, 32)).astype(np.float32)
    key = jax.random.key(7)
    idx = np.array(jax.random.randint(key, (N, 8), 0, 256))       # the rows JAX draws
    np.testing.assert_allclose(
        tp.stoch_grads(None, torch.from_numpy(X), idx=torch.from_numpy(idx)).numpy(),
        np.asarray(jp.stoch_grads(key, jnp.asarray(X))), rtol=1e-5, atol=1e-5)
    rows = tp.batch_rows(torch.Generator().manual_seed(3))
    assert rows.shape == (N, 8) and int(rows.min()) >= 0 and int(rows.max()) < 256


def test_make_problem_is_seeded_and_shaped():
    a = tt.make_problem(torch.Generator().manual_seed(5), n=4, m=16, d=3, device="cpu")
    b = tt.make_problem(torch.Generator().manual_seed(5), n=4, m=16, d=3, device="cpu")
    assert a.A.shape == (4, 16, 3) and a.b.shape == (4, 16) and a.dim == 3 and a.n_nodes == 4
    assert torch.equal(a.A, b.A) and torch.equal(a.b, b.b)


def _run(problem, name, comp=None):
    return tt.run(problem, make_algorithm(name, N, "ring", comp), T=T, lr=LR,
                  eval_every=T // 4)


def test_fig1_thresholds_on_the_cpu(problems):
    """The JAX tests' claims (tests/test_algorithms.py): D-PSGD and 8-bit DCD
    reach the optimum, 8-bit ECD within 1.5x its loss, and naive compression
    at 4 bits stalls more than 10x farther away than DCD at 4 bits."""
    _, p = problems
    for name in ("dpsgd", "dcd"):
        h = _run(p, name, RandomQuantizer(bits=8, block_size=32) if name == "dcd" else None)
        assert h["final_loss"] < 1.2 * h["opt_loss"] + 1e-3, name
        assert h["final_dist_opt"] < 1e-2, name
    h = _run(p, "ecd", RandomQuantizer(bits=8, block_size=32))
    assert h["final_loss"] < 1.5 * h["opt_loss"] + 5e-3
    naive = _run(p, "naive", RandomQuantizer(bits=4, block_size=32))
    dcd = _run(p, "dcd", RandomQuantizer(bits=4, block_size=32))
    assert naive["final_dist_opt"] > 10 * dcd["final_dist_opt"]
    assert naive["final_loss"] > 5 * dcd["final_loss"]
    assert h["step"] == [200, 400, 600, 800]


def test_quickstart_runs_on_the_cpu():
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart",
                          "--device", "cpu"], capture_output=True, text=True, check=True,
                         timeout=300, env=env)
    lines = [l for l in out.stdout.splitlines() if "final_loss=" in l]
    assert [l.split()[0] for l in lines] == ["cpsgd", "dpsgd", "dcd", "ecd", "naive"]
