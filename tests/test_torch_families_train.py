"""A two-step DCD ``quant:8`` run of every family but granite-3-2b through
``run_training`` at its ``reduced()`` width on 4 nodes: finite losses,
every replica exactly ``roll(X, s)``, and the state's leaf paths those of
the JAX package's tree.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild
from repro_torch.configs import ARCH_IDS, get_config as tget_config
from repro_torch.convert import leaf_paths
from repro_torch.launch.train import TrainConfig, run_training
from repro_torch.tree import tree_leaves
from test_torch_families import jax_paths, one_torch_thread  # noqa: F401


NEW_FAMILIES = [a for a in ARCH_IDS if a != "granite-3-2b"]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_two_step_dcd_run_through_run_training(arch):
    cfg = tget_config(arch).reduced()
    tc = TrainConfig(arch=arch, algo="dcd", wire="quant:8", n_nodes=4, steps=2, seq_len=16,
                     global_batch=8, log_every=1)
    hist = run_training(cfg, tc, device="cpu")
    assert len(hist["losses"]) == 2 and all(np.isfinite(hist["losses"]))
    state = hist["state"]
    reps = [k for k in state.aux if k.startswith("rep")]
    assert reps
    for key in reps:
        s = int(key[3:])
        for r, x in zip(tree_leaves(state.aux[key]), tree_leaves(state.params)):
            assert torch.equal(r, torch.roll(x, s, 0)), key
    assert leaf_paths(state.params) == jax_paths(jax.eval_shape(
        jbuild(jget_config(arch).reduced()).init, jax.random.key(0)))
