"""Block remat (``Model.loss(..., remat=True)``) on every family, on the CPU.

For each of the ten architectures at its ``reduced()`` width, from the JAX
``init`` carried over by ``params_from_jax`` and one numpy batch:

* the port's loss, metrics and every gradient leaf with ``remat=True`` are
  bit-equal to ``remat=False``: ``torch.utils.checkpoint`` recomputes each
  block's forward with the same arithmetic in the backward pass;
* the port's ``remat=True`` loss equals the JAX package's ``remat=True``
  loss (``jax.checkpoint`` around each scanned block) at the bf16
  tolerance of ``test_torch_families.py``: 2e-3 absolute (both packages
  run bf16 matmuls with float32 weights and round in different places).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.tree import leaf_items, tree_leaves
from test_torch_families import np_batch, one_torch_thread, pair, to_jax, to_torch  # noqa: F401

LOSS_ATOL = 2e-3


def _port_loss_and_grads(tmodel, tparams, batch, remat: bool):
    params = {k: v for k, v in tparams.items()}
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.grad = None
        leaf.requires_grad_(True)
    loss, met = tmodel.loss(params, batch, remat=remat)
    loss.backward()
    grads = [(p, l.grad.clone()) for p, l in leaf_items(params)]
    for leaf in leaves:
        leaf.grad = None
    return loss.detach(), {k: v.detach() for k, v in met.items()}, grads


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_is_bit_equal_and_matches_jax_remat(arch):
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair(arch)
    batch = np_batch(jcfg, 2, 32)
    plain = _port_loss_and_grads(tmodel, tparams, to_torch(batch), remat=False)
    remat = _port_loss_and_grads(tmodel, tparams, to_torch(batch), remat=True)
    assert torch.equal(plain[0], remat[0]), arch
    assert sorted(plain[1]) == sorted(remat[1])
    for k in plain[1]:
        assert torch.equal(plain[1][k], remat[1][k]), (arch, k)
    for (p, g0), (_, g1) in zip(plain[2], remat[2]):
        assert torch.equal(g0, g1), (arch, p)
    jloss, _ = jax.jit(lambda p, b: jmodel.loss(p, b, remat=True))(jparams, to_jax(batch))
    np.testing.assert_allclose(remat[0].item(), float(jloss), rtol=0, atol=LOSS_ATOL,
                               err_msg=arch)


def test_remat_checkpoints_each_block():
    """With ``remat`` the forward keeps only each block's input for the
    backward pass: fewer saved activations than without."""
    _, tcfg, _, tmodel, _, tparams = pair("granite-3-2b")
    batch = to_torch(np_batch(tcfg, 2, 32))
    saved = {}
    for remat in (False, True):
        count = [0]

        def pack(t, count=count):
            count[0] += t.numel()
            return t

        for leaf in tree_leaves(tparams):
            leaf.requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = tmodel.loss(tparams, batch, remat=remat)
        saved[remat] = count[0]
        del loss
    assert saved[True] < saved[False], saved
