"""The port's dense decoder against the JAX package's, on the CPU.

Weights come from the JAX ``lm_init`` through ``params_from_jax``; the batch
is made with numpy.  Both run bf16 matmuls with float32 master weights, but
round in different places (XLA fuses, torch rounds every op), so loss and
gradients are held to a bf16 tolerance: loss to 2e-3 absolute (measured
6e-5 on a ~6.3 loss), each gradient leaf to 3% of its largest entry
(measured at most 1.5%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import leaf_paths, params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model
from repro_torch.tree import leaf_items


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(k.key for k in path) for path, _ in flat]


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("granite-3-2b").reduced()
    tcfg = tget_config("granite-3-2b").reduced()
    jparams = jlm.lm_init(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    B, S = 2, 32
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    return jcfg, tcfg, jparams, tparams, batch


def test_config_copy_matches_jax():
    for make in (lambda c: c, lambda c: c.reduced()):
        j, t = make(jget_config("granite-3-2b")), make(tget_config("granite-3-2b"))
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        # the port's own fields (a layer pattern, attention without rope) at
        # the defaults that keep JAX's behaviour
        assert {f.name for f in dataclasses.fields(t)} - {f.name for f in dataclasses.fields(j)} \
            == {"layer_pattern", "rope"}
        assert (t.layer_pattern, t.rope) == ("", True)
        assert (t.vocab_padded, t.hd) == (j.vocab_padded, j.hd)


def test_leaf_order_and_shapes_match_jax(setup):
    jcfg, tcfg, jparams, tparams, _ = setup
    assert leaf_paths(tparams) == _jax_paths(jparams) == [
        "blocks/attn/wk", "blocks/attn/wo", "blocks/attn/wq", "blocks/attn/wv",
        "blocks/ffn/wg", "blocks/ffn/wi", "blocks/ffn/wo", "blocks/ln1", "blocks/ln2",
        "embed", "final_ln", "lm_head"]
    own = tlm.lm_init(tcfg, 0, device="cpu")       # the port's own init: same keys and shapes
    assert leaf_paths(own) == leaf_paths(tparams)
    for (p, a), (_, b) in zip(leaf_items(own), leaf_items(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, p


def test_loss_and_grads_match_jax(setup):
    jcfg, tcfg, jparams, tparams, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(jcfg, p, jb), has_aux=True)(jparams)

    model = build_model(tcfg)
    for leaf in (l for _, l in leaf_items(tparams)):
        leaf.requires_grad_(True)
    tloss, metrics = model.loss(tparams, {k: torch.from_numpy(v.astype(np.int64))
                                          for k, v in batch.items()})
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 2e-3
    assert metrics["xent"].item() == tloss.item()
    for (path, p), jg in zip(leaf_items(tparams), jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(p.grad.numpy(), jg, rtol=0,
                                   atol=0.03 * float(np.abs(jg).max()), err_msg=path)


def test_cross_entropy_runs_over_padded_columns():
    """The head's padded columns take part in the softmax, as in JAX."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.integers(0, 10, (2, 5)).astype(np.int64)
    from repro.models.layers import chunked_softmax_xent as jx
    from repro_torch.models.layers import chunked_softmax_xent as tx
    want = float(jx(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), chunk=2))
    got = float(tx(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y), chunk=2))
    assert abs(got - want) <= 1e-5
