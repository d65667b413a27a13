"""``_node_grads`` on the CPU: every node's gradient through one backward of
the stacked tree, the nodes' slices taken by one ``torch.unbind`` a leaf.

Two families of the benchmark at toy widths, a dense decoder
(``bench/tests/tiny.py``'s ``toy-dense``) and DeepSeek-V2-Lite's latent
attention with dropless experts (``test_torch_mla_moe.SMALL``), each node
with weights of its own seed.  The gradients equal, by ``torch.equal``, each
node's own ``torch.autograd.grad`` of its loss on a detached copy of its
slice.  Under ``torch.profiler`` the backward writes no zero tensor of a
stacked leaf's shape and adds none up: indexing a node (``leaf[i]``) made
its backward a ``select_backward`` that zero-fills the whole stacked leaf,
then 7 full-size adds a leaf at 8 nodes.
"""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.distributed.decentralized import _node_grads
from repro_torch.models.api import build_model
from repro_torch.tree import tree_leaves, tree_map

from bench import harness, weights
from bench.tests.tiny import CONFIGS
from test_torch_families import one_torch_thread  # noqa: F401
from test_torch_mla_moe import SMALL

FAMILIES = {"dense": CONFIGS["toy-dense"], "mla_moe": SMALL}
# ops that would write or add up a tensor of a stacked leaf's whole shape
FULL_SIZE_OPS = ("aten::zero_", "aten::fill_", "aten::add_", "aten::add")


def _setup(family, nodes, seq=16, batch=2):
    cfg = FAMILIES[family]
    model = build_model(harness.arch_config(types.SimpleNamespace(config_name=family,
                                                                  config=cfg)))
    params = tree_map(lambda *ls: torch.stack(ls),
                      *(weights.make(cfg, 101 + i, "cpu") for i in range(nodes)))
    g = torch.Generator().manual_seed(nodes)
    data = {k: torch.randint(0, cfg["vocab"], (nodes, batch, seq), generator=g)
            for k in ("tokens", "labels")}
    return model.loss, params, data


@pytest.mark.parametrize("nodes", [1, 8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_node_grads_equal_each_nodes_own_gradient(family, nodes):
    """Losses and gradients equal a plain per-node ``torch.autograd.grad``
    on a detached copy of the node's slice, and every slice the loss sees
    is an output of ``unbind`` (one node: a rank's tree)."""
    loss_fn, params, data = _setup(family, nodes)
    seen = []

    def watched(p, b):
        seen.extend(type(l.grad_fn).__name__ for l in tree_leaves(p))
        return loss_fn(p, b)

    losses, _, grads = _node_grads(watched, params, data)
    assert set(seen) == {"UnbindBackward0"}
    assert all(l.grad is None and not l.requires_grad for l in tree_leaves(params))
    for i in range(nodes):
        own = tree_map(lambda l: l[i].detach().clone().requires_grad_(True), params)
        loss_i, _ = loss_fn(own, {k: v[i] for k, v in data.items()})
        want = torch.autograd.grad(loss_i, tree_leaves(own), materialize_grads=True)
        assert torch.equal(losses[i], loss_i.detach())
        for j, (got, w) in enumerate(zip(grads, want)):
            assert torch.equal(got[i], w), (family, i, j)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_backward_writes_no_full_size_zeros_or_adds(family):
    """Profiled with shapes: no ``select_backward`` into, and no zero fill
    or add of, a tensor shaped like a stacked leaf."""
    loss_fn, params, data = _setup(family, 8)
    stacked = {tuple(l.shape) for l in tree_leaves(params)}
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        _node_grads(loss_fn, params, data)
    bad = []
    for e in prof.events():
        sizes = e.concrete_inputs
        if e.name == "aten::select_backward" and tuple(sizes[1]) in stacked:
            bad.append((e.name, sizes[1]))
        elif e.name == "aten::zeros" and tuple(sizes[0]) in stacked:
            bad.append((e.name, sizes[0]))
        elif e.name in FULL_SIZE_OPS and e.input_shapes and tuple(e.input_shapes[0]) in stacked:
            bad.append((e.name, e.input_shapes[0]))
    assert bad == [], bad[:8]
