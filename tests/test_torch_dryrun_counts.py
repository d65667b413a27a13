"""The dryrun's meta counts against the JAX package's, on the CPU.

FLOP counts (``count_fn_flops``, ``FlopCounterMode`` over the eager step)
are held to JAX's ``count_fn_flops`` (``jaxpr_flops``) of the loss and its
gradient on each family's ``reduced()`` config: equal to rtol 1e-4 without
remat.  The differences (measured): the SSM chunked scan takes its einsums
in another grouping (0.14% fewer in the port on zamba2, 0.33% on mamba2;
held to 0.5%); the MoE families 4096 fewer.  With remat, checkpointed
blocks recompute their forward in both packages; on the MoE families the
port recomputes exactly ``moe_recompute_gap`` more than JAX (25,163,776 on
both reduced configs); whisper's JAX loss ignores ``remat`` while the port
checkpoints each encoder and decoder layer, so the port counts more than
JAX's count (no remat) by less than one forward.

The meta counts of a record run the model at 1 and 2 repeats of its layer
(or hybrid period) and extrapolate (``count_by_depth``); here that equals
the count of the whole model, FLOPs and bytes, with a backward pass
(training) and without (a decode step).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import analysis as janalysis
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import analysis as tanalysis
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import specs as tspecs
from repro_torch.models.api import build_model, make_batch_specs
from test_torch_families import np_batch, one_torch_thread, pair, to_jax  # noqa: F401

FLOPS_RTOL, SSM_RTOL = 1e-4, 5e-3


def moe_recompute_gap(cfg, batch: int, seq: int) -> int:
    """The FLOPs that the port's checkpointed MoE layers recompute and JAX's
    do not.  ``torch.utils.checkpoint`` replays a block's forward in program
    order up to the last tensor the backward saved, and ``moe_forward``
    takes its load-balance and z losses after the routed experts' combine
    einsum and the shared experts' down projection, so both run again;
    JAX's partial evaluation drops them, as the backward needs neither
    output.  Less the one product JAX recomputes alone: it forms the
    top-k combine weights with a ``dot_general`` that contracts nothing,
    where the port multiplies elementwise."""
    m = cfg.moe
    tokens = batch * seq
    group = min(1024, tokens)                   # moe_forward's default group
    padded = -(-tokens // group) * group
    capacity = max(int(group * m.top_k * m.capacity_factor / m.n_routed), m.top_k)
    combine = 2 * padded * m.n_routed * capacity * cfg.d_model
    shared_down = 2 * tokens * m.n_shared * m.d_expert * cfg.d_model
    gate_weights = 2 * padded * m.top_k * m.n_routed
    moe_layers = cfg.n_layers - len(m.dense_layers or ())
    return moe_layers * (combine + shared_down - gate_weights)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flop_counts_match_jax_on_reduced_configs(arch):
    jcfg, tcfg, jmodel, tmodel, jparams, _ = pair(arch)
    batch = np_batch(jcfg, 2, 64)
    tbatch = make_batch_specs(tcfg, 2, 64)
    got, want = {}, {}
    for remat in (False, True):
        want[remat] = janalysis.count_fn_flops(
            lambda p, b: jax.value_and_grad(lambda q: jmodel.loss(q, b, remat=remat)[0])(p),
            jparams, to_jax(batch))
        got[remat] = tanalysis.count_fn_flops(tdr._loss_and_grad(tmodel, remat),
                                              tspecs.params_specs(tcfg), tbatch)
    np.testing.assert_allclose(got[False], want[False],
                               rtol=SSM_RTOL if tcfg.ssm else FLOPS_RTOL, err_msg=arch)
    if tcfg.is_encdec:
        # JAX ignores remat here; the port recomputes the layers' forward
        fwd = tanalysis.count_fn_flops(lambda p, b: tmodel.loss(p, b),
                                       tspecs.params_specs(tcfg), tbatch)
        assert want[True] == want[False] and got[False] < got[True] < got[False] + fwd
    elif tcfg.moe:
        assert got[True] - got[False] == want[True] - want[False] + moe_recompute_gap(
            tcfg, 2, 64), (arch, got, want)
        assert want[True] > want[False]
    else:
        np.testing.assert_allclose(got[True], want[True],
                                   rtol=SSM_RTOL if tcfg.ssm else FLOPS_RTOL, err_msg=arch)
        assert got[True] > got[False]


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b", "deepseek-moe-16b"])
def test_depth_extrapolation_is_exact(arch):
    cfg = get_config(arch).reduced()
    unit = cfg.hybrid_period or 1
    cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers + 3 * unit)
    batch = make_batch_specs(cfg, 2, 64)
    train = lambda c: tanalysis.count_fn(tdr._loss_and_grad(build_model(c), True),
                                         tspecs.params_specs(c), batch)
    assert tuple(tdr.count_by_depth(cfg, train)) == train(cfg)
    shape = tspecs.InputShape("t", "decode", 64, 2)
    with torch.no_grad():
        decode = lambda c: tanalysis.count_fn(
            build_model(c).decode_step, tdr._bf16_params(c),
            tspecs.decode_cache_specs(c, shape)[0], torch.empty((2, 1), dtype=torch.int64,
                                                               device="meta"))
        assert tuple(tdr.count_by_depth(cfg, decode)) == decode(cfg)
