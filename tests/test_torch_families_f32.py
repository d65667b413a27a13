"""Every model family's structure against the JAX package's, in float32.

The bf16 comparisons (``test_torch_families.py``, ``test_torch_decode.py``)
hold the two packages to bf16 rounding, which could hide a small structural
fault.  Here both packages compute in float32: ``COMPUTE_DTYPE`` is patched
to float32 in the model modules of both for the test (the decode caches keep
their bf16 default in both, which both round the same way).  Then the loss,
its aux terms and every gradient leaf agree to 1e-4 relative (measured at
most 1.1e-5, zamba2's ``dt_bias``), the full forward's logits to 1e-5
absolute (measured at most 2.3e-6) on logits of about 0.3, and 12
teacher-forced decode steps, whose bf16 caches round the keys and values,
to 1e-3 (measured at most 1.5e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.encdec as jed
import repro.models.layers as jlayers
import repro.models.lm as jlm
import repro_torch.models.attention as tattn
import repro_torch.models.encdec as ted
import repro_torch.models.layers as tlayers
import repro_torch.models.lm as tlm
from repro_torch.configs import ARCH_IDS
from test_torch_families import (loss_and_grads, np_batch, one_torch_thread, pair,  # noqa: F401
                                 to_jax, to_torch)


@pytest.fixture
def f32(monkeypatch):
    for mod in (jlayers, jlm, jattn, jed):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tlayers, tlm, tattn, ted):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax_in_f32(f32, arch):
    (jloss, jmet), (tloss, tmet), grads = loss_and_grads(arch)
    assert abs(tloss - jloss) <= 1e-4 * abs(jloss)
    for k in ("lb_loss", "z_loss"):
        assert abs(tmet[k] - jmet[k]) <= 1e-4 * abs(jmet[k]), k
    for path, got, want in grads:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logits_and_decode_match_jax_in_f32(f32, arch):
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair(arch)
    batch = np_batch(jcfg, 2, 24, seed=1)
    jlog = np.asarray(jmodel.logits(jparams, to_jax(batch)), np.float32)
    tlog = tmodel.logits(tparams, to_torch(batch))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.detach().numpy(), jlog, rtol=0, atol=1e-5)

    jcache = jmodel.init_cache(2, 16)
    tcache = tmodel.init_cache(2, 16, device="cpu")
    if jcfg.is_encdec:
        frames = batch["extra_embeds"]
        jcache = jed.encdec_prefill_cross(jcfg, jparams, jnp.asarray(frames), jcache)
        tcache = ted.encdec_prefill_cross(tcfg, tparams, torch.from_numpy(frames), tcache)
    step = jax.jit(jmodel.decode_step)
    toks = batch["tokens"]
    for t in range(12):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(
            toks[:, t:t + 1].astype(np.int64)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
