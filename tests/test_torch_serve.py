"""The port's serving driver (``launch/serve.py``) on the CPU.

``serve_batch`` prefills through the decode step and samples at temperature
0.8 from an explicit ``torch.Generator``: its first token is the greedy
argmax of the prefill's logits, which equals the JAX driver's first token
wherever JAX's top two logits are more than the bf16 tolerance (5e-2)
apart; the sampled tokens after it differ from JAX's by design (keys against
a generator).  The same generator gives the same tokens; a row that emitted
EOS emits EOS from then on.  ``main`` runs with JAX's flags and reduced
config, on the GPU unless ``--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model
from test_torch_families import one_torch_thread, pair  # noqa: F401


def _prompts(cfg, B=3, P=6, seed=4):
    return np.random.default_rng(seed).integers(2, cfg.vocab, (B, P)).astype(np.int32)


def _gen(seed=1):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-370m", "deepseek-v2-lite-16b",
                                  "whisper-base", "zamba2-7b", "internvl2-76b"])
def test_serve_batch_first_token_matches_jax(arch):
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair(arch)
    prompts = _prompts(jcfg)
    jout = np.asarray(jserve.serve_batch(jmodel, jparams, jnp.asarray(prompts), 5,
                                         jax.random.key(1)))
    tout = tserve.serve_batch(tmodel, tparams, torch.from_numpy(prompts.astype(np.int64)), 5,
                              _gen())
    assert tout.shape == jout.shape == (3, 5) and tout.dtype == torch.int64
    assert int(tout.min()) >= 0 and int(tout.max()) < tcfg.vocab
    # the prefill logits agree; the first token is the port's greedy argmax,
    # JAX's too wherever JAX's top two logits are unambiguous
    step = jax.jit(jmodel.decode_step)
    jc, tc = jmodel.init_cache(3, 11), tmodel.init_cache(3, 11, device="cpu")
    for t in range(prompts.shape[1]):
        jl, jc = step(jparams, jc, jnp.asarray(prompts[:, t:t + 1]))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(
            prompts[:, t:t + 1].astype(np.int64)))
    jl = np.asarray(jl[:, 0], np.float32)
    np.testing.assert_allclose(tl[:, 0].float().numpy(), jl, rtol=0, atol=5e-2)
    assert torch.equal(tout[:, 0], tl[:, 0].argmax(-1))
    top2 = np.sort(jl, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 0.1
    assert (tout[:, 0].numpy()[sure] == jout[sure, 0]).all()


def test_serve_batch_is_reproducible_and_stops_rows_at_eos():
    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = torch.from_numpy(_prompts(cfg).astype(np.int64))
    a = tserve.serve_batch(model, params, prompts, 8, _gen(7))
    b = tserve.serve_batch(model, params, prompts, 8, _gen(7))
    c = tserve.serve_batch(model, params, prompts, 8, _gen(8))
    assert torch.equal(a, b) and a.shape == (3, 8)
    assert torch.equal(a[:, 0], c[:, 0])            # greedy first token
    # make row 0's first token the EOS: the row emits EOS after it
    eos = int(a[0, 0])
    d = tserve.serve_batch(model, params, prompts, 8, _gen(7), eos=eos)
    assert (d[0] == eos).all()
    # a ring-buffer window serves too
    w = tserve.serve_batch(model, params, prompts, 8, _gen(7), window=4)
    assert w.shape == (3, 8) and int(w.max()) < cfg.vocab


def test_categorical_is_gumbel_max_at_the_logits_dtype():
    logits = torch.tensor([[0.0, 10.0, -10.0], [3.0, -1.0, 2.9]], dtype=torch.bfloat16)
    picks = torch.stack([tserve._categorical(_gen(s), logits) for s in range(400)])
    assert (picks[:, 0] == 1).all()                 # a 10-logit gap is never crossed
    assert set(picks[:, 1].tolist()) <= {0, 1, 2} and len(set(picks[:, 1].tolist())) >= 2


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-base", "deepseek-moe-16b"])
def test_main_serves_on_the_cpu(arch, capsys):
    outs = tserve.main(["--arch", arch, "--device", "cpu", "--requests", "5", "--batch", "2",
                        "--prompt-len", "4", "--max-new", "3"])
    assert [tuple(o.shape) for o in outs] == [(2, 3), (2, 3), (1, 3)]
    text = capsys.readouterr().out
    assert "served batch of 2: out shape (2, 3)" in text and "5 requests in" in text


def test_main_defaults_to_the_gpu():
    if torch.cuda.is_available():
        outs = tserve.main(["--requests", "1", "--max-new", "2"])
        assert outs[0].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tserve.main(["--requests", "1", "--max-new", "2"])
