"""Every model family of the port against the JAX package's, on the CPU.

For each of the ten architectures at its ``reduced()`` width: the config
copy, the parameter tree (leaf paths, shapes and order equal to JAX's
flatten order, which the wire seeds leaves by), and the loss with its
``lb_loss``/``z_loss`` terms and every gradient leaf, from the same JAX
``init`` carried over by ``params_from_jax`` and the same numpy batch.

Both packages run bf16 matmuls with float32 master weights but round in
different places (XLA fuses, torch rounds every op), so the bf16 loss is
held to 2e-3 absolute and ``lb_loss``/``z_loss`` to 1e-3 relative (measured
at most 2e-4 on ~2), and each gradient leaf to 3% of its largest entry, as
in ``test_torch_model.py`` (measured at most 2.7%).  The SSM families
round more (the chunked scan's bf16 einsums contract in another order): 5%
for their leaves (measured at most 3.1%, zamba2's ``wz``), and 15% for the
mixer's step size and input paths (``wdt``, ``dt_bias``, ``A_log``, ``D``,
``wbc``), sums over every position with heavy cancellation (``dt_bias``'s
gradient is ~4e-5 against terms of ~1e-2; measured up to 4.8% on mamba2 and
11.2% on zamba2, at ``dt_bias``).  The float32 file
(``test_torch_families_f32.py``) holds the same structure to 1e-4.  The
slice as a whole: a two-step DCD ``quant:8`` run of every family through
``run_training``, finite, with replicas exactly ``roll(X, s)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild
from repro_torch.configs import ARCH_IDS, get_config as tget_config
from repro_torch.convert import leaf_paths, params_from_jax
from repro_torch.models.api import build_model as tbuild
from repro_torch.tree import leaf_items, tree_leaves

SSM_SUMS = ("mixer/wdt", "mixer/dt_bias", "mixer/A_log", "mixer/D", "mixer/wbc")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch single-threaded in these tests: their ops are small, and
    beside five other test workers an intra-op thread pool only contends
    for the cores (the other modules import this fixture too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(k.key for k in path) for path, _ in flat]


def pair(arch: str):
    """(jax cfg, port cfg, jax model, port model, jax params, port params on the CPU)."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams


def np_batch(cfg, B: int, S: int, seed: int = 0):
    """A numpy training batch of ``S`` positions (a vision frontend's patches
    take ``n_tokens`` of them), with ``extra_embeds`` for a frontend."""
    rng = np.random.default_rng(seed)
    n_text = S - cfg.frontend.n_tokens if cfg.frontend and cfg.frontend.kind == "vision" else S
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_text)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, n_text)).astype(np.int32)}
    if cfg.frontend:
        batch["extra_embeds"] = rng.standard_normal(
            (B, cfg.frontend.n_tokens, cfg.frontend.dim)).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch, device="cpu"):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v).to(device)
            for k, v in batch.items()}


def loss_and_grads(arch: str, S: int = 32):
    """The loss, its metrics and every gradient leaf from both packages."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = pair(arch)
    batch = np_batch(jcfg, 2, S)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b), has_aux=True))(jparams, to_jax(batch))
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_(True)
    tloss, tmet = tmodel.loss(tparams, to_torch(batch))
    tloss.backward()
    tloss, tmet = tloss.detach(), {k: v.detach() for k, v in tmet.items()}
    grads = [(path, p.grad.numpy(), np.asarray(g))
             for (path, p), g in zip(leaf_items(tparams), jax.tree_util.tree_leaves(jgrads))]
    return (float(jloss), {k: float(v) for k, v in jmet.items()}), \
        (tloss.item(), {k: v.item() for k, v in tmet.items()}), grads


# the port's spec options that JAX's specs lack, at the defaults that keep
# JAX's behaviour (capacity routing over every expert, normalized softmax
# weights, SwiGLU experts; plain rope, no latent norm; the SSM's norm before
# its gate)
PORT_ONLY = {"moe": {"norm_topk": True, "first_held": 0, "n_held": None, "score": "softmax",
                     "routed_scale": 1.0, "act": "swiglu"},
             "mla": {"latent_norm": False, "yarn": ()},
             "ssm": {"gate_first": False}}
# the port's own config fields, at the defaults that keep JAX's behaviour
# (no layer pattern, rope on every attention layer)
PORT_ONLY_FIELDS = {"layer_pattern": "", "rope": True}


def _jax_fields(t: dict, j: dict) -> dict:
    """``t`` (the port's config as a dict) cut to the fields of JAX's, each
    spec too, after checking the port's own fields hold their defaults."""
    assert {k: t[k] for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS
    out = {k: v for k, v in t.items() if k not in PORT_ONLY_FIELDS}
    for spec, defaults in PORT_ONLY.items():
        if t[spec] is not None:
            assert {k: t[spec][k] for k in defaults} == defaults, spec
            out[spec] = {k: v for k, v in t[spec].items() if k in j[spec]}
    return out


def test_arch_ids_and_config_copies_match_jax():
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        for make in (lambda c: c, lambda c: c.reduced()):
            j, t = make(jget_config(arch)), make(tget_config(arch))
            jd = dataclasses.asdict(j)
            assert _jax_fields(dataclasses.asdict(t), jd) == jd, arch
            assert (t.vocab_padded, t.hd, t.is_encdec, t.attention_free) == \
                (j.vocab_padded, j.hd, j.is_encdec, j.attention_free), arch
    with pytest.raises(ValueError):
        tget_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_paths_shapes_and_order_match_jax(arch):
    """The port's own init has JAX's tree: the same leaf paths in JAX's
    flatten order (``blocks0``, ``pm`` with its two leading axes, ``tail``,
    ``shared_attn``, ``proj``, ``enc``/``dec``), shapes and float32."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    jshapes = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    own = tbuild(tcfg).init(0, device="cpu")
    assert leaf_paths(own) == jax_paths(jshapes)
    for (path, leaf), js in zip(leaf_items(own), jax.tree_util.tree_leaves(jshapes)):
        assert tuple(leaf.shape) == tuple(js.shape) and leaf.dtype == torch.float32, path
        assert js.dtype == jnp.float32, path
    roots = set(own)
    want = {"internvl2-76b": {"proj", "blocks"}, "zamba2-7b": {"pm", "shared_attn"},
            "deepseek-moe-16b": {"blocks0", "blocks"}, "deepseek-v2-lite-16b": {"blocks0"},
            "whisper-base": {"enc", "dec", "enc_ln"}}.get(arch, {"blocks"})
    assert want <= roots, roots


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_aux_and_grads_match_jax(arch):
    (jloss, jmet), (tloss, tmet), grads = loss_and_grads(arch)
    assert abs(tloss - jloss) <= 2e-3
    assert abs(tmet["xent"] - jmet["xent"]) <= 2e-3
    for k in ("lb_loss", "z_loss"):
        assert abs(tmet[k] - jmet[k]) <= 1e-3 * abs(jmet[k]), (k, tmet[k], jmet[k])
        assert (tmet[k] != 0.0) == (arch in ("deepseek-moe-16b", "deepseek-v2-lite-16b")), k
    ssm = tget_config(arch).ssm is not None
    for path, got, want in grads:
        rel = 0.15 if path.endswith(SSM_SUMS) else 0.05 if ssm else 0.03
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                                   err_msg=path)
