"""DeepSeek-V2-Lite's layers in the port, against the benchmark's plain
reference (``bench/families/mla_moe.py``), on the CPU at a small size.

The configuration is the benchmark's family at small widths: 1 dense and 2
MoE layers of width 64, MLA (latent 32, nope 16, rope 8, values 16) with the
latent RMSNorm and DeepSeek-V2's YaRN, a router 16 wide of which 8 experts
are held here, top-4, raw gate weights, 2 shared experts.  Weights come from
``bench.weights`` and the program is built from the family's ``arch`` as the
harness builds it.

Tolerances.  In float32 (``COMPUTE_DTYPE`` patched, as
``test_torch_families_f32.py`` does) both sides route the same tokens, so
the loss and aux terms agree to 1e-5 relative and every gradient leaf to
1e-5 of its largest entry (measured at most 1.9e-6), a layer's output to
1e-5.  In bf16 a token near a tie of the router may choose another expert,
so the loss is held to 5e-4 relative (measured 3.1e-5) and each gradient
leaf's norm to 2e-2 of its own (the toy cells' limit).  Decode runs on
float32 caches here, and is held to 1e-5 of the forward's largest logit.
"""
import dataclasses
import json
import math
import shutil
import time
import types

import pytest
import torch

from repro_torch import trace
from repro_torch.analysis.step_checks import StepWatch
from repro_torch.models import attention, layers, lm, moe
from repro_torch.models.api import build_model
from repro_torch.tree import leaf_items

from bench import families, harness, run, weights, yardstick
from bench.reference import model as ref
from bench.tests.tiny import TOY_LIMITS, TRAFFIC, toy_root

YARN = {"factor": 40, "original_max_position_embeddings": 4096, "beta_fast": 32,
        "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707, "type": "yarn"}
SMALL = {"family": "mla_moe", "n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
         "d_ff": 128, "vocab": 300, "rope_theta": 10000.0, "first_k_dense_replace": 1,
         "intermediate_size": 128, "moe_intermediate_size": 32, "n_routed_experts": 8,
         "first_expert": 0, "n_shared_experts": 2, "num_experts_per_tok": 4,
         "norm_topk_prob": False, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "rope_scaling": YARN,
         "published": {"n_routed_experts": 16}}
FAMILY = families.get("mla_moe")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def f32(monkeypatch):
    for mod in (layers, lm, attention):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _arch(cfg):
    return harness.arch_config(types.SimpleNamespace(config_name="small", config=cfg))


def _batch(seed, B=2, S=32, vocab=300):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, vocab, (B, S), generator=g),
            "labels": torch.randint(0, vocab, (B, S), generator=g)}


def _program_and_reference(cfg, seed):
    """Loss, metrics and gradients of the program and of the reference on
    the same weights and batch."""
    params = weights.make(cfg, seed, "cpu")
    batch = _batch(seed + 1)
    items = leaf_items(params)
    for _, leaf in items:
        leaf.requires_grad_(True)
    loss, met = build_model(_arch(cfg)).loss(params, batch)
    loss.backward()
    got = {p: leaf.grad.clone() for p, leaf in items}
    for _, leaf in items:
        leaf.grad = None
    want_loss = ref.loss(cfg, params, batch["tokens"], batch["labels"])
    want_loss.backward()
    want = {p: leaf.grad for p, leaf in items}
    return (float(loss.detach()), {k: float(v.detach()) for k, v in met.items()}, got), \
        (float(want_loss.detach()), want), params, batch


def _reference_aux(cfg, params, batch):
    """The reference's loss terms, summed over its MoE layers."""
    with torch.no_grad():
        h = params["embed"][batch["tokens"]]
        aux = 0.0
        for lp in ref._layers(cfg, params):
            h, extra = FAMILY.block(h, lp, cfg, "f32")
            aux = aux + extra
    return float(aux)


@pytest.mark.parametrize("first", [0, 8])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_loss_aux_and_every_gradient_match_the_reference_in_f32(f32, seed, first):
    cfg = {**SMALL, "first_expert": first}
    (loss, met, got), (want_loss, want), params, batch = _program_and_reference(cfg, seed)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    aux = 0.01 * met["lb_loss"] + 1e-3 * met["z_loss"]
    assert abs(aux - _reference_aux(cfg, params, batch)) <= 1e-5 * aux
    assert abs(loss - aux - met["xent"]) <= 1e-5 * loss
    assert met["moe_held_rows"] > 0 and met["moe_max_load"] >= 1.0
    for path, g in want.items():
        assert float((got[path] - g).abs().max()) <= 1e-5 * float(g.abs().max()), path


def test_bf16_loss_and_gradient_norms_near_the_reference():
    (loss, _, got), (want_loss, want), _, _ = _program_and_reference(SMALL, 5)
    assert abs(loss - want_loss) <= 5e-4 * want_loss
    for path, g in want.items():
        assert abs(float(got[path].norm()) - float(g.norm())) <= 2e-2 * float(g.norm()), path


def _layer(cfg, seed, first=0, held=None):
    """A MoE layer's parameters for the experts ``first .. first + held - 1``
    of a router ``published.n_routed_experts`` wide, cut from one uncut
    layer, and an input."""
    width = cfg["published"]["n_routed_experts"]
    full = {**cfg, "n_routed_experts": width, "first_expert": 0}
    lp = harness_layer(full, seed)
    held = width if held is None else held
    share = {**lp, "experts": {k: w[first:first + held] for k, w in lp["experts"].items()}}
    x = torch.randn((2, 16, cfg["d_model"]), generator=torch.Generator().manual_seed(seed))
    return share, x


def harness_layer(cfg, seed):
    """Layer 0 of the MoE stack of ``weights.make``, float32."""
    params = weights.make(cfg, seed, "cpu")
    return {k: v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()}
            for k, v in params["blocks"]["ffn"].items()}


def _program_layer(cfg, lp, x, first):
    arch = _arch({**cfg, "n_routed_experts": lp["experts"]["wi"].shape[0],
                  "first_expert": first})
    m = arch.moe
    return moe.moe_dropless(x, lp, n_routed=m.n_routed, n_shared=m.n_shared, top_k=m.top_k,
                            norm_topk=m.norm_topk, first_held=m.first_held)


@pytest.mark.parametrize("shares", [(8, 8), (4, 4, 4, 4), (16,)])
def test_shares_add_up_to_the_uncut_layer(f32, shares):
    """The routed parts of every share, plus the shared experts once, equal
    the reference's layer with all 16 experts held, and so does the
    program's uncut layer."""
    width = SMALL["published"]["n_routed_experts"]
    full, x = _layer(SMALL, 9)
    shared = layers.swiglu(x, full["shared"])
    total, first = shared.clone(), 0
    for held in shares:
        lp, _ = _layer(SMALL, 9, first, held)
        out, aux = _program_layer(SMALL, lp, x, first)
        total = total + (out - shared)
        first += held
    assert first == width
    uncut = {**SMALL, "n_routed_experts": width, "first_expert": 0}
    want, _ = FAMILY.experts(x, full, uncut, "f32")
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got, _ = _program_layer(SMALL, full, x, 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_dropless_keeps_every_row_when_every_token_picks_one_expert(f32):
    """A router that sends every token to experts 3, 0, 1 and 2, in that
    order: capacity would drop most rows; dropless computes all ``T x k`` of
    them, equal to the reference."""
    lp, x = _layer(SMALL, 4, 0, 8)
    x = x.abs() + 0.1
    router = -0.01 * torch.arange(16, dtype=torch.float32).expand_as(lp["router"]).clone()
    router[:, 3] = 1.0
    lp = {**lp, "router": router}
    out, aux = _program_layer(SMALL, lp, x, 0)
    T, k = x.shape[0] * x.shape[1], SMALL["num_experts_per_tok"]
    assert float(aux["moe_held_rows"]) == T * k
    assert float(aux["moe_max_load"]) == pytest.approx(8 / k)
    want, _ = FAMILY.experts(x, lp, SMALL, "f32")
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_expert_layer_reads_nothing_on_the_host_and_no_float64():
    """The dropless layer's forward and backward, as the step runs them: no
    ``_local_scalar_dense``, ``nonzero`` or ``equal`` of a step tensor."""
    lp, x = _layer(SMALL, 2, 0, 8)
    lp = lm._cast_weights(lp)
    x = x.to(layers.COMPUTE_DTYPE).requires_grad_(True)
    leaves = [leaf.requires_grad_(True) for _, leaf in leaf_items(lp)]
    watch = StepWatch("cpu")
    with watch:
        out, aux = _program_layer(SMALL, lp, x, 0)
        (out.float().square().mean() + aux["lb_loss"] + aux["z_loss"]).backward()
    assert watch.host_reads == [] and watch.f64_ops == []
    assert all(leaf.grad is not None for leaf in leaves)


def test_capacity_routing_refuses_a_share_or_raw_weights():
    arch = _arch(SMALL)
    for moe_spec in (dataclasses.replace(arch.moe, capacity_factor=1.25),
                     dataclasses.replace(arch.moe, capacity_factor=1.25, n_held=None)):
        with pytest.raises(ValueError):
            lm._moe(dataclasses.replace(arch, moe=moe_spec), torch.zeros((1, 2, 64)), {})


def test_yarn_constants_at_the_published_widths():
    """DeepSeek-V2-Lite: rope dim 64, theta 1e4, factor 40 over 4096, beta
    32 / 1, mscale 0.707 on both: the ramp from 10 to 23, scores scaled by
    ``mscale^2 / sqrt(192)``, cos and sin by 1; the program's and the
    reference's frequencies equal."""
    yarn = tuple(YARN[k] for k in FAMILY.YARN_KEYS)
    assert layers.yarn_range(64, 1e4, yarn) == (10, 23)
    assert layers.yarn_softmax_scale(192, yarn) == pytest.approx(0.114721, abs=5e-7)
    cfg = {**SMALL, "qk_rope_head_dim": 64, "qk_nope_head_dim": 128}
    freqs, amp, scale, ramp = FAMILY.yarn(cfg, "cpu")
    assert ramp == (10, 23) and amp == 1.0 and scale == layers.yarn_softmax_scale(192, yarn)
    assert torch.equal(layers.yarn_freqs(64, 1e4, yarn, "cpu"), freqs)
    f_e = layers.rope_freqs(64, 1e4, "cpu")
    assert torch.equal(freqs[:10], f_e[:10])
    assert torch.allclose(freqs[23:], f_e[23:] / 40, rtol=1e-6, atol=0)
    x = torch.randn((1, 8, 2, 64), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(8)
    assert torch.equal(layers.apply_rope(x, pos, 1e4, ()), layers.apply_rope(x, pos, 1e4))


def test_chunked_attention_takes_the_yarn_scale(f32, monkeypatch):
    """Past ``FLASH_THRESHOLD`` MLA runs chunked: with the latent norm and
    YaRN it equals the S x S path."""
    cfg = _arch(SMALL)
    m = cfg.mla
    p = attention.mla_init(torch.Generator().manual_seed(1), 64, 4, kv_lora=m.kv_lora,
                           qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_head=m.v_head,
                           device="cpu", latent_norm=True)
    p["kv_norm"] = p["kv_norm"] + 0.5
    x = torch.randn((1, 40, 64), generator=torch.Generator().manual_seed(2))
    kw = dict(n_heads=4, kv_lora=m.kv_lora, qk_nope=m.qk_nope, qk_rope=m.qk_rope,
              v_head=m.v_head, theta=1e4, latent_norm=True, yarn=m.yarn)
    want = attention.mla_forward(x, p, **kw)
    monkeypatch.setattr(attention, "FLASH_THRESHOLD", 16)
    got = attention.mla_forward(x, p, **kw)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_decode_after_prefill_matches_the_full_forward(f32):
    """A 10-token prompt fed through the decode caches, then 6 more tokens:
    each step's logits equal the full forward's at that position, and the
    last prompt position's equal the prefill's."""
    arch = _arch(SMALL)
    model = build_model(arch)
    params = weights.make(SMALL, 21, "cpu")
    tokens = _batch(22, B=2, S=16)["tokens"]
    with torch.no_grad():
        full = model.logits(params, {"tokens": tokens})
        prefill = model.prefill(params, {"tokens": tokens[:, :10]})
        caches = {k: dataclasses.replace(c, c_kv=c.c_kv.float(), k_rope=c.k_rope.float())
                  for k, c in model.init_cache(2, 16, device="cpu").items()}
        steps = []
        for t in range(16):
            logits, caches = model.decode_step(params, caches, tokens[:, t:t + 1])
            steps.append(logits)
    scale = float(full.abs().max())
    assert float((prefill - full[:, 9:10]).abs().max()) <= 1e-5 * scale
    for t, logits in enumerate(steps):
        assert float((logits - full[:, t:t + 1]).abs().max()) <= 1e-5 * scale, t


def test_the_forward_opens_the_mla_and_moe_spans():
    params = weights.make(SMALL, 1, "cpu")
    trace.collect()
    trace.enable(True)
    try:
        build_model(_arch(SMALL)).loss(params, _batch(2))
    finally:
        trace.enable(False)
    names = [name for name, *_ in trace.collect()]
    assert names.count("model.mla") == 3
    assert names.count("model.moe.route") == names.count("model.moe.experts") == 2
    assert set(names) <= set(trace.NAMES)


BENCH_CONFIG = "deepseek-v2-lite-l5e8"


def _bench_config():
    spec = json.loads((harness.cells.BENCH.parent / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in spec["configs"]}[BENCH_CONFIG]
    return json.loads((harness.cells.BENCH.parent / conf["file"]).read_text())


def test_the_benchmark_configuration_holds_its_stated_size():
    """535,060,992 parameters a node; 8 of 64 experts held, 5 of 27 layers
    and 12,800 of 102,400 ids; the step's counted operations."""
    cfg = _bench_config()
    lay = weights.layout(cfg)
    assert sum(math.prod(shape) for shape, _ in lay.values()) == cfg["params_per_node"] \
        == 535_060_992
    assert lay["blocks/ffn/experts/wi"][0] == (4, 8, 2048, 1408)
    assert lay["blocks/ffn/router"][0] == (4, 2048, 64)
    assert cfg["published"] == {"num_hidden_layers": 27, "n_routed_experts": 64,
                                "vocab_size": 102400}
    assert [cfg[k] for k in cfg["reduced"]] == [cfg["n_layers"], 8, cfg["vocab"]] \
        == [5, 8, 12800]
    arch = _arch(cfg)
    assert arch.moe.n_routed == 64 and arch.moe.held == 8 and arch.moe.capacity_factor is None
    assert arch.mla.latent_norm and arch.mla.yarn == (40, 4096, 32, 1, 0.707, 0.707)
    flops = yardstick.model_flops_per_token(cfg, 4096) * 4 * 4096
    assert flops == pytest.approx(35.66e12, rel=1e-3)


def small_cell_root(tmp_path):
    """A copy of the benchmark with the cell ``toy-mla-moe.dcd-q4``: the
    configuration :data:`SMALL` under the toy DCD ``quant:4`` traffic (a ring
    of 4, 8 sequences of 32 tokens), on the toy limits."""
    root = toy_root(tmp_path, TOY_LIMITS)
    cfg = {**SMALL, "name": "toy-mla-moe"}
    (root / "bench" / "configs" / "toy-mla-moe.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-mla-moe", "source": "a CPU test", "reduced": [],
                            "file": "bench/configs/toy-mla-moe.json", "why": "a CPU test"})
    spec["workloads"].append({"name": SMALL_CELL, "config": "toy-mla-moe",
                              "traffic": "toy-dcd-q4", "chips": 1, "why": "a CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(root / "bench" / "limits" / "toy-dense.dcd-q4.json",
                root / "bench" / "limits" / f"{SMALL_CELL}.json")
    return root


SMALL_CELL = "toy-mla-moe.dcd-q4"


def test_a_small_cell_of_the_family_runs_correct_through_the_harness(tmp_path):
    """The family as a cell of a copy of the benchmark: the harness's
    program (``build_model`` -> ``make_dist_train_step``, DCD over
    ``quant:4`` on a ring of 4) against the reference, on the toy limits."""
    root = small_cell_root(tmp_path)
    got = run.run(root, SMALL_CELL, 2 ** 31 + 29, 0.2, trace=False, device="cpu",
                  started=time.perf_counter())
    assert got["correct"], got["checks"]
    assert TRAFFIC["n_nodes"] == 4
