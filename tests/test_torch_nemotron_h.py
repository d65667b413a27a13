"""Nemotron 3 Nano's layers in the port, against the benchmark's plain
reference (``bench/families/nemotron_h.py``), on the CPU at a small size.

The configuration is the benchmark's family at small widths: the pattern's
first 7 layers ``MEMEM*E`` of width 64; Mamba2 with 4 heads of 32, state
16, 2 groups, chunk 8 and the gate-first grouped norm; a sigmoid router 16
wide of which 8 relu^2 experts are held here, top-4, the chosen scores
normalized and scaled by 2.5, a shared expert of twice the expert width;
NoPE GQA with 4 query and 2 KV heads of 24 (4 x 24 != 64).  Weights come
from ``bench.weights`` and the program is built from the family's ``arch``
as the harness builds it.

Tolerances.  In float32 (``COMPUTE_DTYPE`` patched, as
``test_torch_mla_moe.py`` does) both sides route the same tokens, so the
loss and aux terms agree to 1e-5 relative and every gradient leaf to 1e-5
of its largest entry (measured at most 1.7e-6), a layer's output to 1e-5.
In bf16 at these widths (64 positions of width 64) the loss is held to the
toy cells' 1e-3 (measured at most 7.5e-4 over seeds 5-24) and each gradient
leaf's norm, by the harness's gap, to 5e-2 (measured at most 4.9e-2, the
mixers' norm gain) but the Mamba2 skip ``D``'s to 0.2 (measured at most
0.167: its gradient, a sum of ``x dL/dy`` over the positions, cancels to
1/44-1/75 of its terms' absolute sum, so their bf16 rounding moves it most);
a token near a tie of the router may choose another expert.  Decode runs on float32 caches here and is held
to 1e-5 of the forward's largest logit.
"""
import dataclasses
import json
import math
import shutil
import time
import types

import pytest
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.analysis.step_checks import StepWatch
from repro_torch.configs import get_config
from repro_torch.configs.nemotron_3_nano_30b import CONFIG
from repro_torch.models import attention, layers, lm, moe, ssm
from repro_torch.models.api import build_model
from repro_torch.tree import leaf_items

from bench import compare, families, harness, run, weights, yardstick
from bench.reference import model as ref
from bench.tests.tiny import TOY_LIMITS, TRAFFIC, toy_root

SMALL = {"family": "nemotron_h", "n_layers": 7, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "d_ff": 32, "vocab": 300, "rope_theta": 10000.0,
         "hybrid_override_pattern": "MEMEM*EMEMEM*", "num_hidden_layers": 7,
         "mamba_num_heads": 4, "mamba_head_dim": 32, "ssm_state_size": 16, "n_groups": 2,
         "chunk_size": 8, "conv_kernel": 4, "time_step_min": 0.001, "time_step_max": 0.1,
         "time_step_floor": 1e-4, "moe_intermediate_size": 32,
         "moe_shared_expert_intermediate_size": 64, "n_routed_experts": 8, "first_expert": 0,
         "num_experts_per_tok": 4, "norm_topk_prob": True, "routed_scaling_factor": 2.5,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 24,
         "published": {"n_routed_experts": 16}}
FAMILY = families.get("nemotron_h")


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
    """The reference's loss terms, summed over its expert layers."""
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
    assert set(got) == set(want) and len(want) == 26
    for path, g in want.items():
        assert float((got[path] - g).abs().max()) <= 1e-5 * float(g.abs().max()), path


@pytest.mark.parametrize("seed", [5, 10])
def test_bf16_loss_and_gradient_norms_near_the_reference(seed):
    """The harness's gaps (``bench.compare``: a leaf's norm gap over the
    larger of its norm and the median leaf's) of the bf16 program."""
    (loss, _, got), (want_loss, want), _, _ = _program_and_reference(SMALL, seed)
    assert abs(loss - want_loss) <= 1e-3 * want_loss
    gaps = compare.leaf_gaps({p: float(g.norm()) for p, g in got.items()},
                             {p: float(g.norm()) for p, g in want.items()})
    for path, gap in gaps.items():
        assert gap <= (0.2 if path.endswith("/D") else 5e-2), path


def _expert_layer(cfg, seed, first=0, held=None):
    """Expert layer 0's parameters for the experts ``first .. first + held
    - 1`` of a router ``published.n_routed_experts`` wide, cut from one
    uncut layer, and an input."""
    width = cfg["published"]["n_routed_experts"]
    params = weights.make({**cfg, "n_routed_experts": width, "first_expert": 0}, seed, "cpu")
    lp = {k: v[0, 0] if not isinstance(v, dict) else {kk: vv[0, 0] for kk, vv in v.items()}
          for k, v in params["blocks"]["moe"]["ffn"].items()}
    held = width if held is None else held
    share = {**lp, "experts": {k: w[first:first + held] for k, w in lp["experts"].items()}}
    x = torch.randn((2, 16, cfg["d_model"]), generator=torch.Generator().manual_seed(seed))
    return share, x


def _program_layer(cfg, lp, x, first):
    m = _arch({**cfg, "n_routed_experts": lp["experts"]["wi"].shape[0],
               "first_expert": first}).moe
    return moe.moe_dropless(x, lp, n_routed=m.n_routed, n_shared=m.n_shared, top_k=m.top_k,
                            norm_topk=m.norm_topk, first_held=m.first_held, score=m.score,
                            routed_scale=m.routed_scale, act=m.act)


@pytest.mark.parametrize("shares", [(8, 8), (4, 4, 4, 4), (2, 6, 8), (16,)])
def test_shares_add_up_to_the_uncut_layer(f32, shares):
    """The routed parts of every share, plus the shared expert once, equal
    the reference's layer with all 16 experts held, and so does the
    program's uncut layer."""
    width = SMALL["published"]["n_routed_experts"]
    full, x = _expert_layer(SMALL, 9)
    shared = layers.relu2_mlp(x, full["shared"])
    total, first = shared.clone(), 0
    for held in shares:
        lp, _ = _expert_layer(SMALL, 9, first, held)
        out, _ = _program_layer(SMALL, lp, x, first)
        total = total + (out - shared)
        first += held
    assert first == width
    uncut = {**SMALL, "n_routed_experts": width, "first_expert": 0}
    want, _ = FAMILY.experts(x, full, uncut, "f32")
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got, _ = _program_layer(SMALL, full, x, 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_router_chooses_the_top_sigmoid_scores_normalized_and_scaled(f32):
    """A rigged router: token t's logits rise with the expert index, so it
    chooses experts 15, 14, 13, 12; their weights are their sigmoid scores
    over the four's sum, times 2.5, and every held expert (8-15) computes
    its rows, each equal to the reference."""
    full, x = _expert_layer(SMALL, 4)
    x = x.abs() + 0.1
    router = torch.zeros_like(full["router"])
    router[:] = 0.02 * torch.arange(16, dtype=torch.float32)
    lp = {**full, "router": router,
          "experts": {k: w[8:] for k, w in full["experts"].items()}}
    out, aux = _program_layer(SMALL, lp, x, 8)
    T, k = x.shape[0] * x.shape[1], SMALL["num_experts_per_tok"]
    assert float(aux["moe_held_rows"]) == T * k
    assert float(aux["moe_max_load"]) == pytest.approx(8 / k)
    flat = x.reshape(T, -1)
    scores = torch.sigmoid(flat @ router)
    chosen = scores[:, 12:]
    weights = chosen / (chosen.sum(dim=-1, keepdim=True) + 1e-20) * 2.5
    want = layers.relu2_mlp(x, lp["shared"]).reshape(T, -1)
    for j in range(4):
        one = {name: w[4 + j] for name, w in lp["experts"].items()}
        want = want + weights[:, j:j + 1] * layers.relu2_mlp(flat, one)
    assert float((out.reshape(T, -1) - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float(weights.sum(dim=-1).sub(2.5).abs().max()) <= 1e-6
    ref_out, _ = FAMILY.experts(x, lp, {**SMALL, "first_expert": 8}, "f32")
    assert float((out - ref_out).abs().max()) <= 1e-5 * float(ref_out.abs().max())


def _old_norm(y, z, g, dtype):
    """The port's gated norm before the grouped one: norm before gate, over
    the whole width."""
    yf = y.to(torch.float32)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    return (yf * g).to(dtype) * F.silu(z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_grouped_gate_first_norm_and_the_unchanged_norm(dtype):
    """``gate_first``: ``g * RMS(y * silu(z))`` over each of the groups, by
    the formula; off, the port's norm is bit-equal to its earlier form."""
    gen = torch.Generator().manual_seed(7)
    y, z = (torch.randn((2, 5, 64), generator=gen).to(dtype) for _ in range(2))
    g = torch.rand(64, generator=gen) + 0.5
    got = ssm._gated_norm(y, z, g, 4, True, dtype)
    gated = (y.double() * F.silu(z.double())).reshape(2, 5, 4, 16)
    want = (gated / gated.square().mean(dim=-1, keepdim=True).add(1e-6).sqrt()) \
        .reshape(2, 5, 64) * g.double()
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    assert float((got.double() - want).abs().max()) <= tol * float(want.abs().max())
    assert not torch.equal(got, ssm._gated_norm(y, z, g, 1, True, dtype))
    assert torch.equal(ssm._gated_norm(y, z, g, 4, False, dtype), _old_norm(y, z, g, dtype))


def test_mamba2_370m_mixer_and_decode_are_unchanged():
    """mamba2-370m's reduced mixer (``gate_first`` off): the forward and a
    decode step equal the earlier norm-before-gate arithmetic bit for bit."""
    cfg = get_config("mamba2-370m").reduced()
    s = cfg.ssm
    assert not s.gate_first
    p = ssm.ssm_init(torch.Generator().manual_seed(1), cfg.d_model, d_inner=s.d_inner,
                     d_state=s.d_state, n_heads=s.n_heads, n_groups=s.n_groups, device="cpu")
    p["norm_g"] = p["norm_g"] + 0.25
    u = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(2))
    u = u.to(torch.bfloat16)
    kw = dict(d_inner=s.d_inner, d_state=s.d_state, n_heads=s.n_heads, n_groups=s.n_groups)
    got = ssm.mamba_forward(u, p, chunk=s.chunk, **kw)
    z, xbc, dt_raw = ssm._project(u, p)
    xbc = ssm._depthwise_conv(xbc, p["conv_w"], p["conv_b"])
    P = s.d_inner // s.n_heads
    x = xbc[..., :s.d_inner].reshape(2, 16, s.n_heads, P)
    nb = s.n_groups * s.d_state
    bm = xbc[..., s.d_inner:s.d_inner + nb].reshape(2, 16, s.n_groups, s.d_state)
    cm = xbc[..., s.d_inner + nb:].reshape(2, 16, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"]).to(u.dtype)
    y, _ = ssm.ssd_chunked(x, dt, p["A_log"], bm, cm, p["D"], chunk=s.chunk)
    want = layers.dense(_old_norm(y.reshape(2, 16, s.d_inner), z, p["norm_g"], u.dtype),
                        p["out_proj"])
    assert torch.equal(got, want)
    cache = ssm.mamba_init_cache(2, device="cpu", **kw)
    out, _ = ssm.mamba_decode(u[:, :1], cache, p, **kw)
    assert out.shape == (2, 1, cfg.d_model) and torch.isfinite(out.float()).all()


def test_softmax_swiglu_routing_and_rope_attention_are_unchanged():
    """The defaults: a softmax router with SwiGLU experts and rope GQA give
    what the earlier code gave, bit for bit (its arithmetic inline)."""
    gen = torch.Generator().manual_seed(3)
    lp = moe.moe_init(gen, 32, 16, 8, 1, device="cpu", n_held=4)
    assert set(lp["experts"]) == {"wi", "wg", "wo"}
    x = torch.randn((2, 8, 32), generator=gen).to(torch.bfloat16)
    got, aux = moe.moe_dropless(x, lp, n_routed=8, n_shared=1, top_k=2, norm_topk=True)
    flat = x.reshape(16, 32)
    logits = flat.float() @ lp["router"]
    gates = torch.softmax(logits, dim=-1)
    w, e = moe._top_k(gates, 2)
    w = moe._normalized(w)
    want = layers.swiglu(x, lp["shared"]).reshape(16, 32).float()
    for t in range(16):
        for c in range(2):
            if int(e[t, c]) < 4:
                one = {k: v[int(e[t, c])] for k, v in lp["experts"].items()}
                want[t] += float(w[t, c]) * layers.swiglu(flat[t:t + 1], one)[0].float()
    assert float((got.reshape(16, 32).float() - want).abs().max()) <= 2e-2
    counts = moe._one_hot(e, 8).sum(dim=1)
    assert torch.equal(aux["lb_loss"], 8 * torch.sum(gates.mean(dim=0) * counts.mean(dim=0)))
    p = attention.gqa_init(gen, 32, 4, 2, 8, device="cpu")
    pos = torch.arange(8)
    q = layers.apply_rope(attention._split_heads(layers.dense(x, p["wq"]), 4), pos, 1e4)
    k = layers.apply_rope(attention._split_heads(layers.dense(x, p["wk"]), 2), pos, 1e4)
    v = attention._split_heads(layers.dense(x, p["wv"]), 2)
    out = attention._sdpa(q, k, v, attention.causal_mask(8, device="cpu"))
    want = layers.dense(out.reshape(2, 8, -1), p["wo"])
    kw = dict(n_heads=4, n_kv=2, head_dim=8, theta=1e4)
    assert torch.equal(attention.gqa_forward(x, p, **kw), want)
    assert not torch.equal(attention.gqa_forward(x, p, rope=False, **kw), want)


def test_capacity_routing_refuses_a_sigmoid_router_or_relu2_experts():
    arch = _arch(SMALL)
    for spec in (dataclasses.replace(arch.moe, capacity_factor=1.25, n_held=None),
                 dataclasses.replace(arch.moe, capacity_factor=1.25, n_held=None,
                                     score="softmax", routed_scale=1.0)):
        with pytest.raises(ValueError):
            lm._moe(dataclasses.replace(arch, moe=spec), torch.zeros((1, 2, 64)), {})


def test_chunked_nope_attention_equals_the_square(f32, monkeypatch):
    """Past ``FLASH_THRESHOLD`` GQA runs chunked: without rope it equals the
    S x S path, and a position shift of the keys changes nothing."""
    p = attention.gqa_init(torch.Generator().manual_seed(1), 64, 4, 2, 24, device="cpu")
    x = torch.randn((1, 40, 64), generator=torch.Generator().manual_seed(2))
    kw = dict(n_heads=4, n_kv=2, head_dim=24, theta=1e4, rope=False)
    want = attention.gqa_forward(x, p, **kw)
    assert torch.equal(attention.gqa_forward(x, p, positions=torch.arange(40) + 7, **kw), want)
    monkeypatch.setattr(attention, "FLASH_THRESHOLD", 16)
    got = attention.gqa_forward(x, p, **kw)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_decode_after_prefill_matches_the_full_forward(f32):
    """A 10-token prompt fed through the decode caches (a Mamba2 state a
    ``M``, a KV cache a ``*``, none an ``E``), then 6 more tokens: each
    step's logits equal the full forward's at that position, and the last
    prompt position's equal the prefill's."""
    model = build_model(_arch(SMALL))
    params = weights.make(SMALL, 21, "cpu")
    tokens = _batch(22, B=2, S=16)["tokens"]
    caches = model.init_cache(2, 16, device="cpu")
    assert set(caches) == {"mamba", "attn"}
    assert caches["mamba"].h.shape[:2] == (1, 3) and caches["attn"].k.shape[:2] == (1, 1)
    caches = {"mamba": caches["mamba"],
              "attn": dataclasses.replace(caches["attn"], k=caches["attn"].k.float(),
                                          v=caches["attn"].v.float())}
    with torch.no_grad():
        full = model.logits(params, {"tokens": tokens})
        prefill = model.prefill(params, {"tokens": tokens[:, :10]})
        steps = []
        for t in range(16):
            logits, caches = model.decode_step(params, caches, tokens[:, t:t + 1])
            steps.append(logits)
    scale = float(full.abs().max())
    assert float((prefill - full[:, 9:10]).abs().max()) <= 1e-5 * scale
    for t, logits in enumerate(steps):
        assert float((logits - full[:, t:t + 1]).abs().max()) <= 1e-5 * scale, t


def test_the_forward_opens_the_ssm_and_moe_spans():
    params = weights.make(SMALL, 1, "cpu")
    trace.collect()
    trace.enable(True)
    try:
        build_model(_arch(SMALL)).loss(params, _batch(2))
    finally:
        trace.enable(False)
    names = [name for name, *_ in trace.collect()]
    assert names.count("model.ssm") == 3
    assert names.count("model.moe.route") == names.count("model.moe.experts") == 3
    assert "model.mla" not in names and set(names) <= set(trace.NAMES)


def test_remat_is_bit_equal():
    params = weights.make(SMALL, 6, "cpu")
    model, batch = build_model(_arch(SMALL)), _batch(7)
    grads = []
    for remat in (False, True):
        items = leaf_items(params)
        for _, leaf in items:
            leaf.grad = None
            leaf.requires_grad_(True)
        loss, _ = model.loss(params, batch, remat=remat)
        loss.backward()
        grads.append((loss.detach(), [leaf.grad.clone() for _, leaf in items]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_the_published_configuration_counts_its_parameters():
    """31,577,937,344 parameters on the meta device, the model card's
    31.6 B; the reduced configuration keeps the pattern's three kinds."""
    model = build_model(CONFIG)
    assert model.param_count(model.init(0, device="meta")) == 31_577_937_344
    assert CONFIG.n_periods == 1 and len(CONFIG.layer_pattern) == 52
    assert {k: CONFIG.layer_pattern.count(k) for k in "ME*"} == {"M": 23, "E": 23, "*": 6}
    small = CONFIG.reduced()
    assert set(small.layer_pattern) == {"M", "E", "*"}
    assert CONFIG.layer_pattern.startswith(small.layer_pattern)
    assert small.n_layers == len(small.layer_pattern) and small.ssm.gate_first
    params = build_model(small).init(0, device="cpu")
    assert set(params["blocks"]) == {"mamba", "moe", "attn"}
    assert set(params["blocks"]["moe"]["ffn"]["experts"]) == {"wi", "wo"}


def test_a_pattern_of_several_periods_walks_each_in_turn(f32):
    """Two periods of ``ME*``: the forward equals the layers walked one by
    one on the same leaves, and an unknown letter is refused."""
    arch = dataclasses.replace(_arch(SMALL), layer_pattern="ME*", n_layers=6)
    assert arch.n_periods == 2
    params = lm.lm_init(arch, 3, device="cpu")
    assert params["blocks"]["mamba"]["ln"].shape == (2, 1, 64)
    tokens = _batch(4)["tokens"]
    with torch.no_grad():
        got, _ = lm.lm_hidden(arch, params, tokens)
        h = layers.embed(tokens, params["embed"])
        for i in range(2):
            for stack, kind in (("mamba", "ssm"), ("moe", "moe"), ("attn", "attn")):
                h, _ = lm._block_fwd(arch, h, lm._layer(params["blocks"][stack], (i, 0)), kind)
        want = lm._norm(arch, h, params["final_ln"])
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        lm.lm_init(dataclasses.replace(arch, layer_pattern="M-"), 0, device="meta")
    with pytest.raises(ValueError):
        _ = dataclasses.replace(arch, n_layers=5).n_periods


BENCH_CONFIG = "nemotron-3-nano-l7e8"


def _bench_config():
    spec = json.loads((harness.cells.BENCH.parent / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in spec["configs"]}[BENCH_CONFIG]
    return json.loads((harness.cells.BENCH.parent / conf["file"]).read_text())


def test_the_benchmark_configuration_holds_its_stated_size():
    """528,092,736 parameters a node; 8 of 128 experts held, 7 of 52 layers
    (``MEMEM*E``) and 16,384 of 131,072 ids; the program's count equals
    the benchmark's layout."""
    cfg = _bench_config()
    lay = weights.layout(cfg)
    assert sum(math.prod(shape) for shape, _ in lay.values()) == cfg["params_per_node"] \
        == 528_092_736
    assert lay["blocks/moe/ffn/experts/wi"][0] == (1, 3, 8, 2688, 1856)
    assert lay["blocks/moe/ffn/router"][0] == (1, 3, 2688, 128)
    assert lay["blocks/mamba/mixer/conv_w"][0] == (1, 3, 4, 6144)
    assert lay["blocks/attn/attn/wq"][0] == (1, 1, 2688, 4096)
    assert cfg["published"] == {"num_hidden_layers": 52, "n_routed_experts": 128,
                                "vocab_size": 131072}
    assert [cfg[k] for k in cfg["reduced"]] == [cfg["n_layers"], 8, cfg["vocab"]] \
        == [7, 8, 16384]
    arch = _arch(cfg)
    assert arch.layer_pattern == "MEMEM*E" and not arch.rope and arch.hd == 128
    assert arch.moe.n_routed == 128 and arch.moe.held == 8 and arch.moe.n_shared == 2
    assert (arch.moe.score, arch.moe.routed_scale, arch.moe.act) == ("sigmoid", 2.5, "relu2")
    assert arch.ssm == dataclasses.replace(CONFIG.ssm) and arch.hd == CONFIG.hd
    model = build_model(arch)
    assert model.param_count(model.init(0, device="meta")) == 528_092_736
    flops = yardstick.model_flops_per_token(cfg, 4096) * 4 * 4096
    assert flops == pytest.approx(28.936e12, rel=1e-4)


def test_the_reference_dt_bias_inverts_softplus_over_the_published_range():
    cfg = _bench_config()
    bias = FAMILY.make_dt_bias(cfg)((1, 3, 64), "cpu")
    dt = F.softplus(bias[0, 0])
    assert float(dt[0]) == pytest.approx(1e-3, rel=1e-4)
    assert float(dt[-1]) == pytest.approx(0.1, rel=1e-4)
    assert torch.equal(bias[0, 0], bias[0, 2])


SMALL_CELL = "toy-nemotron-h.dcd-q4"


def small_cell_root(tmp_path):
    """A copy of the benchmark with the cell ``toy-nemotron-h.dcd-q4``: the
    configuration :data:`SMALL` under the toy DCD ``quant:4`` traffic (a
    ring of 4, 8 sequences of 32 tokens), on the toy limits."""
    root = toy_root(tmp_path, TOY_LIMITS)
    cfg = {**SMALL, "name": "toy-nemotron-h"}
    (root / "bench" / "configs" / "toy-nemotron-h.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-nemotron-h", "source": "a CPU test", "reduced": [],
                            "file": "bench/configs/toy-nemotron-h.json", "why": "a CPU test"})
    spec["workloads"].append({"name": SMALL_CELL, "config": "toy-nemotron-h",
                              "traffic": "toy-dcd-q4", "chips": 1, "why": "a CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(root / "bench" / "limits" / "toy-dense.dcd-q4.json",
                root / "bench" / "limits" / f"{SMALL_CELL}.json")
    return root


def test_a_small_cell_of_the_family_runs_correct_through_the_harness(tmp_path):
    """The family as a cell of a copy of the benchmark: the harness's
    program (``build_model`` -> ``make_dist_train_step``, DCD over
    ``quant:4`` on a ring of 4) against the reference, on the toy limits."""
    root = small_cell_root(tmp_path)
    got = run.run(root, SMALL_CELL, 2 ** 31 + 29, 0.2, trace=False, device="cpu",
                  started=time.perf_counter())
    assert got["correct"], got["checks"]
    assert TRAFFIC["n_nodes"] == 4


def test_the_expert_layer_reads_nothing_on_the_host_and_no_float64():
    """The sigmoid, relu^2 dropless layer's forward and backward, as the
    step runs them: no ``_local_scalar_dense``, ``nonzero`` or ``equal`` of
    a step tensor."""
    lp, x = _expert_layer(SMALL, 2, 0, 8)
    lp = lm._cast_weights(lp)
    x = x.to(layers.COMPUTE_DTYPE).requires_grad_(True)
    leaves = [leaf.requires_grad_(True) for _, leaf in leaf_items(lp)]
    watch = StepWatch("cpu")
    with watch:
        out, aux = _program_layer(SMALL, lp, x, 0)
        (out.float().square().mean() + aux["lb_loss"] + aux["z_loss"]).backward()
    assert watch.host_reads == [] and watch.f64_ops == []
    assert all(leaf.grad is not None for leaf in leaves)


def test_the_ssm_span_readers(tmp_path):
    """``model.ssm_host_ms_per_step`` reads the span's self host time of a
    traced window of the small cell (``bench/spans.py`` on the CPU) and
    nothing untraced; ``model.ssm_device_ms_per_step`` the device time a
    profiled step launched inside the span, and nothing without spans."""
    from bench import cells, spans

    root = small_cell_root(tmp_path)
    host = cells.metric_reader(root, "model.ssm_host_ms_per_step")
    device = cells.metric_reader(root, "model.ssm_device_ms_per_step")
    out = spans.measure(root, SMALL_CELL, 7, 0.3, device="cpu")
    assert out["self_host_ms"]["model.ssm"] > 0
    assert host({"spans": out["self_host_ms"]}) == out["self_host_ms"]["model.ssm"]
    assert host({"spans": {}}) is None and device({"profile": None}) is None
    rec = {"profile": {"steps": 2, "spans": {"model.ssm": [0.004, 30],
                                             "model.moe.route": [0.001, 8]}}}
    assert device(rec) == pytest.approx(2.0)
