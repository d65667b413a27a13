"""Decoder-only language models: dense / MoE / SSM / hybrid / VLM backbone.

The port of the JAX package's ``models/lm.py``.  Layers are stacked along a
leading layer axis (``params["blocks"][...][l]``), exactly like the JAX tree,
and the forward walks that axis in a Python loop where JAX scans it.  The
hybrid (Zamba2) walks periods of Mamba layers (``params["pm"]`` with leading
axes ``(n_periods, per_period)``), each followed by ONE shared attention
block whose parameters are reused at every application (true parameter
sharing: its gradient is the sum over its applications); each application
still owns its own KV cache.  A layer pattern (Nemotron-H's
``hybrid_override_pattern``, ``cfg.layer_pattern``) stacks each kind of
layer on its own: ``params["blocks"]`` holds ``mamba``, ``moe`` and
``attn``, each with leading axes ``(n_periods, layers of the kind a
period)``, and each period walks its pattern, taking each kind's next
layer.  Weights stay float32; the forward casts every
float32 leaf of rank >= 2 of a layer to bf16 at the top of the layer
(``_cast_weights``, as JAX does), and the decode step casts each matrix at
use.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    Params,
    chunked_softmax_xent,
    dense,
    dense_init,
    embed,
    embed_init,
    gelu,
    gelu_mlp,
    gelu_mlp_init,
    generator,
    layernorm,
    layernorm_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
)
from repro_torch.tree import unstack


def _norm_init(cfg: ArchConfig, d: int, *, device, lead: tuple = ()):
    return rmsnorm_init(d, device=device, lead=lead) if cfg.norm == "rms" \
        else layernorm_init(d, device=device, lead=lead)


def _norm(cfg: ArchConfig, x, p):
    return rmsnorm(x, p) if cfg.norm == "rms" else layernorm(x, p)


def _mlp_init(cfg: ArchConfig, gen, d: int, d_ff: int, *, device, lead: tuple = ()):
    init = swiglu_init if cfg.act == "swiglu" else gelu_mlp_init
    return init(gen, d, d_ff, device=device, lead=lead)


def _mlp(cfg: ArchConfig, x, p):
    return swiglu(x, p) if cfg.act == "swiglu" else gelu_mlp(x, p)


# ----------------------------------------------------------------- blocks

def _attn_init(cfg: ArchConfig, gen, *, device, lead: tuple) -> Params:
    if cfg.mla:
        m = cfg.mla
        return attn.mla_init(gen, cfg.d_model, cfg.n_heads, kv_lora=m.kv_lora,
                             qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_head=m.v_head,
                             device=device, lead=lead, latent_norm=m.latent_norm)
    return attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         device=device, lead=lead)


def _attn_fwd(cfg: ArchConfig, x, p) -> torch.Tensor:
    if cfg.mla:
        m = cfg.mla
        return attn.mla_forward(x, p, n_heads=cfg.n_heads, kv_lora=m.kv_lora,
                                qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_head=m.v_head,
                                theta=cfg.rope_theta, latent_norm=m.latent_norm, yarn=m.yarn)
    return attn.gqa_forward(x, p, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                            head_dim=cfg.hd, theta=cfg.rope_theta, rope=cfg.rope)


def _moe_init(cfg: ArchConfig, gen, *, device, lead: tuple) -> Params:
    m = cfg.moe
    return moe_lib.moe_init(gen, cfg.d_model, m.d_expert, m.n_routed, m.n_shared,
                            device=device, lead=lead, n_held=m.n_held, act=m.act)


def _block_init(cfg: ArchConfig, gen, kind: str, *, device, lead: tuple) -> Params:
    """kind: 'attn_dense' | 'attn_dense_moe0' | 'attn_moe' | 'ssm', or a
    pattern's 'moe' (experts only) | 'attn' (attention only)."""
    d = cfg.d_model
    if kind == "ssm":
        s = cfg.ssm
        return {"ln": _norm_init(cfg, d, device=device, lead=lead),
                "mixer": ssm_lib.ssm_init(gen, d, d_inner=s.d_inner, d_state=s.d_state,
                                          n_heads=s.n_heads, n_groups=s.n_groups,
                                          device=device, lead=lead)}
    if kind == "moe":
        return {"ln": _norm_init(cfg, d, device=device, lead=lead),
                "ffn": _moe_init(cfg, gen, device=device, lead=lead)}
    if kind == "attn":
        return {"ln": _norm_init(cfg, d, device=device, lead=lead),
                "attn": _attn_init(cfg, gen, device=device, lead=lead)}
    p = {"ln1": _norm_init(cfg, d, device=device, lead=lead),
         "attn": _attn_init(cfg, gen, device=device, lead=lead),
         "ln2": _norm_init(cfg, d, device=device, lead=lead)}
    if kind == "attn_moe":
        p["ffn"] = _moe_init(cfg, gen, device=device, lead=lead)
    else:
        d_ff = cfg.moe.d_ff_dense if (cfg.moe and kind == "attn_dense_moe0") else cfg.d_ff
        p["ffn"] = _mlp_init(cfg, gen, d, d_ff, device=device, lead=lead)
    return p


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z}


def _moe(cfg: ArchConfig, x, p):
    m = cfg.moe
    if m.capacity_factor is None:
        return moe_lib.moe_dropless(x, p, n_routed=m.n_routed, n_shared=m.n_shared,
                                    top_k=m.top_k, norm_topk=m.norm_topk,
                                    first_held=m.first_held, score=m.score,
                                    routed_scale=m.routed_scale, act=m.act)
    if m.held != m.n_routed or not m.norm_topk or \
            (m.score, m.routed_scale, m.act) != ("softmax", 1.0, "swiglu"):
        raise ValueError("a share of the experts, unnormalized or scaled weights, a sigmoid "
                         "router and relu2 experts route dropless: capacity_factor None")
    return moe_lib.moe_forward(x, p, n_routed=m.n_routed, n_shared=m.n_shared,
                               top_k=m.top_k, capacity_factor=m.capacity_factor)


def _block_fwd(cfg: ArchConfig, h, p, kind: str) -> Tuple[torch.Tensor, Dict]:
    aux = _zero_aux(h.device)
    if kind == "ssm":
        s = cfg.ssm
        h = h + ssm_lib.mamba_forward(_norm(cfg, h, p["ln"]), p["mixer"],
                                      d_inner=s.d_inner, d_state=s.d_state,
                                      n_heads=s.n_heads, n_groups=s.n_groups, chunk=s.chunk,
                                      gate_first=s.gate_first)
        return h, aux
    if kind == "moe":
        y, aux = _moe(cfg, _norm(cfg, h, p["ln"]), p["ffn"])
        return h + y, aux
    if kind == "attn":
        return h + _attn_fwd(cfg, _norm(cfg, h, p["ln"]), p["attn"]), aux
    h = h + _attn_fwd(cfg, _norm(cfg, h, p["ln1"]), p["attn"])
    x = _norm(cfg, h, p["ln2"])
    if kind == "attn_moe":
        y, aux = _moe(cfg, x, p["ffn"])
    else:
        y = _mlp(cfg, x, p["ffn"])
    return h + y, aux


# ----------------------------------------------------------------- layer stacks

def _layer_kind(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.moe:
        return "attn_moe"
    return "attn_dense"


# a pattern's letters -> the stack of params["blocks"] and the kind of layer
PATTERN = {"M": ("mamba", "ssm"), "E": ("moe", "moe"), "*": ("attn", "attn")}


def pattern_counts(cfg: ArchConfig) -> Dict[str, int]:
    """Layers of each stack in a period of ``cfg.layer_pattern``, in the
    order the pattern first names them."""
    counts: Dict[str, int] = {}
    for letter in cfg.layer_pattern:
        if letter not in PATTERN:
            raise ValueError(f"layer pattern {cfg.layer_pattern!r}: no kind of layer "
                             f"{letter!r}; known {sorted(PATTERN)}")
        stack = PATTERN[letter][0]
        counts[stack] = counts.get(stack, 0) + 1
    return counts


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    n_periods: int        # full (period-1 mamba + shared attn) groups
    per_period: int       # mamba layers per period
    tail: int             # trailing mamba layers

    @staticmethod
    def of(cfg: ArchConfig) -> "HybridLayout":
        per = cfg.hybrid_period - 1
        n_p = cfg.n_layers // cfg.hybrid_period
        tail = cfg.n_layers - n_p * cfg.hybrid_period
        return HybridLayout(n_periods=n_p, per_period=per, tail=tail)


def lm_init(cfg: ArchConfig, seed: int, *, device) -> Params:
    """Random float32 parameters from ``seed`` (a torch.Generator on
    ``device``), with the JAX package's keys, shapes and init scales; the
    values are torch's, not threefry's."""
    gen = generator(seed, device)
    d = cfg.d_model
    p: Params = {
        # padded vocab: embedding rows and LM head columns
        "embed": embed_init(gen, cfg.vocab_padded, d, device=device),
        "final_ln": _norm_init(cfg, d, device=device),
        "lm_head": dense_init(gen, d, cfg.vocab_padded, device=device, scale=0.02),
    }
    if cfg.frontend and cfg.frontend.kind == "vision":
        p["proj"] = {"w1": dense_init(gen, cfg.frontend.dim, d, device=device),
                     "w2": dense_init(gen, d, d, device=device)}
    if cfg.hybrid_period:
        lay = HybridLayout.of(cfg)
        p["pm"] = _block_init(cfg, gen, "ssm", device=device,
                              lead=(lay.n_periods, lay.per_period))
        if lay.tail:
            p["tail"] = _block_init(cfg, gen, "ssm", device=device, lead=(lay.tail,))
        p["shared_attn"] = {
            "ln1": _norm_init(cfg, d, device=device),
            "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, device=device),
            "ln2": _norm_init(cfg, d, device=device),
            "mlp": _mlp_init(cfg, gen, d, cfg.d_ff, device=device)}
        return p
    if cfg.layer_pattern:
        kinds = dict(PATTERN.values())
        p["blocks"] = {stack: _block_init(cfg, gen, kinds[stack], device=device,
                                          lead=(cfg.n_periods, n))
                       for stack, n in pattern_counts(cfg).items()}
        return p
    kind = _layer_kind(cfg)
    if cfg.moe and cfg.moe.dense_layers:
        n_dense = len(cfg.moe.dense_layers)
        p["blocks0"] = _block_init(cfg, gen, "attn_dense_moe0", device=device, lead=(n_dense,))
        p["blocks"] = _block_init(cfg, gen, kind, device=device, lead=(cfg.n_layers - n_dense,))
    else:
        p["blocks"] = _block_init(cfg, gen, kind, device=device, lead=(cfg.n_layers,))
    return p


def _layer(tree: Any, idx) -> Any:
    """One layer's parameters (or cache tensors) of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


def _n_stacked(tree: Any, axis: int = 0) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[axis]


def _cast_weights(lp: Any) -> Any:
    """Cast a layer's float32 leaves of rank >= 2 to bf16 (numerics
    unchanged: ``dense`` casts at use anyway).  1-D parameters (norm gains,
    SSM decay vectors) stay float32; the SSM's ``conv_w`` is cast.  The MoE
    router stays float32 too: the capacity path casts it at use, the
    dropless path takes its logits in float32."""
    if isinstance(lp, dict):
        return {k: v if k == "router" else _cast_weights(v) for k, v in lp.items()}
    return lp.to(COMPUTE_DTYPE) if (lp.dim() >= 2 and lp.dtype == torch.float32) else lp


def run_layer(fn, h, lp, remat: bool):
    """``fn(h, lp)``; with ``remat`` under ``torch.utils.checkpoint``, so the
    layer keeps only its input for the backward pass and recomputes the
    rest there (JAX's ``jax.checkpoint`` of a scanned block with
    ``nothing_saveable``).  The recompute is the same arithmetic, so losses
    and gradients are bit-equal either way."""
    if not remat:
        return fn(h, lp)
    return torch.utils.checkpoint.checkpoint(fn, h, lp, use_reentrant=False)


def _add_aux(total: Dict, aux: Dict) -> Dict:
    """The aux terms of the layers so far and one more layer's: sums, but
    the largest ``moe_max_load``."""
    out = dict(total)
    for k, v in aux.items():
        out[k] = v if k not in total else (
            torch.maximum(total[k], v) if k == "moe_max_load" else total[k] + v)
    return out


def _run_blocks(cfg: ArchConfig, h, stacked: Params, kind: str, remat: bool = False):
    """Walk a stack of layers; returns h and the aux terms over its layers
    (:func:`_add_aux`).  Each layer casts its weights inside the recomputed
    region, as JAX's body."""
    total = _zero_aux(h.device)

    def block(hh, lp):
        return _block_fwd(cfg, hh, _cast_weights(lp), kind)

    for lp in unstack(stacked):
        h, aux = run_layer(block, h, lp, remat)
        total = _add_aux(total, aux)
    return h, total


def _run_pattern(cfg: ArchConfig, h, blocks: Params, remat: bool = False):
    """Walk each period of ``blocks`` (:data:`PATTERN`'s stacks) through the
    layer pattern, each letter taking its stack's next layer; h and the aux
    terms over the layers (:func:`_add_aux`)."""
    total = _zero_aux(h.device)
    fns = {stack: functools.partial(_pattern_block, cfg, kind)
           for stack, kind in PATTERN.values()}
    for period in unstack(blocks):
        layers = {stack: iter(unstack(tree)) for stack, tree in period.items()}
        for letter in cfg.layer_pattern:
            stack = PATTERN[letter][0]
            h, aux = run_layer(fns[stack], h, next(layers[stack]), remat)
            total = _add_aux(total, aux)
    return h, total


def _pattern_block(cfg: ArchConfig, kind: str, h, lp):
    return _block_fwd(cfg, h, _cast_weights(lp), kind)


def _shared_attn_fwd(cfg: ArchConfig, h, sa: Params):
    h = h + attn.gqa_forward(_norm(cfg, h, sa["ln1"]), sa["attn"], n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta)
    return h + _mlp(cfg, _norm(cfg, h, sa["ln2"]), sa["mlp"])


def lm_hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
              extra_embeds: Optional[torch.Tensor] = None, remat: bool = False):
    """Token ids (+ optional frontend embeddings, prepended) -> final hidden
    states (bf16) and the summed aux losses.  ``remat`` checkpoints every
    block of the main stacks (not the dense first layers ``blocks0`` or the
    hybrid's shared attention, as in JAX)."""
    h = embed(tokens, params["embed"])
    if extra_embeds is not None:
        e = extra_embeds.to(COMPUTE_DTYPE)
        if "proj" in params:
            e = dense(gelu(dense(e, params["proj"]["w1"])), params["proj"]["w2"])
        h = torch.cat([e, h], dim=1)
    aux = _zero_aux(h.device)
    if cfg.hybrid_period:
        lay = HybridLayout.of(cfg)
        sa = _cast_weights(params["shared_attn"])
        for period in unstack(params["pm"]):
            h, a2 = _run_blocks(cfg, h, period, "ssm", remat)
            aux = _add_aux(aux, a2)
            h = _shared_attn_fwd(cfg, h, sa)
        if lay.tail:
            h, a2 = _run_blocks(cfg, h, params["tail"], "ssm", remat)
            aux = _add_aux(aux, a2)
    elif cfg.layer_pattern:
        h, aux = _run_pattern(cfg, h, params["blocks"], remat)
    else:
        if "blocks0" in params:
            # the dense first layers' aux (zeros) is not added, as in JAX
            h, _ = _run_blocks(cfg, h, params["blocks0"], "attn_dense_moe0")
        h, aux = _run_blocks(cfg, h, params["blocks"], _layer_kind(cfg), remat)
    h = _norm(cfg, h, params["final_ln"])
    return h, aux


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            remat: bool = False):
    """batch: tokens (B,S_text), labels (B,S_text), optional
    extra_embeds/loss_mask.  The frontend positions carry no loss."""
    extra = batch.get("extra_embeds")
    h, aux = lm_hidden(cfg, params, batch["tokens"], extra, remat)
    n_front = 0 if extra is None else extra.shape[1]
    xent = chunked_softmax_xent(h[:, n_front:], params["lm_head"], batch["labels"],
                                batch.get("loss_mask"))
    loss = xent + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, {"xent": xent, **aux}


def lm_logits(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
              extra_embeds: Optional[torch.Tensor] = None):
    h, _ = lm_hidden(cfg, params, tokens, extra_embeds)
    return dense(h, params["lm_head"])[..., : cfg.vocab]


# ----------------------------------------------------------------- decode

def lm_init_cache(cfg: ArchConfig, B: int, capacity: int, window: Optional[int] = None, *,
                  device) -> Dict[str, Any]:
    """Stacked decode caches (leading axes = the layer axes of the params)."""
    def attn_cache(lead):
        if cfg.mla:
            m = cfg.mla
            return attn.mla_init_cache(B, capacity, m.kv_lora, m.qk_rope, device=device,
                                       lead=lead)
        return attn.gqa_init_cache(B, capacity, cfg.n_kv_heads, cfg.hd, window=window,
                                   device=device, lead=lead)

    def ssm_cache(lead):
        s = cfg.ssm
        return ssm_lib.mamba_init_cache(B, d_inner=s.d_inner, d_state=s.d_state,
                                        n_heads=s.n_heads, n_groups=s.n_groups,
                                        device=device, lead=lead)

    if cfg.hybrid_period:
        lay = HybridLayout.of(cfg)
        caches = {"pm": ssm_cache((lay.n_periods, lay.per_period)),
                  "attn": attn_cache((lay.n_periods,))}
        if lay.tail:
            caches["tail"] = ssm_cache((lay.tail,))
        return caches
    if cfg.layer_pattern:
        # a cache for each Mamba2 and attention layer; the experts keep none
        makes = {"mamba": ssm_cache, "attn": attn_cache}
        return {stack: makes[stack]((cfg.n_periods, n))
                for stack, n in pattern_counts(cfg).items() if stack in makes}
    make = ssm_cache if cfg.family == "ssm" else attn_cache
    n_dense = len(cfg.moe.dense_layers) if (cfg.moe and cfg.moe.dense_layers) else 0
    caches = {"blocks": make((cfg.n_layers - n_dense,))}
    if n_dense:
        caches["blocks0"] = make((n_dense,))
    return caches


def _layer_cache(cache, idx):
    """One layer's view of a stacked cache: its tensors indexed by ``idx``
    (writes land in the stack), the position shared."""
    return dataclasses.replace(cache, **{f.name: getattr(cache, f.name)[idx]
                                         for f in dataclasses.fields(cache)
                                         if isinstance(getattr(cache, f.name), torch.Tensor)})


def _attn_decode(cfg: ArchConfig, x, cache, p):
    if cfg.mla:
        m = cfg.mla
        return attn.mla_decode(x, cache, p, n_heads=cfg.n_heads, kv_lora=m.kv_lora,
                               qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_head=m.v_head,
                               theta=cfg.rope_theta, latent_norm=m.latent_norm, yarn=m.yarn)
    return attn.gqa_decode(x, cache, p, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                           head_dim=cfg.hd, theta=cfg.rope_theta, rope=cfg.rope)


def _block_decode(cfg: ArchConfig, x, cache, p, kind: str):
    """One layer's decode step against its cache (written in place)."""
    if kind == "ssm":
        s = cfg.ssm
        y, _ = ssm_lib.mamba_decode(_norm(cfg, x, p["ln"]), cache, p["mixer"],
                                    d_inner=s.d_inner, d_state=s.d_state,
                                    n_heads=s.n_heads, n_groups=s.n_groups,
                                    gate_first=s.gate_first)
        return x + y
    if kind == "moe":
        return x + _moe(cfg, _norm(cfg, x, p["ln"]), p["ffn"])[0]
    if kind == "attn":
        return x + _attn_decode(cfg, _norm(cfg, x, p["ln"]), cache, p["attn"])[0]
    y, _ = _attn_decode(cfg, _norm(cfg, x, p["ln1"]), cache, p["attn"])
    x = x + y
    z = _norm(cfg, x, p["ln2"])
    y = _moe(cfg, z, p["ffn"])[0] if kind == "attn_moe" else _mlp(cfg, z, p["ffn"])
    return x + y


def _advanced(cache):
    return dataclasses.replace(cache, pos=cache.pos + 1)


@torch.no_grad()
def lm_decode_step(cfg: ArchConfig, params: Params, caches: Dict[str, Any],
                   tokens: torch.Tensor):
    """One decode step: tokens (B,1) -> logits (B,1,V) and the caches with
    the position advanced (their tensors written in place)."""
    x = embed(tokens, params["embed"])

    def run(x, stacked_p, cache, kind, lead=()):
        for l in range(_n_stacked(stacked_p, len(lead))):
            idx = lead + (l,)
            x = _block_decode(cfg, x, _layer_cache(cache, idx), _layer(stacked_p, idx), kind)
        return x

    if cfg.hybrid_period:
        lay = HybridLayout.of(cfg)
        sa, at = params["shared_attn"], caches["attn"]
        for i in range(lay.n_periods):
            x = run(x, params["pm"], caches["pm"], "ssm", (i,))
            y, _ = attn.gqa_decode(_norm(cfg, x, sa["ln1"]), _layer_cache(at, i), sa["attn"],
                                   n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                   theta=cfg.rope_theta)
            x = x + y
            x = x + _mlp(cfg, _norm(cfg, x, sa["ln2"]), sa["mlp"])
        if lay.tail:
            x = run(x, params["tail"], caches["tail"], "ssm")
    elif cfg.layer_pattern:
        for i in range(cfg.n_periods):
            taken = dict.fromkeys(pattern_counts(cfg), 0)
            for letter in cfg.layer_pattern:
                stack, kind = PATTERN[letter]
                idx = (i, taken[stack])
                taken[stack] += 1
                cache = _layer_cache(caches[stack], idx) if stack in caches else None
                x = _block_decode(cfg, x, cache, _layer(params["blocks"][stack], idx), kind)
    else:
        if "blocks0" in params:
            x = run(x, params["blocks0"], caches["blocks0"], "attn_dense_moe0")
        x = run(x, params["blocks"], caches["blocks"], _layer_kind(cfg))
    x = _norm(cfg, x, params["final_ln"])
    logits = dense(x, params["lm_head"])[..., : cfg.vocab]
    return logits, {k: _advanced(c) for k, c in caches.items()}
