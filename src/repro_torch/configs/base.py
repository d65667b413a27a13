"""Architecture config schema + registry.

The port's own copy of the JAX package's ``configs/base.py``: every field of
``ArchConfig`` and its specs, with the same ``vocab_padded``, ``hd``,
``is_encdec``, ``attention_free`` and ``reduced()`` arithmetic, so a config
built here and one built there have equal shapes.  Every architecture has one
file in this package defining ``CONFIG`` with its published hyperparameters
(source cited in the file); ``reduced()`` derives the CPU test variant (<= 2
layers, d_model <= 256, <= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """``n_routed`` is the router's width.  ``capacity_factor`` None routes
    dropless (every chosen expert computes its rows); a number bounds each
    expert's rows per token group and drops the rest.  Dropless, this
    device may hold a share of the experts, ``n_held`` of them from
    ``first_held`` (None: all): the router still scores all ``n_routed``
    and only the held experts' part of the output is computed.
    ``norm_topk`` divides the chosen weights by their sum.  ``score``: the
    router's softmax over its logits, or a sigmoid of each (DeepSeek-V3's
    and Nemotron-H's; dropless only); ``routed_scale`` multiplies the
    chosen weights; ``act``: the experts' SwiGLU (``wi``, ``wg``, ``wo``)
    or a non-gated ``relu(x wi)^2 wo`` (``relu2``), the shared experts'
    alike."""
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int
    capacity_factor: Optional[float] = 1.25
    dense_layers: Tuple[int, ...] = (0,)   # layers with a dense FFN instead of MoE
    d_ff_dense: int = 0                    # width of those dense FFNs
    norm_topk: bool = True
    first_held: int = 0
    n_held: Optional[int] = None
    score: str = "softmax"                 # softmax | sigmoid
    routed_scale: float = 1.0
    act: str = "swiglu"                    # swiglu | relu2

    @property
    def held(self) -> int:
        """Experts held here."""
        return self.n_routed if self.n_held is None else self.n_held


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """``gate_first``: the published Mamba2 gated norm, ``g * RMS(y *
    silu(z))`` over each of ``n_groups`` groups of the inner width; off,
    the port's norm-before-gate ``RMS(y) * g * silu(z)`` over the whole
    width."""
    d_inner: int
    d_state: int
    n_heads: int
    n_groups: int = 1
    chunk: int = 128
    gate_first: bool = False


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """``latent_norm``: an RMSNorm (eps 1e-6, a gain leaf ``kv_norm``) on the
    compressed latent ``c_kv``.  ``yarn``: YaRN rope scaling as DeepSeek-V2
    publishes it, ``(factor, original_max_position_embeddings, beta_fast,
    beta_slow, mscale, mscale_all_dim)`` (empty: plain rope)."""
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    latent_norm: bool = False
    yarn: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    kind: str            # 'vision' | 'audio': the encoder is a stub, the batch carries embeddings
    n_tokens: int        # patches / frames
    dim: int             # embedding dim coming out of the (stubbed) encoder


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e4
    norm: str = "rms"               # rms | ln
    act: str = "swiglu"             # swiglu | gelu
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    mla: Optional[MLASpec] = None
    frontend: Optional[FrontendSpec] = None
    encoder_layers: int = 0         # >0 => encoder-decoder (whisper)
    hybrid_period: int = 0          # >0 => every period-th layer is the SHARED attn block
    # a period of layers of three kinds (Nemotron-H's ``hybrid_override_pattern``):
    # 'M' a Mamba2 mixer, 'E' the experts, '*' attention, each its own pre-norm
    # residual layer; n_layers is a whole number of periods
    layer_pattern: str = ""
    rope: bool = True               # False: attention applies no position encoding
    long_context_window: int = 8192 # ring-buffer window used for long-context decode
    source: str = ""                # citation

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (embedding and LM head rows);
        the cross-entropy runs over the padded columns, as in the reference."""
        return -(-self.vocab // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_periods(self) -> int:
        """Periods of ``layer_pattern`` in the ``n_layers`` layers."""
        periods, rest = divmod(self.n_layers, len(self.layer_pattern))
        if rest:
            raise ValueError(f"{self.n_layers} layers are no whole number of periods "
                             f"{self.layer_pattern!r}")
        return periods

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4) or 4
        kv = min(self.n_kv_heads, heads) or heads
        changes = dict(
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=max(1, kv if heads % kv == 0 else heads),
            d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 512),
            head_dim=d // heads,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_routed=4, n_shared=min(self.moe.n_shared, 1),
                top_k=2, d_expert=64, d_ff_dense=min(self.moe.d_ff_dense, 256) or 256,
                first_held=0, n_held=None if self.moe.n_held is None else 2)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_inner=2 * d, d_state=16, n_heads=4, chunk=8,
                n_groups=min(self.ssm.n_groups, 4))
        if self.mla:
            changes["mla"] = dataclasses.replace(self.mla, kv_lora=32, qk_nope=16, qk_rope=8,
                                                 v_head=16)
        if self.frontend:
            # audio frames feed the encoder directly => dim must track d_model
            dim = d if self.frontend.kind == "audio" else 64
            changes["frontend"] = dataclasses.replace(self.frontend, n_tokens=8, dim=dim)
        if self.encoder_layers:
            changes["encoder_layers"] = 2
        if self.hybrid_period:
            changes["hybrid_period"] = 2
            changes["n_layers"] = 4
        if self.layer_pattern:
            # the shortest head of the period that holds each of its kinds
            ends = [self.layer_pattern.index(k) + 1 for k in set(self.layer_pattern)]
            changes["layer_pattern"] = self.layer_pattern[:max(ends)]
            changes["n_layers"] = max(ends)
        changes["long_context_window"] = 64
        return dataclasses.replace(self, **changes)


ARCH_IDS = (
    "internvl2-76b",
    "zamba2-7b",
    "deepseek-moe-16b",
    "whisper-base",
    "mistral-large-123b",
    "deepseek-v2-lite-16b",
    "codeqwen1.5-7b",
    "starcoder2-15b",
    "mamba2-370m",
    "granite-3-2b",
)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
