"""Architecture config schema (dense decoder slice).

A copy of the fields of the JAX package's ``ArchConfig`` that the dense
decoder path reads, with the same ``vocab_padded``, ``hd`` and ``reduced()``
arithmetic, so a config built here and one built there have equal shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e4
    norm: str = "rms"
    act: str = "swiglu"
    source: str = ""                # citation

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (embedding and LM head rows);
        the cross-entropy runs over the padded columns, as in the reference."""
        return -(-self.vocab // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (2 layers, d_model <= 256)."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4) or 4
        kv = min(self.n_kv_heads, heads) or heads
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=max(1, kv if heads % kv == 0 else heads),
            d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 512),
            head_dim=d // heads,
        )


ARCH_IDS = ("granite-3-2b",)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown or unported arch {arch_id!r}; ported: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
