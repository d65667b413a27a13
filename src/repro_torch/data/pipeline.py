"""Deterministic synthetic token data with per-node shards.

The port of the JAX package's ``data/pipeline.py``: every node reads its own
deterministic Markov token stream — shard ``i`` of ``n`` — fully determined
by (seed, step, shard), so the same batch comes back on any restart.

The JAX package samples each next token from a dense (vocab, vocab) matrix of
normal transition logits with threefry keys.  At a 49k vocab that matrix is
9.7 GB, so the port keeps the same kind of source without materialising it:

* the transition logit of ``tok -> nxt`` is a standard normal (Box-Muller on
  two PCG-hash uniforms of ``(seed + 7919, tok, nxt)``) over
  ``markov_concentration``, recomputed for the rows in flight only;
* the next token is drawn by Gumbel-max: ``argmax_nxt(logit + gumbel)``, the
  Gumbel noise a PCG-hash uniform of ``(seed, step, shard, row, position,
  nxt)``; the first token is the hash of ``(seed, step, shard, row)`` mod
  vocab.

The generator is the counter-based PCG hash of ``kernels/ref.py`` in int64
arithmetic: deterministic on a given device (the float ``log``/``cos`` of
the CPU and the GPU may round differently, so a near-tie can resolve to
another token across devices), and not threefry: batches differ from the JAX
package's for the same seed.  On the card the whole walk of a batch is one
kernel (``kernels/markov.py``), bit-equal to the eager walk there; a CPU key
takes the eager walk (``kernels/ref.py`` ``markov_walk_ref``).

For a frontend (VLM patches, audio frames) a batch also carries
``extra_embeds`` (per_shard, n_tokens, dim): standard normals (Box-Muller on
PCG-hash uniforms of ``(seed, step, shard, row, index)`` in a stream of their
own) standing in for the stubbed encoders' output, as the JAX pipeline's
normal draws do; a vision frontend's patches take ``n_tokens`` of the
``seq_len`` positions, so its text is that much shorter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import torch

from repro_torch.configs.base import ArchConfig

from repro_torch.kernels.markov import markov_walk
from repro_torch.kernels.ref import MASK32, mix_hash, normal_from_hash
from repro_torch.trace import span


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    seed: int = 0
    markov_concentration: float = 0.3   # smaller = more structure (lower entropy)


_EMBED_STREAM = 0x5A17E3B1


def _row_keys(cfg: DataConfig, step: int, shards: Sequence[int], device) -> torch.Tensor:
    """(len(shards) * per_shard, 1) int64 hash of (seed, step, shard, row)."""
    per = cfg.global_batch // cfg.n_shards
    shard_ids = torch.tensor(list(shards), dtype=torch.int64, device=device)
    rows = torch.arange(per, dtype=torch.int64, device=device)
    base = mix_hash(torch.full((), cfg.seed & MASK32, dtype=torch.int64, device=device),
                    step & MASK32)
    return mix_hash(mix_hash(base, shard_ids)[:, None], rows[None, :]).reshape(-1, 1)


def _markov_rows(cfg: DataConfig, key: torch.Tensor, length: int) -> torch.Tensor:
    """(R, length + 1) int64 token walks, one a row key: one kernel launch for
    a CUDA key, the eager walk for a CPU key (``kernels/markov.py``)."""
    return markov_walk(key, vocab=cfg.vocab, length=length, seed=cfg.seed,
                       concentration=cfg.markov_concentration)


def _frontend_embeds(key: torch.Tensor, n_tokens: int, dim: int) -> torch.Tensor:
    """(R, n_tokens, dim) float32 standard normals, one stream a row key."""
    idx = torch.arange(n_tokens * dim, dtype=torch.int64, device=key.device)
    h = mix_hash(mix_hash(key ^ _EMBED_STREAM, 0), idx)
    return normal_from_hash(h).reshape(-1, n_tokens, dim)


def _text_len(cfg: DataConfig, arch: Optional[ArchConfig]) -> int:
    if arch is not None and arch.frontend is not None and arch.frontend.kind == "vision":
        return cfg.seq_len - arch.frontend.n_tokens
    return cfg.seq_len


def _batch(cfg: DataConfig, key: torch.Tensor, arch: Optional[ArchConfig],
           lead: tuple) -> Dict[str, torch.Tensor]:
    seq = _markov_rows(cfg, key, _text_len(cfg, arch))
    seq = seq.reshape(lead + seq.shape[1:])
    out = {"tokens": seq[..., :-1].contiguous(), "labels": seq[..., 1:].contiguous()}
    if arch is not None and arch.frontend is not None:
        e = _frontend_embeds(key, arch.frontend.n_tokens, arch.frontend.dim)
        out["extra_embeds"] = e.reshape(lead + e.shape[1:])
    return out


def sample_batch(cfg: DataConfig, step: int, shard: int, arch: Optional[ArchConfig] = None, *,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic batch of one shard: tokens and next-token labels
    (per_shard, S_text) int64, and ``extra_embeds`` for a frontend ``arch``."""
    if not 0 <= shard < cfg.n_shards:
        raise ValueError(f"shard {shard} out of range for {cfg.n_shards} shards")
    per = cfg.global_batch // cfg.n_shards
    with span("data.batch", step):
        return _batch(cfg, _row_keys(cfg, step, [shard], device), arch, (per,))


def iterate(cfg: DataConfig, shard: int, arch: Optional[ArchConfig] = None,
            start_step: int = 0, *, device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Shard ``shard``'s batches of steps ``start_step, start_step + 1, ...``."""
    step = start_step
    while True:
        yield sample_batch(cfg, step, shard, arch, device=device)
        step += 1


def stacked_node_batches(cfg: DataConfig, step: int, arch: Optional[ArchConfig] = None, *,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """All shards stacked on a leading node axis: (n_shards, per_shard, ...)."""
    per = cfg.global_batch // cfg.n_shards
    with span("data.batch", step):
        return _batch(cfg, _row_keys(cfg, step, range(cfg.n_shards), device), arch,
                      (cfg.n_shards, per))
