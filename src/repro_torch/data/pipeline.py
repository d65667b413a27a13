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
package's for the same seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch

from repro_torch.kernels.ref import MASK32, pcg_hash


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    seed: int = 0
    markov_concentration: float = 0.3   # smaller = more structure (lower entropy)


def _mix(h, x):
    """Fold one more counter into a hash (int64 tensors or ints, in [0, 2^32))."""
    return pcg_hash((pcg_hash(h) ^ x) & MASK32)


def _uniform_open(h: torch.Tensor) -> torch.Tensor:
    """f32 uniform in (0, 1) from a 32-bit hash."""
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _transition_logits(cfg: DataConfig, tok: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """(R, 1) current tokens x (V,) candidates -> (R, V) normal logits / concentration."""
    h = _mix(_mix(torch.full_like(tok, (cfg.seed + 7919) & MASK32), tok), nxt)
    u1 = _uniform_open(h)
    u2 = _uniform_open(pcg_hash(h ^ 0x9E3779B9))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z / cfg.markov_concentration


def _markov_rows(cfg: DataConfig, step: int, shards: Sequence[int], device) -> torch.Tensor:
    """(len(shards) * per_shard, seq_len + 1) int64 token walks."""
    per = cfg.global_batch // cfg.n_shards
    shard_ids = torch.tensor(list(shards), dtype=torch.int64, device=device)
    rows = torch.arange(per, dtype=torch.int64, device=device)
    base = _mix(torch.full((), cfg.seed & MASK32, dtype=torch.int64, device=device), step & MASK32)
    key = _mix(_mix(base, shard_ids)[:, None], rows[None, :]).reshape(-1, 1)   # (R, 1)
    cand = torch.arange(cfg.vocab, dtype=torch.int64, device=device)
    tok = pcg_hash(key) % cfg.vocab
    seq = [tok]
    for pos in range(cfg.seq_len):
        noise = _uniform_open(_mix(_mix(key, pos), cand))
        gumbel = -torch.log(-torch.log(noise))
        tok = torch.argmax(_transition_logits(cfg, tok, cand) + gumbel, dim=-1, keepdim=True)
        seq.append(tok)
    return torch.cat(seq, dim=1)


def _batch(seq: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"tokens": seq[..., :-1].contiguous(), "labels": seq[..., 1:].contiguous()}


def sample_batch(cfg: DataConfig, step: int, shard: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic batch of one shard: tokens and next-token labels
    (per_shard, seq_len) int64."""
    if not 0 <= shard < cfg.n_shards:
        raise ValueError(f"shard {shard} out of range for {cfg.n_shards} shards")
    return _batch(_markov_rows(cfg, step, [shard], device))


def stacked_node_batches(cfg: DataConfig, step: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """All shards stacked on a leading node axis: (n_shards, per_shard, seq_len)."""
    per = cfg.global_batch // cfg.n_shards
    seq = _markov_rows(cfg, step, range(cfg.n_shards), device)
    return _batch(seq.reshape(cfg.n_shards, per, cfg.seq_len + 1))
