"""The token batches a training cell feeds, worked out without the program.

A frozen copy of the synthetic source the program's data pipeline
describes: node ``i`` of ``n`` reads its own Markov token walk, fixed by
(seed, step, node).  Hash: the 32-bit PCG-XSH-RR mix in int64 arithmetic
masked to 32 bits.  Transition logit of ``tok -> nxt``: a standard normal
(Box-Muller on two hash uniforms of ``(seed + 7919, tok, nxt)``) over the
concentration.  Next token: ``argmax(logit + gumbel)``, the Gumbel noise a
hash uniform of ``(seed, step, node, row, position, nxt)``.  First token:
the hash of ``(seed, step, node, row)`` mod vocab.

Run on the device the program ran on, the same operations give the same
tokens; the comparison counts every token that differs.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
CONCENTRATION = 0.3


def pcg_hash(x):
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def _mix(h, x):
    return pcg_hash((pcg_hash(h) ^ x) & MASK32)


def _uniform_open(h: torch.Tensor) -> torch.Tensor:
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _normal(h: torch.Tensor) -> torch.Tensor:
    u1 = _uniform_open(h)
    u2 = _uniform_open(pcg_hash(h ^ 0x9E3779B9))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def _row_keys(seed: int, step: int, nodes: int, per: int, device) -> torch.Tensor:
    node_ids = torch.arange(nodes, dtype=torch.int64, device=device)
    rows = torch.arange(per, dtype=torch.int64, device=device)
    base = _mix(torch.full((), seed & MASK32, dtype=torch.int64, device=device), step & MASK32)
    return _mix(_mix(base, node_ids)[:, None], rows[None, :]).reshape(-1, 1)


def _walks(seed: int, vocab: int, key: torch.Tensor, length: int) -> torch.Tensor:
    cand = torch.arange(vocab, dtype=torch.int64, device=key.device)
    tok = pcg_hash(key) % vocab
    out = [tok]
    for pos in range(length):
        gumbel = -torch.log(-torch.log(_uniform_open(_mix(_mix(key, pos), cand))))
        h = _mix(_mix(torch.full_like(tok, (seed + 7919) & MASK32), tok), cand)
        tok = torch.argmax(_normal(h) / CONCENTRATION + gumbel, dim=-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, dim=1)


def node_batches(seed: int, step: int, *, vocab: int, seq_len: int, global_batch: int,
                 nodes: int, device) -> dict:
    """Every node's tokens and next-token labels of one step, stacked:
    (nodes, global_batch // nodes, seq_len) int64."""
    per = global_batch // nodes
    seq = _walks(seed, vocab, _row_keys(seed, step, nodes, per, device), seq_len)
    seq = seq.reshape(nodes, per, seq_len + 1)
    return {"tokens": seq[..., :-1].contiguous(), "labels": seq[..., 1:].contiguous()}
