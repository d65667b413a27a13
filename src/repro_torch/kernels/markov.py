"""Wrapper of the data layer's Markov walk kernel (``csrc/markov.cu``).

:func:`markov_walk` draws every row's token walk of a batch: the first token
the row key's hash mod ``vocab``, each next one ``argmax(logits + gumbel)``
over the whole vocabulary (``kernels/ref.py``, :func:`~repro_torch.kernels.
ref.markov_walk_ref`).  Same contract as ``kernels/quant.py``: it checks
device, dtype, shape and contiguity, runs the plain version for a CPU key,
and for a CUDA key launches the kernel on the current stream or raises;
there is no fallback.  ``launches`` counts its kernel launches, ``calls``
every call, the plain version's too, so ``launches / calls`` is the share
of batch calls that took the kernel; both are read and reset with the wire
kernels' counts (``kernels/quant.py`` :data:`~repro_torch.kernels.quant.
KERNEL_WRAPPERS`).

On the card the tokens are bit-equal to the plain version's on the card
(the eager walk); the CPU's ``log``/``cos`` may round otherwise, so a
near-tie can resolve to another token across devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import MASK32, markov_walk_ref

MAX_CLUSTER = 16      # CTAs a row at most (the largest non-portable cluster)


def cluster_size(rows: int, sms: int) -> int:
    """CTAs a row: the largest power of two ``c <= MAX_CLUSTER`` with ``rows
    * c <= sms`` (1 when even one a row oversubscribes the card), so a batch
    of few rows still spreads its vocabulary over the SMs."""
    c = 1
    while c < MAX_CLUSTER and rows * c * 2 <= sms:
        c *= 2
    return c


def inv_concentration(concentration: float) -> float:
    """The f32 reciprocal that torch's CUDA ``div`` by a host scalar
    multiplies by: ``f32(1) / f32(concentration)``."""
    return float(np.float32(1.0) / np.float32(concentration))


def _check(key: torch.Tensor, vocab: int, length: int, concentration: float) -> int:
    if key.dtype != torch.int64:
        raise TypeError(f"key must be torch.int64, got {key.dtype}")
    if key.dim() != 2 or key.shape[1] != 1:
        raise ValueError(f"key must have shape (rows, 1), got {tuple(key.shape)}")
    if not key.is_contiguous():
        raise ValueError("key must be contiguous")
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"markov_walk runs on cpu or cuda tensors, got {key.device}")
    if not 1 <= vocab < 2 ** 31 or length < 0:
        raise ValueError(f"need 1 <= vocab < 2^31 and length >= 0, got {vocab}, {length}")
    if not concentration > 0:
        raise ValueError(f"concentration must be > 0, got {concentration}")
    return key.shape[0]


def markov_walk(key: torch.Tensor, *, vocab: int, length: int, seed: int,
                concentration: float) -> torch.Tensor:
    """(rows, 1) int64 row keys in [0, 2^32) -> (rows, length + 1) int64
    token walks over ``vocab`` tokens; ``seed`` picks the transition logits
    (normal draws over ``concentration``)."""
    rows = _check(key, vocab, length, concentration)
    if key.device.type == "cpu":
        build.count_call(markov_walk)
        return markov_walk_ref(key, vocab=vocab, length=length, seed=seed,
                               concentration=concentration)
    walk = torch.empty((rows, length + 1), dtype=torch.int64, device=key.device)
    sms = torch.cuda.get_device_properties(key.device).multi_processor_count
    err = build.load("markov").markov_walk_launch(
        key.data_ptr(), walk.data_ptr(), rows, vocab, length, int(seed) & MASK32,
        inv_concentration(concentration), cluster_size(rows, sms),
        torch.cuda.current_stream(key.device).cuda_stream)
    build.check_launch("markov_walk", err)
    build.count_call(markov_walk, launched=True)
    return walk


def markov_scores(key: torch.Tensor, tok: torch.Tensor, pos: int, *, vocab: int, seed: int,
                  concentration: float) -> torch.Tensor:
    """Test entry of the walk kernel's device function: the (rows, vocab) f32
    scores ``logits + gumbel`` of position ``pos`` from the current tokens
    ``tok`` (rows, 1) int64; CUDA tensors only, not counted."""
    rows = _check(key, vocab, 0, concentration)
    if key.device.type != "cuda":
        raise ValueError(f"markov_scores runs on cuda tensors, got {key.device}")
    if tok.dtype != torch.int64 or tuple(tok.shape) != (rows, 1) or tok.device != key.device \
            or not tok.is_contiguous():
        raise ValueError(f"tok must be contiguous (rows, 1) int64 on {key.device}")
    out = torch.empty((rows, vocab), dtype=torch.float32, device=key.device)
    err = build.load("markov").markov_scores_launch(
        key.data_ptr(), tok.data_ptr(), out.data_ptr(), rows, vocab, pos, int(seed) & MASK32,
        inv_concentration(concentration), torch.cuda.current_stream(key.device).cuda_stream)
    build.check_launch("markov_scores", err)
    return out


markov_walk.launches = 0
markov_walk.calls = 0
