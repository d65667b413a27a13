"""The quantized wire of a gossip step, worked out without the program.

``quant:<bits>`` (block 1024): a stacked leaf ``(n, ..., d)`` is cut along
its last dim into blocks (zero-padded at the end), and each block, one row
of the fold, gets one float32 scale ``max |x|`` and codes in ``[-L, L]``,
``L = 2^(bits-1) - 1``, by stochastic rounding of ``x * L / scale``: the
uniform of element ``e`` is the PCG hash of ``e ^ seed`` (``e`` the flat
index in the fold, mod 2^32), top 24 bits.  Decoded: ``code * (scale *
f32(1/L))``.  Bits 2..7 travel stream-packed in uint32 words (``lcm(bits,
32)`` bits a group), 8 as int8; the block of a packed leaf is rounded up to
whole groups.  The seed of leaf ``li`` at encode counter ``t`` and
algorithm salt ``salt`` is ``(t * 2654435761 mod 2^32) ^ (salt * 97 + li)``.

Frozen copies of the hash, the seed recipe and the stream geometry: the
decoded values and the container bytes are what the comparison reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference.data import MASK32, pcg_hash

ROWS_A_PASS = 1 << 14


def leaf_seed(step: int, salt: int, leaf_index: int) -> int:
    return (((int(step) & MASK32) * 2654435761) & MASK32) ^ ((salt * 97 + leaf_index) & MASK32)


def parse(spec: str) -> dict:
    """``quant:<bits>`` -> its settings."""
    kind, _, arg = spec.partition(":")
    if kind != "quant" or not arg.isdigit():
        raise ValueError(f"the reference knows quant:<bits> wires, got {spec!r}")
    bits = int(arg)
    if not 2 <= bits <= 8:
        raise ValueError(f"quant bits are 2..8, got {bits}")
    return {"bits": bits, "block": 1024, "packed": bits < 8}


def _group(bits: int) -> tuple:
    """(codes, words) of one packed stream group."""
    lcm = math.lcm(bits, 32)
    return lcm // bits, lcm // 32


def block_for(wire: dict, last: int) -> int:
    block = min(wire["block"], max(last, 1))
    if wire["packed"]:
        codes, _ = _group(wire["bits"])
        block = min(wire["block"], -(-block // codes) * codes)
    return block


def container_bytes(wire: dict, shape) -> int:
    """Bytes of the codes and scales that carry a stacked leaf of ``shape``."""
    block = block_for(wire, shape[-1])
    rows = math.prod(shape[:-1]) * -(-shape[-1] // block)
    if wire["packed"]:
        codes, words = _group(wire["bits"])
        per_row = block // codes * words * 4
    else:
        per_row = block
    return rows * (per_row + 4)


def quantize_dequantize(z: torch.Tensor, seed: int, wire: dict, node: int = 0) -> torch.Tensor:
    """What a receiver decodes of the stacked leaf ``z`` (float32): every
    node's rows, or, with ``z`` one node's ``(1, ...)`` slice, node
    ``node``'s, whose fold rows follow the ``node`` nodes before it."""
    bits, last = wire["bits"], z.shape[-1]
    levels = 2 ** (bits - 1) - 1
    inv = float(np.float32(1.0 / levels))
    block = block_for(wire, last)
    pad = (-last) % block
    fold = F.pad(z.to(torch.float32), (0, pad)).reshape(-1, block)
    first = node * fold.shape[0]
    out = torch.empty_like(fold)
    lanes = torch.arange(block, dtype=torch.int64, device=z.device)
    for r0 in range(0, fold.shape[0], ROWS_A_PASS):
        x = fold[r0:r0 + ROWS_A_PASS]
        rows = torch.arange(first + r0, first + r0 + x.shape[0], dtype=torch.int64,
                            device=z.device)
        counter = (rows[:, None] * block + lanes[None, :]) & MASK32
        u = (pcg_hash(counter ^ (seed & MASK32)) >> 8).to(torch.float32) * (1.0 / (1 << 24))
        scale = x.abs().amax(dim=1, keepdim=True)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        v = x * (torch.full_like(safe, levels) / safe)
        low = torch.floor(v)
        code = (low + (u < v - low).to(torch.float32)).clamp(-levels, levels)
        out[r0:r0 + x.shape[0]] = code * (scale * inv)
    return out.reshape(*z.shape[:-1], last + pad)[..., :last]
