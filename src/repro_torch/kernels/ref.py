"""Plain PyTorch versions of the quantize-pack and unpack-dequant-axpy kernels.

The port's copy of the JAX package's ``kernels/ref.py`` and the helpers of
``kernels/quant.py`` (``stream_geometry``, ``pcg_hash``,
``uniform_from_hash``), on the same arithmetic term for term, so the words
and scales they produce are bit-equal to the JAX package's for the same
seed.  The CUDA kernels in ``csrc/quant.cu`` are held to these functions on
the card; the CPU tests hold these functions to the JAX package.

Integer conventions.  torch has no usable ``uint32`` arithmetic on the CPU
(``add``/``>>``/``<<``/``max`` raise for ``UInt32``), so the 32-bit hash and
the packing run in ``int64`` masked with ``0xFFFFFFFF``.  Packed words leave
these functions as ``int32`` tensors holding the uint32 bit patterns
(``words.numpy().view(np.uint32)`` gives the JAX package's words); the CUDA
kernels write the same bits into the same ``int32`` containers.

Packed wire format v2 (the stream layout of the JAX package): with
``cpg, wpg = stream_geometry(bits)`` and ``G = cols // cpg``, group ``g``
packs the biased codes ``{u[j*G + g] : j}`` as one little-endian
``cpg*bits``-bit stream over its ``wpg`` words; word ``w`` of group ``g``
sits at column ``w*G + g`` (word-plane-major).
"""
from __future__ import annotations

import math

import numpy as np
import torch

PACKABLE_BITS = (2, 3, 4, 5, 6, 7)

MASK32 = 0xFFFFFFFF

# Rows per pass of the plain versions: bounds their int64 temporaries
# (a pass holds a few (ROW_CHUNK, cols) int64 tensors) at full-width folds.
ROW_CHUNK = 1 << 16


def stream_geometry(bits: int) -> tuple:
    """(codes per group, words per group) of the v2 stream layout."""
    l = math.lcm(bits, 32)
    return l // bits, l // 32


def levels_for(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def packed_auto(bits: int, block: int) -> bool:
    """Auto-pack policy: pack whenever the width is packable and the block is
    a whole number of stream groups; otherwise the int8 container."""
    if bits not in PACKABLE_BITS:
        return False
    cpg, _ = stream_geometry(bits)
    return block % cpg == 0


def assert_packable(bits: int, block: int) -> None:
    """Validate an explicit ``pack=True`` request against the geometry."""
    if bits not in PACKABLE_BITS:
        raise ValueError(f"packable bits are {PACKABLE_BITS}, got {bits}")
    cpg, _ = stream_geometry(bits)
    if block % cpg:
        raise ValueError(f"packed {bits}-bit needs block % {cpg} == 0")


def aligned_block(limit: int, n: int, *, bits: int) -> int:
    """Block size for an ``n``-element last dim: shrink toward ``n`` to limit
    padding, rounded up to whole packed groups."""
    cpg, _ = stream_geometry(bits)
    block = min(limit, max(n, 1))
    return min(limit, -(-block // cpg) * cpg)


# ------------------------------------------------------------------ hashing

def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-XSH-RR-style 32-bit mix of int64 values in [0, 2^32) (uint32
    wraparound emulated by masking); returns int64 in [0, 2^32)."""
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def uniform_from_hash(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic f32 U[0,1) from a per-element counter and a uint32 seed."""
    bits = pcg_hash(idx ^ (int(seed) & MASK32))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def block_counters_2d(rows: int, cols: int, device, row0: int = 0) -> torch.Tensor:
    """``(row0 + r) * cols + lane`` mod 2^32 as int64 — the flat counter of a
    row-major (rows, cols) fold, which is what the kernels hash."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    lanes = torch.arange(cols, dtype=torch.int64, device=device)
    return (r[:, None] * cols + lanes[None, :]) & MASK32


# ------------------------------------------------------------------ packing

def _as_words(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 container of the same bits."""
    return t.to(torch.int32)


def _from_words(words: torch.Tensor) -> torch.Tensor:
    """int32 container -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & MASK32


def pack_uint(u: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Bit-pack unsigned ``bits``-wide fields along the last dim:
    (..., cols) integers < 2^bits -> (..., cols*bits/32) int32 words."""
    assert 1 <= bits <= 16, f"uint stream widths are 1..16, got {bits}"
    cpg, wpg = stream_geometry(bits)
    cols = u.shape[-1]
    assert cols % cpg == 0, f"last dim {cols} not a multiple of {cpg}"
    g = cols // cpg
    u = u.to(torch.int64)
    words = [torch.zeros(u.shape[:-1] + (g,), dtype=torch.int64, device=u.device)
             for _ in range(wpg)]
    for j in range(cpg):
        w, off = divmod(j * bits, 32)
        uj = u[..., j * g:(j + 1) * g]
        words[w] |= (uj << off) & MASK32          # high bits drop, as in uint32
        if off + bits > 32:                       # straddles into word w+1
            words[w + 1] |= uj >> (32 - off)
    return _as_words(torch.cat(words, dim=-1))


def unpack_uint(packed: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_uint`: (..., W) int32 words -> (..., W*32/bits)
    int64 fields."""
    assert 1 <= bits <= 16, f"uint stream widths are 1..16, got {bits}"
    cpg, wpg = stream_geometry(bits)
    W = packed.shape[-1]
    assert W % wpg == 0, f"word count {W} not a multiple of {wpg}"
    g = W // wpg
    words = _from_words(packed)
    planes = [words[..., w * g:(w + 1) * g] for w in range(wpg)]
    mask = (1 << bits) - 1
    parts = []
    for j in range(cpg):
        w, off = divmod(j * bits, 32)
        v = planes[w] >> off
        if off + bits > 32:
            v = v | ((planes[w + 1] << (32 - off)) & MASK32)
        parts.append(v & mask)
    return torch.cat(parts, dim=-1)


def pack_codes(codes: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Bias codes in [-L, L] to [1, 2^bits - 1] and stream-pack them."""
    assert bits in PACKABLE_BITS, f"packable bits are {PACKABLE_BITS}, got {bits}"
    return pack_uint(codes.to(torch.int64) + (levels_for(bits) + 1), bits=bits)


def unpack_codes(packed: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: words -> int8 codes in [-L, L]."""
    assert bits in PACKABLE_BITS, f"packable bits are {PACKABLE_BITS}, got {bits}"
    return (unpack_uint(packed, bits=bits) - (levels_for(bits) + 1)).to(torch.int8)


# ------------------------------------------------------------ quantization

def _quantize_rows(x: torch.Tensor, seed: int, *, bits: int, row0: int):
    """Scale, normalize, stochastic round one row chunk (``quant.py:146``)."""
    levels = levels_for(bits)
    rows, cols = x.shape
    scale = x.abs().amax(dim=1, keepdim=True)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    # a true f32 division: ``levels / safe`` on a tensor is computed by torch
    # as ``reciprocal(safe) * levels``, which rounds differently
    v = x * (torch.full_like(safe, levels) / safe)
    u = uniform_from_hash(block_counters_2d(rows, cols, x.device, row0), seed)
    floor = torch.floor(v)
    q = floor + (u < (v - floor)).to(torch.float32)
    return q.clamp(-levels, levels).to(torch.int8), scale


def quantize_2d_ref(x: torch.Tensor, seed: int, *, bits: int):
    """(rows, cols) f32 -> (int8 codes (rows, cols), f32 scale (rows, 1)); one
    scale per row, counter ``row*cols + lane``."""
    x = x.to(torch.float32)
    parts = [_quantize_rows(x[r:r + ROW_CHUNK], seed, bits=bits, row0=r)
             for r in range(0, max(x.shape[0], 1), ROW_CHUNK)]
    return torch.cat([c for c, _ in parts]), torch.cat([s for _, s in parts])


def quantize_pack_2d_ref(x: torch.Tensor, seed: int, *, bits: int):
    """Plain version of kernel K1: quantize, then pack.  Returns (int32 words
    (rows, cols*bits/32), f32 scale (rows, 1))."""
    x = x.to(torch.float32)
    words, scales = [], []
    for r in range(0, max(x.shape[0], 1), ROW_CHUNK):
        codes, scale = _quantize_rows(x[r:r + ROW_CHUNK], seed, bits=bits, row0=r)
        words.append(pack_codes(codes, bits=bits))
        scales.append(scale)
    return torch.cat(words), torch.cat(scales)


def dequantize_2d_ref(codes: torch.Tensor, scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """``code * (scale * f32(1/L))`` — the reciprocal multiply of the JAX
    package's dequantize."""
    inv_l = float(np.float32(1.0 / levels_for(bits)))
    return codes.to(torch.float32) * (scale.to(torch.float32) * inv_l)


def axpy_weights(bits: int, weight, acc_weight) -> tuple:
    """The f32 scalars of the fused receive: ``(aw, w*(1/L))`` rounded as the
    JAX kernel rounds them (``quant.py:230-231``: weights ride an f32
    operand, ``w * f32(1/L)`` is one f32 product)."""
    aw = np.float32(acc_weight)
    wl = np.float32(weight) * np.float32(1.0 / levels_for(bits))
    return float(aw), float(wl)


def unpack_dequant_axpy_2d_ref(packed: torch.Tensor, scale: torch.Tensor,
                               acc: torch.Tensor, *, bits: int, weight,
                               acc_weight=1.0) -> torch.Tensor:
    """Plain version of kernel K2: ``aw*acc + code*(scale*(w*(1/L)))`` with
    the JAX kernel's association (``quant.py:231-236``); every product and
    the sum rounded separately, as the kernel does."""
    aw, wl = axpy_weights(bits, weight, acc_weight)
    out = torch.empty_like(acc, dtype=torch.float32)
    for r in range(0, packed.shape[0], ROW_CHUNK):
        sl = slice(r, r + ROW_CHUNK)
        inv = scale[sl].to(torch.float32) * wl
        code = unpack_codes(packed[sl], bits=bits).to(torch.float32)
        out[sl] = aw * acc[sl].to(torch.float32) + code * inv
    return out
