"""Plain PyTorch versions of the wire kernels: quantize-pack and
unpack-dequant-axpy, quantize, dequantize and unpack-dequantize, sign-pack
and sign-axpy, sparse select-pack, unpack-scatter and scatter-axpy,
low-rank project and low-rank axpy; of the data layer's Markov walk
(:func:`markov_walk_ref`, the data pipeline's eager walk); and of the optim
layer's AdamW update (:func:`adamw_update_ref`, the optimizer's eager body).

The port's copy of the JAX package's ``kernels/ref.py`` and the helpers of
``kernels/quant.py`` (``stream_geometry``, ``idx_bits_for``,
``sparse_geometry``, ``pcg_hash``, ``uniform_from_hash``), on the same
arithmetic term for term, so the words, indices and values they produce are
bit-equal to the JAX package's for the same seed.  One deliberate exception:
the sign codec's per-row scale is a sum, and the plain version here fixes
the order of that sum (see :func:`sign_scale_2d`) so that it is bit-equal to
the CUDA kernel; it agrees with the JAX package's ``jnp.mean`` to rounding.
The low-rank products are sums too, fixed the same way
(:func:`lowrank_project_2d_ref`, :func:`_factor_matmul`).
The CUDA kernels in ``csrc/*.cu`` are held to these functions on the card;
the CPU tests hold these functions to the JAX package.

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

SPARSE_MODES = ("randk", "topk")

SIGN_SCALE_MODES = ("mean", "l2")

MASK32 = 0xFFFFFFFF

# Rows per pass of the plain versions: bounds their int64 temporaries
# (a pass holds a few (ROW_CHUNK, cols) int64 tensors) at full-width folds.
ROW_CHUNK = 1 << 16


def row_step(x: torch.Tensor) -> int:
    """The rows a plain encoder takes at a time: ``ROW_CHUNK`` (bounds its
    temporaries at full width), or all of them on the meta device, where
    the wire accounting builds containers from shapes alone."""
    return max(x.shape[0], 1) if x.device.type == "meta" else ROW_CHUNK


def stream_geometry(bits: int) -> tuple:
    """(codes per group, words per group) of the v2 stream layout."""
    l = math.lcm(bits, 32)
    return l // bits, l // 32


def idx_bits_for(block: int) -> int:
    """Bits needed to address one element of a ``block``-wide row (>= 1)."""
    return max(1, (block - 1).bit_length())


def sparse_geometry(block: int, p: float) -> tuple:
    """(k, idx_bits, kpad, words) of the fixed-capacity sparse wire format:
    ``k = ceil(p * block)`` values per block, their block-local indices
    stream-packed at ``idx_bits`` bits into ``kpad`` slots (whole stream
    groups, zero tail), which fill ``words`` uint32 words."""
    k = min(block, max(1, math.ceil(p * block)))
    w = idx_bits_for(block)
    cpg, _ = stream_geometry(w)
    kpad = -(-k // cpg) * cpg
    return k, w, kpad, kpad * w // 32


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


def block_counters_2d(rows: int, cols: int, device, row0: int = 0,
                      offset: int = 0) -> torch.Tensor:
    """``offset + (row0 + r) * cols + lane`` mod 2^32 as int64 — the flat
    counter of a row-major (rows, cols) fold, which is what the kernels
    hash.  ``offset`` places the fold inside a larger one: a rank that
    encodes node ``i``'s rows of a stacked leaf passes the element count of
    the rows before them, so its counters are the whole fold's."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    lanes = torch.arange(cols, dtype=torch.int64, device=device)
    return ((int(offset) & MASK32) + r[:, None] * cols + lanes[None, :]) & MASK32


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

def _quantize_rows(x: torch.Tensor, seed: int, *, bits: int, row0: int, offset: int):
    """Scale, normalize, stochastic round one row chunk (``quant.py:146``)."""
    levels = levels_for(bits)
    rows, cols = x.shape
    scale = x.abs().amax(dim=1, keepdim=True)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    # a true f32 division: ``levels / safe`` on a tensor is computed by torch
    # as ``reciprocal(safe) * levels``, which rounds differently
    v = x * (torch.full_like(safe, levels) / safe)
    u = uniform_from_hash(block_counters_2d(rows, cols, x.device, row0, offset), seed)
    floor = torch.floor(v)
    q = floor + (u < (v - floor)).to(torch.float32)
    return q.clamp(-levels, levels).to(torch.int8), scale


def quantize_2d_ref(x: torch.Tensor, seed: int, *, bits: int, offset: int = 0):
    """(rows, cols) f32 -> (int8 codes (rows, cols), f32 scale (rows, 1)); one
    scale per row, counter ``offset + row*cols + lane`` (mod 2^32)."""
    x = x.to(torch.float32)
    step = row_step(x)
    parts = [_quantize_rows(x[r:r + step], seed, bits=bits, row0=r, offset=offset)
             for r in range(0, max(x.shape[0], 1), step)]
    return torch.cat([c for c, _ in parts]), torch.cat([s for _, s in parts])


def quantize_pack_2d_ref(x: torch.Tensor, seed: int, *, bits: int, offset: int = 0):
    """Plain version of kernel K1: quantize, then pack.  Returns (int32 words
    (rows, cols*bits/32), f32 scale (rows, 1)); counters as
    :func:`quantize_2d_ref`."""
    x = x.to(torch.float32)
    words, scales = [], []
    step = row_step(x)
    for r in range(0, max(x.shape[0], 1), step):
        codes, scale = _quantize_rows(x[r:r + step], seed, bits=bits, row0=r,
                                      offset=offset)
        words.append(pack_codes(codes, bits=bits))
        scales.append(scale)
    return torch.cat(words), torch.cat(scales)


def inv_levels(bits: int) -> float:
    """``f32(1/L)``, the constant of the JAX package's dequantize (the CUDA
    kernels take it from the host, never compute it)."""
    return float(np.float32(1.0 / levels_for(bits)))


def dequantize_2d_ref(codes: torch.Tensor, scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Plain version of kernel K4a: ``code * (scale * f32(1/L))`` — the
    reciprocal multiply of the JAX package's dequantize."""
    return codes.to(torch.float32) * (scale.to(torch.float32) * inv_levels(bits))


def unpack_dequant_2d_ref(packed: torch.Tensor, scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Plain version of kernel K4b: :func:`unpack_codes`, then
    :func:`dequantize_2d_ref`, a row chunk at a time."""
    return torch.cat([dequantize_2d_ref(unpack_codes(packed[r:r + ROW_CHUNK], bits=bits),
                                        scale[r:r + ROW_CHUNK], bits=bits)
                      for r in range(0, max(packed.shape[0], 1), ROW_CHUNK)])


def f32_scalar(v) -> float:
    """A host number rounded to f32, as the JAX kernels' f32 scalar operand
    rounds their weights (and the randk rescale ``cols / k``)."""
    return float(np.float32(v))


def axpy_weights(bits: int, weight, acc_weight) -> tuple:
    """The f32 scalars of the fused receive: ``(aw, w*(1/L))`` rounded as the
    JAX kernel rounds them (``quant.py:230-231``: weights ride an f32
    operand, ``w * f32(1/L)`` is one f32 product)."""
    wl = np.float32(weight) * np.float32(1.0 / levels_for(bits))
    return f32_scalar(acc_weight), float(wl)


def unpack_dequant_axpy_2d_ref(packed: torch.Tensor, scale: torch.Tensor,
                               acc: torch.Tensor, *, bits: int, weight,
                               acc_weight=1.0) -> torch.Tensor:
    """Plain version of kernel K2: ``aw*acc + code*(scale*(w*(1/L)))`` with
    the JAX kernel's association (``quant.py:231-236``); every product and
    the sum rounded separately, as the kernel does.  A bfloat16 ``acc`` is
    widened to f32 and the result rounded back (JAX's ``acc.astype(f32)``
    -> kernel -> ``.astype(acc.dtype)``); so for every receive below."""
    aw, wl = axpy_weights(bits, weight, acc_weight)
    out = torch.empty_like(acc, dtype=torch.float32)
    for r in range(0, packed.shape[0], ROW_CHUNK):
        sl = slice(r, r + ROW_CHUNK)
        inv = scale[sl].to(torch.float32) * wl
        code = unpack_codes(packed[sl], bits=bits).to(torch.float32)
        out[sl] = aw * acc[sl].to(torch.float32) + code * inv
    return out.to(acc.dtype)


# ------------------------------------------------------------ sparse codec

def sparse_keys_2d(x: torch.Tensor, seed: int, *, mode: str, row0: int = 0,
                   offset: int = 0) -> torch.Tensor:
    """Selection key of every element of a (rows, cols) fold, int64 in
    [0, 2^32); the canonical order is descending key, ties to the smaller
    index.  ``randk``: ``pcg_hash(counter ^ seed)`` with the fold's counter
    ``offset + (row0 + r) * cols + lane`` mod 2^32 (a bijection, so keys in
    a row are distinct).  ``topk``: ``bits(|x|) + 1``, and 0 for NaN, so NaN ranks
    below every real magnitude and -0.0 ties +0.0 — the order of the JAX
    package's stable ``argsort(-|x|)`` (NaN last, zeros equal).  The
    magnitude is taken on the bits, so no float operation can flush a
    subnormal."""
    if mode not in SPARSE_MODES:
        raise ValueError(f"sparse modes are {SPARSE_MODES}, got {mode!r}")
    rows, cols = x.shape
    if mode == "randk":
        return pcg_hash(block_counters_2d(rows, cols, x.device, row0, offset)
                        ^ (int(seed) & MASK32))
    mag = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    return torch.where(torch.isnan(x), torch.zeros_like(mag), mag + 1)


def sparse_order_2d_ref(x: torch.Tensor, seed: int, *, mode: str,
                        row0: int = 0, offset: int = 0) -> torch.Tensor:
    """Every column index of a (rows, cols) fold in canonical selection
    order (int64): ``key ^ 0xFFFFFFFF`` sorted ascending and stably, as the
    JAX package sorts its randk keys."""
    key = sparse_keys_2d(x, seed, mode=mode, row0=row0, offset=offset)
    return torch.sort(key ^ MASK32, dim=1, stable=True).indices


def sparse_select_2d_ref(x: torch.Tensor, seed: int, *, k: int, mode: str,
                         value_dtype=torch.float32, row0: int = 0, offset: int = 0):
    """Fixed-capacity selection: (values (rows, k) ``value_dtype``, int64
    indices (rows, k)) in canonical order.  ``randk`` rescales kept values by
    the f32 constant ``cols / k`` (inclusion probability k/cols)."""
    cols = x.shape[1]
    x = x.to(torch.float32)
    sel = sparse_order_2d_ref(x, seed, mode=mode, row0=row0, offset=offset)[:, :k]
    vals = torch.gather(x, 1, sel)
    if mode == "randk":
        vals = vals * f32_scalar(cols / k)
    return vals.to(value_dtype), sel


def sparse_pack_idx(indices: torch.Tensor, *, block: int, kpad: int) -> torch.Tensor:
    """(..., k) block-local indices -> (..., words) int32 packed stream: zero
    tail up to ``kpad``, then :func:`pack_uint` at ``idx_bits_for(block)``."""
    pad = kpad - indices.shape[-1]
    if pad:
        indices = torch.nn.functional.pad(indices, (0, pad))
    return pack_uint(indices, bits=idx_bits_for(block))


def sparse_unpack_idx(packed: torch.Tensor, *, block: int, k: int) -> torch.Tensor:
    """Inverse of :func:`sparse_pack_idx`: (..., words) -> (..., k) int64."""
    return unpack_uint(packed, bits=idx_bits_for(block))[..., :k]


def sparse_select_pack_2d_ref(x: torch.Tensor, seed: int, *, p: float, mode: str,
                              value_dtype=torch.float32, offset: int = 0):
    """Plain version of kernel K6: select, gather, pack the index stream.
    Returns (values (rows, k) ``value_dtype``, int32 words (rows, words));
    ``offset`` moves the random-k counters as in :func:`block_counters_2d`."""
    rows, cols = x.shape
    k, _, kpad, _ = sparse_geometry(cols, p)
    vals, words = [], []
    step = row_step(x)
    for r in range(0, max(rows, 1), step):
        v, sel = sparse_select_2d_ref(x[r:r + step], seed, k=k, mode=mode,
                                      value_dtype=value_dtype, row0=r, offset=offset)
        vals.append(v)
        words.append(sparse_pack_idx(sel, block=cols, kpad=kpad))
    return torch.cat(vals), torch.cat(words)


def sparse_scatter_2d_ref(values: torch.Tensor, indices: torch.Tensor, *,
                          cols: int) -> torch.Tensor:
    """(rows, k) values at duplicate-free indices -> dense (rows, cols) f32.
    Added into zeros, as the JAX package's one-hot sum adds them."""
    dense = torch.zeros((values.shape[0], cols), dtype=torch.float32, device=values.device)
    return dense.scatter_add_(1, indices, values.to(torch.float32))


def sparse_unpack_scatter_2d_ref(values: torch.Tensor, packed: torch.Tensor, *,
                                 cols: int) -> torch.Tensor:
    """Plain version of kernel K6b: unpack the indices, add the values into
    zeros (so a kept -0.0 decodes to +0.0, as in the JAX kernel)."""
    k = values.shape[-1]
    return sparse_scatter_2d_ref(values, sparse_unpack_idx(packed, block=cols, k=k),
                                 cols=cols)


def sparse_scatter_axpy_2d_ref(values: torch.Tensor, packed: torch.Tensor,
                               acc: torch.Tensor, *, weight, acc_weight=1.0) -> torch.Tensor:
    """Plain version of kernel K6c: ``aw*acc + (hit ? w*value : +0.0)`` per
    lane, with ``aw`` and ``w`` rounded to f32 as the JAX kernel's operand
    rounds them.  Equal to the JAX oracle ``aw*acc + w*scatter(values)`` up
    to the sign of a zero."""
    aw, w = f32_scalar(acc_weight), f32_scalar(weight)
    rows, cols = acc.shape
    k = values.shape[-1]
    out = torch.empty_like(acc, dtype=torch.float32)
    for r in range(0, rows, ROW_CHUNK):
        sl = slice(r, r + ROW_CHUNK)
        idx = sparse_unpack_idx(packed[sl], block=cols, k=k)
        dense = torch.zeros_like(out[sl]).scatter_(1, idx, values[sl].to(torch.float32))
        hit = torch.zeros(dense.shape, dtype=torch.bool, device=dense.device).scatter_(
            1, idx, True)
        out[sl] = aw * acc[sl].to(torch.float32) + torch.where(
            hit, w * dense, torch.zeros((), dtype=torch.float32, device=dense.device))
    return out.to(acc.dtype)


# -------------------------------------------------------------- sign codec

def sign_scale_2d(x: torch.Tensor, *, scale_mode: str) -> torch.Tensor:
    """Per-row scale of the 1-bit codec, (rows, 1) f32: ``mean`` = mean|x|,
    ``l2`` = sqrt(mean x^2).  The sum runs in one fixed order, the CUDA
    kernel's: with ``G = cols/32``, partial ``g`` adds its 32 elements
    ``{j*G + g}`` in ``j`` order, then a halving tree over the partials
    (zero-padded to a power of two) adds ``s[t] += s[t + h]``.  Then a true
    division by ``cols`` and, for ``l2``, a correctly rounded square root.
    The JAX package's ``jnp.mean`` sums in another order, so the two agree
    to rounding, not to the bit."""
    if scale_mode not in SIGN_SCALE_MODES:
        raise ValueError(f"sign scale modes are {SIGN_SCALE_MODES}, got {scale_mode!r}")
    rows, cols = x.shape
    g = cols // 32
    x = x.to(torch.float32)
    a = (x.abs() if scale_mode == "mean" else x * x).reshape(rows, 32, g)
    s = a[:, 0]
    for j in range(1, 32):
        s = s + a[:, j]
    width = 1 << (g - 1).bit_length()
    if width > g:
        s = torch.nn.functional.pad(s, (0, width - g))
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    mean = s / torch.full_like(s, float(cols))
    return mean if scale_mode == "mean" else torch.sqrt(mean)


def sign_pack_2d_ref(x: torch.Tensor, *, scale_mode: str = "mean"):
    """Plain version of kernel K5a: one sign bit per element (``x >= 0``, so
    -0.0 codes +1 and NaN codes 0) packed 32 to a word through the width-1
    stream (bit ``j`` of word ``g`` is element ``j*G + g``), and the per-row
    scale of :func:`sign_scale_2d`.  Returns (int32 words (rows, cols/32),
    f32 scale (rows, 1))."""
    x = x.to(torch.float32)
    words, scales = [], []
    step = row_step(x)
    for r in range(0, max(x.shape[0], 1), step):
        xc = x[r:r + step]
        words.append(pack_uint((xc >= 0.0).to(torch.int64), bits=1))
        scales.append(sign_scale_2d(xc, scale_mode=scale_mode))
    return torch.cat(words), torch.cat(scales)


def unpack_sign_2d_ref(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`sign_pack_2d_ref`: ``(2u - 1) * scale``."""
    u = unpack_uint(packed, bits=1).to(torch.float32)
    return (u * 2.0 - 1.0) * scale.to(torch.float32)


def unpack_sign_axpy_2d_ref(packed: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor,
                            *, weight, acc_weight=1.0) -> torch.Tensor:
    """Plain version of kernel K5b: ``aw*acc + (2u - 1)*(scale*w)``.  The
    sign factor is exactly +-1, so this equals the JAX oracle's
    ``aw*acc + w*((2u - 1)*scale)`` bit for bit."""
    aw, w = f32_scalar(acc_weight), f32_scalar(weight)
    out = torch.empty_like(acc, dtype=torch.float32)
    for r in range(0, packed.shape[0], ROW_CHUNK):
        sl = slice(r, r + ROW_CHUNK)
        sgn = unpack_uint(packed[sl], bits=1).to(torch.float32) * 2.0 - 1.0
        out[sl] = aw * acc[sl].to(torch.float32) + sgn * (scale[sl].to(torch.float32) * w)
    return out.to(acc.dtype)


# ----------------------------------------------------------- low-rank codec

LOWRANK_LANES = 32      # the partial sums of a K7a row: one per warp lane


def lowrank_orthonormalize_ref(p: torch.Tensor, *, eps: float = 1e-8) -> torch.Tensor:
    """Batched modified Gram-Schmidt over the trailing ``(m, r)`` factor
    (JAX ``kernels/ref.py:321``): the columns in order, each minus its
    projections on the earlier ones, divided by ``max(norm, eps)`` (a true
    tensor / tensor division).  The sums are torch's, so this agrees with the
    JAX package to rounding."""
    p = p.to(torch.float32)
    cols = []
    for j in range(p.shape[-1]):
        v = p[..., j]
        for q in cols:
            v = v - torch.sum(q * v, dim=-1, keepdim=True) * q
        norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        cols.append(v / torch.maximum(norm, torch.full_like(norm, eps)))
    return torch.stack(cols, dim=-1)


def _factor_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b^T`` over the shared last (rank) dim, ``(..., m, r) x (..., n, r)
    -> (..., m, n)`` f32, in kernel K7b's fixed order: ``a[:, 0]*b[:, 0]``,
    then ``+ a[:, k]*b[:, k]`` for ``k = 1..r-1``, every product and sum
    rounded separately (JAX ``kernels/ref.py:343`` leaves the order to
    XLA's dot)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    out = a[..., :, 0:1] * b[..., None, :, 0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., None, :, k]
    return out


def _project_slab(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(rows, n) x (n, r) -> (rows, r) in :func:`lowrank_project_2d_ref`'s order."""
    n, r = v.shape
    pad = (-n) % LOWRANK_LANES
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    groups = (n + pad) // LOWRANK_LANES
    mr = m.reshape(m.shape[0], groups, LOWRANK_LANES)              # (rows, K, 32)
    vr = v.reshape(groups, LOWRANK_LANES, r)                       # (K, 32, r)
    s = torch.zeros((m.shape[0], LOWRANK_LANES, r), dtype=torch.float32, device=m.device)
    for k in range(groups):
        s = s + mr[:, k, :, None] * vr[None, k]
    h = LOWRANK_LANES // 2
    while h:
        s = s[:, :h] + s[:, h:]
        h //= 2
    return s[:, 0]


def lowrank_project_2d_ref(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K7a: ``P = M @ V``, ``(..., rows, n) x (..., n,
    r) -> (..., rows, r)`` f32, leading dims broadcast and run one slab at a
    time.  The sum over ``n`` runs in the CUDA kernel's fixed order: ``n`` is
    zero-padded to whole groups of 32; lane ``l`` adds the products
    ``m[j]*v[j, c]`` of ``j = 32k + l`` for ``k = 0, 1, ...`` in order onto
    +0.0; then a halving tree over the 32 lane sums adds ``s[l] += s[l + h]``
    for ``h = 16, 8, 4, 2, 1``.  Every product and sum is rounded
    separately.  (A zero-padded product adds +0.0 to a sum that started at
    +0.0, which changes nothing.)"""
    m, v = m.to(torch.float32), v.to(torch.float32)
    lead = torch.broadcast_shapes(m.shape[:-2], v.shape[:-2])
    rows, r = m.shape[-2], v.shape[-1]
    mb = m.expand(*lead, *m.shape[-2:]).reshape(-1, *m.shape[-2:])
    vb = v.expand(*lead, *v.shape[-2:]).reshape(-1, *v.shape[-2:])
    out = torch.empty((mb.shape[0], rows, r), dtype=torch.float32, device=m.device)
    for b in range(mb.shape[0]):
        out[b] = _project_slab(mb[b], vb[b])
    return out.reshape(*lead, rows, r)


def lowrank_axpy_2d_ref(p: torch.Tensor, v: torch.Tensor, acc: torch.Tensor, *,
                        weight, acc_weight=1.0) -> torch.Tensor:
    """Plain version of kernel K7b: ``aw*acc + w*(P @ V^T)`` over ``(...,
    rows, n)``, the product in :func:`_factor_matmul`'s order and ``aw``,
    ``w`` rounded to f32 as the JAX kernel's operand rounds them.  Leading
    dims run one slice at a time (bounds the temporaries at full width)."""
    aw, w = f32_scalar(acc_weight), f32_scalar(weight)
    dtype, acc = acc.dtype, acc.to(torch.float32)
    if acc.dim() == 2:
        return (aw * acc + w * _factor_matmul(p, v)).to(dtype)
    lead = acc.shape[:-2]
    p = p.expand(*lead, *p.shape[-2:]).reshape(-1, *p.shape[-2:])
    v = v.expand(*lead, *v.shape[-2:]).reshape(-1, *v.shape[-2:])
    accf = acc.reshape(-1, *acc.shape[-2:])
    out = torch.empty_like(accf)
    for b in range(accf.shape[0]):
        out[b] = aw * accf[b] + w * _factor_matmul(p[b], v[b])
    return out.reshape(acc.shape).to(dtype)


# ---------------------------------------------------- the data's Markov walk

MARKOV_SALT = 7919          # the transition logits' hash stream: seed + MARKOV_SALT


def mix_hash(h, x):
    """Fold one more counter into a hash (int64 tensors or ints, in [0, 2^32))."""
    return pcg_hash((pcg_hash(h) ^ x) & MASK32)


def uniform_open(h: torch.Tensor) -> torch.Tensor:
    """f32 uniform in (0, 1] from a 32-bit hash (the top 2^-24 of hashes
    round to 1.0)."""
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def normal_from_hash(h: torch.Tensor) -> torch.Tensor:
    """Standard normal from a 32-bit hash (Box-Muller on two uniforms)."""
    u1 = uniform_open(h)
    u2 = uniform_open(pcg_hash(h ^ 0x9E3779B9))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def markov_logits_ref(tok: torch.Tensor, cand: torch.Tensor, *, seed: int,
                      concentration: float) -> torch.Tensor:
    """(R, 1) current tokens x (V,) candidates -> (R, V) normal transition
    logits over ``concentration``."""
    h = mix_hash(mix_hash(torch.full_like(tok, (seed + MARKOV_SALT) & MASK32), tok), cand)
    return normal_from_hash(h) / concentration


def markov_gumbel_ref(key: torch.Tensor, pos: int, cand: torch.Tensor) -> torch.Tensor:
    """(R, 1) row keys x (V,) candidates -> (R, V) Gumbel noise at ``pos``."""
    return -torch.log(-torch.log(uniform_open(mix_hash(mix_hash(key, pos), cand))))


def markov_walk_ref(key: torch.Tensor, *, vocab: int, length: int, seed: int,
                    concentration: float) -> torch.Tensor:
    """Plain version of the walk kernel (``csrc/markov.cu``): (R, 1) int64
    row keys -> (R, length + 1) int64 token walks.  The first token is the
    key's hash mod ``vocab``; each next one ``argmax(logits + gumbel)`` over
    every candidate, eagerly, a few elementwise passes over (R, vocab) a
    position."""
    cand = torch.arange(vocab, dtype=torch.int64, device=key.device)
    tok = pcg_hash(key) % vocab
    seq = [tok]
    for pos in range(length):
        gumbel = markov_gumbel_ref(key, pos, cand)
        logits = markov_logits_ref(tok, cand, seed=seed, concentration=concentration)
        tok = torch.argmax(logits + gumbel, dim=-1, keepdim=True)
        seq.append(tok)
    return torch.cat(seq, dim=1)


# ------------------------------------------------------- the AdamW update

def adamw_bias_corrections(b1: float, b2: float, t: int) -> tuple:
    """``(1 - b1**t, 1 - b2**t)`` in float32, as ``b1 ** t.astype(f32)`` in
    JAX (Python floats holding float32 values)."""
    return (float(np.float32(1) - np.float32(b1) ** np.float32(t)),
            float(np.float32(1) - np.float32(b2) ** np.float32(t)))


def adamw_update_ref(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, p: torch.Tensor, *,
                     b1: float, b2: float, eps: float, weight_decay: float, lr: float,
                     t: int) -> torch.Tensor:
    """Plain version of the AdamW kernel (``csrc/adamw.cu``): the moments
    ``m`` and ``v`` updated in place, the update ``-lr * (m_hat / (sqrt(v_hat)
    + eps) + wd * p)`` returned in a new float32 tensor; eagerly, each
    operation rounded as in JAX (a product with a bf16 ``g`` or ``p`` rounds
    to bf16 before it meets the float32 moments)."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    bc1, bc2 = adamw_bias_corrections(b1, b2, t)
    # -lr * ((m/bc1) / (sqrt(v/bc2) + eps) + wd*p), each op rounded as in
    # JAX; in place on two temporaries, which matters at full width
    upd = m / bc1
    upd.div_(torch.sqrt(v / bc2).add_(eps))
    upd.add_(weight_decay * p)
    return upd.mul_(-lr)


# ------------------------------------------------------------- comparison

def sparse_selection_edge_rows(x, first: int):
    """Rows ``first`` to ``first + 4`` of a (rows, cols) fold (a tensor or a
    numpy array) set in place to K6's selection edges: all NaN; NaNs at every
    third column, more than k; +inf, -inf and a NaN; the k-th and (k+1)-th
    keys of p 0.05 tied across the boundary of two lane spans (cols/16
    columns at 128, else cols/32) and of two 8-column groups; ties longer
    than one span.  Returns x."""
    cols = x.shape[1]
    span = cols // 16 if cols == 128 else cols // 32
    x[first] = float("nan")
    x[first + 1, ::3] = float("nan")
    x[first + 2, 0], x[first + 2, 7], x[first + 2, 9] = float("inf"), float("-inf"), float("nan")
    x[first + 3] = 1e-3
    x[first + 3, span - 7:span + 5] = 0.5     # at 128, k 7: entry 7 ends lane 0, 8 starts lane 1
    x[first + 4, :3 * span + 2] = 0.25
    return x


def offset_views(t: torch.Tensor) -> dict:
    """``t``'s values three ways, each in a buffer of its own, for the
    receive kernels' paths: ``own``, a contiguous copy; ``row1``, a view one
    row (of the last dim) into a larger buffer, 16-byte aligned when a row
    is; ``off1``, a view one element into a larger buffer, off 16-byte
    alignment for a 2- or 4-byte type."""
    row, numel = t.shape[-1], t.numel()
    views = {"own": t.clone()}
    for name, start in (("row1", row), ("off1", 1)):
        flat = torch.zeros(numel + 2 * row, dtype=t.dtype, device=t.device)
        views[name] = flat[start:start + numel].view(t.shape)
        views[name].copy_(t)
    return views


def sparse_payload_past_cols(value_dtype, device, cols: int = 384):
    """A K6c payload of 5 rows at ``cols`` (9-bit indices at 384, which can
    name a column past the row; 7 bits at 128 cannot) whose last row holds
    the indices 450 and 511 >= cols, and the payload the kernel must act as:
    those entries pointed at columns no entry hits, with the value +0.0.
    For a weight > 0 their addend ``w*(+0.0)`` is a miss's +0.0, so the
    plain version (which cannot take an index past the row) gives the
    kernel's result.  Returns ((values, words), (kept values, kept words))."""
    idx = torch.tensor([[3, 200, 383], [0, 1, 2], [383, 382, 381], [10, 20, 30],
                        [5, 450, 511]])
    gen = torch.Generator()
    gen.manual_seed(cols)
    vals = torch.randn((idx.shape[0], idx.shape[1]), generator=gen).to(value_dtype)
    cpg, _ = stream_geometry(idx_bits_for(cols))
    kpad = -(-idx.shape[1] // cpg) * cpg
    kept_idx, kept_vals = idx.clone(), vals.clone()
    kept_idx[4, 1:] = torch.tensor([100, 101])
    kept_vals[4, 1:] = 0.0
    return tuple((v.to(device), sparse_pack_idx(i, block=cols, kpad=kpad).to(device))
                 for v, i in ((vals, idx), (kept_vals, kept_idx)))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The kernels' equality contract with their plain versions: same shape,
    dtype and bits, any NaN matching any NaN (a NaN's payload bits are not
    part of the contract; the CPU and the card make different ones)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return bool(((a.view(view) == b.view(view)) | (torch.isnan(a) & torch.isnan(b))).all())
