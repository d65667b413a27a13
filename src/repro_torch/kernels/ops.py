"""Whole-tensor wrappers of the quant and sparse kernels (the port of the
JAX package's ``kernels/ops.py``).

Any-shaped input is flattened, zero-padded and folded to the 2-D blocked
view (:func:`_to_blocks`), as the JAX package does; payloads are the same
containers as :class:`~repro_torch.core.compression.RandomQuantizer` and the
sparsifiers ship:

* ``bits=8``: ``codes`` int8 ``(n_blocks, block_size)`` + ``scale`` f32
  ``(n_blocks, 1)``.
* ``bits in 2..7``: ``codes`` int32 words holding the uint32 stream
  ``(n_blocks, block_size*bits/32)`` + ``scale``.  The codes' dtype says
  which: int32 means packed.
* sparse: ``{values: (n_blocks, k) f32 | f16, idx: (n_blocks, words) int32}``.

Where the JAX package draws a seed from a PRNG key
(``jax.random.bits(key)``), these functions take that seed as an integer.
Every function routes through the kernel wrappers of ``kernels/quant.py``:
the CUDA kernels on CUDA tensors, their plain versions on CPU tensors.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.quant import (
    dequantize_2d,
    quantize_2d,
    quantize_pack_2d,
    sparse_scatter_axpy_2d,
    sparse_select_pack_2d,
    sparse_unpack_scatter_2d,
    unpack_dequant_2d,
    unpack_dequant_axpy_2d,
)
from repro_torch.kernels.ref import PACKABLE_BITS, f32_scalar


def _to_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flatten, zero-pad to whole blocks, fold to (n_blocks, block_size) f32."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block_size).contiguous()


def _from_blocks(out: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    n = math.prod(shape) if shape else 1
    return out.reshape(-1)[:n].reshape(shape).to(dtype)


def payload_nbytes(payload: Any) -> int:
    """Total wire bytes of a payload: a tensor (real or ``meta``) or a dict,
    list or tuple of them, nested."""
    if isinstance(payload, dict):
        payload = list(payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_nbytes(p) for p in payload)
    return payload.numel() * payload.element_size()


def _packed(payload: dict) -> bool:
    return payload["codes"].dtype == torch.int32


def quantize(seed: int, x: torch.Tensor, *, bits: int = 8, block_size: int = 1024,
             pack: Optional[bool] = None) -> dict:
    """Stochastic-quantize any-shaped ``x`` into a {codes, scale} payload:
    K1 (packed words, ``bits in 2..7`` unless ``pack`` is False) or K3 (int8);
    ``block_size % 128 == 0``, the kernels' lane contract."""
    packed = bits in PACKABLE_BITS if pack is None else pack
    if packed and bits not in PACKABLE_BITS:
        raise ValueError(f"packable bits are {PACKABLE_BITS}, got {bits}")
    blocks = _to_blocks(x, block_size)
    quant = quantize_pack_2d if packed else quantize_2d
    codes, scale = quant(blocks, seed, bits=bits)
    return {"codes": codes, "scale": scale}


def dequantize(payload: dict, *, bits: int = 8, shape: tuple = (),
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize` to ``shape``: K4b (packed) or K4a (int8)."""
    decode = unpack_dequant_2d if _packed(payload) else dequantize_2d
    return _from_blocks(decode(payload["codes"], payload["scale"], bits=bits), shape, dtype)


def sparse_compress(seed: int, x: torch.Tensor, *, p: float = 0.25, block_size: int = 128,
                    mode: str = "randk", value_dtype=torch.float32) -> dict:
    """Fixed-capacity sparsification of any-shaped ``x`` into {values, idx}
    (K6): ``k = ceil(p * block_size)`` values a block (``randk``: a seeded
    uniform k-subset rescaled by ``block/k``; ``topk``: the k largest
    magnitudes); ``block_size % 128 == 0``."""
    vals, idx = sparse_select_pack_2d(_to_blocks(x, block_size), seed, p=p, mode=mode,
                                      value_dtype=value_dtype)
    return {"values": vals, "idx": idx}


def sparse_decompress(payload: dict, *, block_size: int = 128, shape: tuple = (),
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`sparse_compress` to ``shape`` (K6b)."""
    out = sparse_unpack_scatter_2d(payload["values"], payload["idx"], cols=block_size)
    return _from_blocks(out, shape, dtype)


def sparse_axpy(payload: dict, acc: torch.Tensor, *, block_size: int,
                weight: float) -> torch.Tensor:
    """``acc + weight * sparse_decompress(payload)``, acc-shaped, in one K6c
    pass (``acc`` itself is left as it is)."""
    out = sparse_scatter_axpy_2d(payload["values"], payload["idx"],
                                 _to_blocks(acc, block_size), weight=weight)
    return _from_blocks(out, tuple(acc.shape), acc.dtype)


def dequant_axpy(payload: dict, acc: torch.Tensor, *, bits: int, weight: float) -> torch.Tensor:
    """``acc + weight * dequantize(payload)``, acc-shaped (``acc`` itself is
    left as it is): one K2 pass for packed payloads; K4a, then the axpy in
    torch, for int8 ones (the JAX package's association)."""
    codes = payload["codes"]
    packed = _packed(payload)
    block_size = codes.shape[-1] * 32 // bits if packed else codes.shape[-1]
    blocks = _to_blocks(acc, block_size)
    if packed:
        out = unpack_dequant_axpy_2d(codes, payload["scale"], blocks, bits=bits, weight=weight)
    else:
        out = blocks + f32_scalar(weight) * dequantize_2d(codes, payload["scale"], bits=bits)
    return _from_blocks(out, tuple(acc.shape), acc.dtype)
