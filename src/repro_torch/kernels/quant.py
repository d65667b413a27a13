"""Wrappers of the quantize-pack (K1) and unpack-dequant-axpy (K2) kernels.

Same signatures and the same ``(rows, cols)`` contract as the JAX package's
``quantize_pack_2d`` and ``unpack_dequant_axpy_2d``: one block per row,
``cols % 128 == 0``.  Each wrapper checks device, dtype, shape and
contiguity, runs the plain version (``kernels/ref.py``) for CPU tensors, and
for CUDA tensors launches the kernel of ``csrc/quant.cu`` on the current
stream or raises; there is no fallback.  Each keeps a plain integer count of
its kernel launches (``launches``), which ``chip_smoke.py`` reads to show the
training path went through the kernels; runs of the plain version do not
count.

Words are ``int32`` tensors holding the uint32 bit patterns of the JAX
package's words (see ``kernels/ref.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    PACKABLE_BITS,
    axpy_weights,
    quantize_pack_2d_ref,
    stream_geometry,
    unpack_dequant_axpy_2d_ref,
)

MAX_COLS = 8192   # K1 stages one row in shared memory: cols*4 B <= 32 KiB


def _check_cols(cols: int, bits: int) -> None:
    if bits not in PACKABLE_BITS:
        raise ValueError(f"packable bits are {PACKABLE_BITS}, got {bits}")
    if cols % 128 or not 0 < cols <= MAX_COLS:
        raise ValueError(f"block_size must be a multiple of 128 in (0, {MAX_COLS}], got {cols}")


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                  device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def quantize_pack_2d(x: torch.Tensor, seed: int, *, bits: int):
    """Fused quantize + bit-pack of a (rows, cols) f32 tensor, one scale per
    row.  Returns (int32 words (rows, cols*bits/32), f32 scale (rows, 1))."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, cols), got shape {tuple(x.shape)}")
    rows, cols = x.shape
    _check_cols(cols, bits)
    _check_tensor("x", x, torch.float32, (rows, cols), x.device)
    if x.device.type == "cpu":
        return quantize_pack_2d_ref(x, seed, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pack_2d runs on cpu or cuda tensors, got {x.device}")
    words = torch.empty((rows, cols * bits // 32), dtype=torch.int32, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    lib = build.load("quant")
    err = lib.quantize_pack_2d_launch(x.data_ptr(), words.data_ptr(), scale.data_ptr(),
                                      rows, cols, bits, int(seed) & 0xFFFFFFFF,
                                      _stream(x.device))
    build.check_launch("quantize_pack_2d", err)
    quantize_pack_2d.launches += 1
    return words, scale


def unpack_dequant_axpy_2d(packed: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor,
                           *, bits: int, weight, acc_weight=1.0,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused unpack + dequantize + accumulate:
    ``acc_weight * acc + weight * dequant(packed)`` over (rows, cols).

    ``weight`` and ``acc_weight`` are host numbers, rounded to f32 as the JAX
    kernel's ``(2,)`` f32 operand rounds them.  ``out`` may be ``acc`` itself
    (in-place update, which the runtime uses for params and replicas)."""
    if packed.dim() != 2:
        raise ValueError(f"packed must be 2-D (rows, words), got {tuple(packed.shape)}")
    rows, w = packed.shape
    if bits not in PACKABLE_BITS:
        raise ValueError(f"packable bits are {PACKABLE_BITS}, got {bits}")
    cols = w * 32 // bits
    _check_cols(cols, bits)
    if w % stream_geometry(bits)[1]:
        raise ValueError(f"word count {w} is not whole {bits}-bit groups")
    dev = packed.device
    _check_tensor("packed", packed, torch.int32, (rows, w), dev)
    _check_tensor("scale", scale, torch.float32, (rows, 1), dev)
    _check_tensor("acc", acc, torch.float32, (rows, cols), dev)
    if out is not None:
        _check_tensor("out", out, torch.float32, (rows, cols), dev)
    if dev.type == "cpu":
        res = unpack_dequant_axpy_2d_ref(packed, scale, acc, bits=bits, weight=weight,
                                         acc_weight=acc_weight)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"unpack_dequant_axpy_2d runs on cpu or cuda tensors, got {dev}")
    if out is None:
        out = torch.empty_like(acc)
    aw, wl = axpy_weights(bits, weight, acc_weight)
    lib = build.load("quant")
    err = lib.unpack_dequant_axpy_2d_launch(packed.data_ptr(), scale.data_ptr(),
                                            acc.data_ptr(), out.data_ptr(), rows, cols,
                                            bits, aw, wl, _stream(dev))
    build.check_launch("unpack_dequant_axpy_2d", err)
    unpack_dequant_axpy_2d.launches += 1
    return out


quantize_pack_2d.launches = 0
unpack_dequant_axpy_2d.launches = 0

KERNEL_WRAPPERS = (quantize_pack_2d, unpack_dequant_axpy_2d)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
