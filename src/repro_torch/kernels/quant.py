"""Wrappers of the wire kernels: quantize-pack (K1), unpack-dequant-axpy
(K2), quantize (K3), dequantize (K4a) and unpack-dequantize (K4b) in
``csrc/quant.cu``, sign-pack (K5a) and unpack-sign-axpy (K5b) in
``csrc/sign.cu``, sparse select-pack (K6), unpack-scatter (K6b) and
scatter-axpy (K6c) in ``csrc/sparse.cu``; the launch counters of these, of
the low-rank kernels (K7a, K7b, ``kernels/lowrank.py``) and of the data
layer's Markov walk (``kernels/markov.py``) and of the optim layer's AdamW
update (``kernels/adamw.py``) in :data:`KERNEL_WRAPPERS`.

Same signatures and the same ``(rows, cols)`` contract as the JAX package's
functions of the same names: one block per row, ``cols % 128 == 0`` — but
for the two dense decodes, which the JAX package does not gate either: K4a
takes any ``cols >= 1``, K4b any whole number of stream groups.  Each
wrapper checks device, dtype, shape and contiguity, runs the plain version
(``kernels/ref.py``) for CPU tensors, and for CUDA tensors launches its
kernel on the current stream or raises (a row wider than ``MAX_COLS``
included, for the kernels that stage a row); there is no fallback.  Each keeps a
plain integer count of its kernel launches (``launches``), which the card
tests ``test_no_wrapper_takes_its_plain_version_in_a_card_step``,
``test_markov_walk_launches_equal_calls_in_a_batch`` and
``test_adamw_launches_equal_calls_in_a_card_step`` hold to the calls to show
the training path went through the kernels; runs of the plain version do
not count.  Beside it ``calls`` counts every
call that ran, on the card or through the plain version (what
``repro_torch.analysis.step_checks`` holds to the decode-site formula on the
CPU).

Words are ``int32`` tensors holding the uint32 bit patterns of the JAX
package's words (see ``kernels/ref.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adamw import adamw_update
from repro_torch.kernels.lowrank import (
    ACC_DTYPES,
    LOWRANK_AXPY_2D_BF16,
    lowrank_axpy_2d,
    lowrank_project_2d,
)
from repro_torch.kernels.markov import markov_walk
from repro_torch.kernels.ref import (
    MASK32,
    PACKABLE_BITS,
    SIGN_SCALE_MODES,
    SPARSE_MODES,
    axpy_weights,
    dequantize_2d_ref,
    f32_scalar,
    idx_bits_for,
    inv_levels,
    levels_for,
    quantize_2d_ref,
    quantize_pack_2d_ref,
    sign_pack_2d_ref,
    sparse_geometry,
    sparse_scatter_axpy_2d_ref,
    sparse_select_pack_2d_ref,
    sparse_unpack_scatter_2d_ref,
    stream_geometry,
    unpack_dequant_2d_ref,
    unpack_dequant_axpy_2d_ref,
    unpack_sign_axpy_2d_ref,
)

# The widest row a kernel takes: K1 and K3 stage a row in shared memory
# (cols*4 B <= 32 KiB); K6 keeps rows of up to 1024 columns in registers and
# stages wider ones (values, keys and 16-bit columns, cols*10 B <= 80 KiB),
# K6b and K6c their slots.  The plain versions, K4a and K4b take any width.
MAX_COLS = 8192

SPARSE_VALUE_DTYPES = (torch.float32, torch.float16)

# the launch counts of the bf16-accumulator variants, which the f32 kernels'
# wrappers launch for a bfloat16 ``acc``
UNPACK_DEQUANT_AXPY_2D_BF16 = build.LaunchCount("unpack_dequant_axpy_2d_bf16")
UNPACK_SIGN_AXPY_2D_BF16 = build.LaunchCount("unpack_sign_axpy_2d_bf16")
SPARSE_SCATTER_AXPY_2D_BF16 = build.LaunchCount("sparse_scatter_axpy_2d_bf16")


def _check_block(cols: int) -> None:
    if cols % 128 or cols <= 0:
        raise ValueError(f"block_size must be a positive multiple of 128, got {cols}")


def _check_cols(cols: int, bits: int) -> None:
    if bits not in PACKABLE_BITS:
        raise ValueError(f"packable bits are {PACKABLE_BITS}, got {bits}")
    _check_block(cols)


def _check_device(fn_name: str, dev: torch.device, cols: int = 0) -> None:
    """Past the CPU branch: a CUDA tensor whose rows the kernel takes."""
    if dev.type != "cuda":
        raise ValueError(f"{fn_name} runs on cpu or cuda tensors, got {dev}")
    if cols > MAX_COLS:
        raise ValueError(f"{fn_name}'s kernel takes rows of at most {MAX_COLS} columns, "
                         f"got {cols}")


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


def _check_acc(acc: torch.Tensor, out: Optional[torch.Tensor], shape: tuple,
               device: torch.device) -> None:
    """A receive's accumulator (float32 or bfloat16) and ``out``, its dtype."""
    if acc.dtype not in ACC_DTYPES:
        raise TypeError(f"acc must be one of {ACC_DTYPES}, got {acc.dtype}")
    _check_tensor("acc", acc, acc.dtype, shape, device)
    if out is not None:
        _check_tensor("out", out, acc.dtype, shape, device)


def _acc_counter(fn, variant: build.LaunchCount, acc: torch.Tensor):
    """Where a receive counts: its bf16-accumulator ``variant`` for a
    bfloat16 ``acc``, else the wrapper ``fn`` itself."""
    return variant if acc.dtype == torch.bfloat16 else fn


def _plain_into(res: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    return res if out is None else out.copy_(res)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def quantize_pack_2d(x: torch.Tensor, seed: int, *, bits: int, offset: int = 0):
    """Fused quantize + bit-pack of a (rows, cols) f32 tensor, one scale per
    row, element counter ``offset + row*cols + lane`` (mod 2^32).  Returns
    (int32 words (rows, cols*bits/32), f32 scale (rows, 1))."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, cols), got shape {tuple(x.shape)}")
    rows, cols = x.shape
    _check_cols(cols, bits)
    _check_tensor("x", x, torch.float32, (rows, cols), x.device)
    if x.device.type == "cpu":
        build.count_call(quantize_pack_2d)
        return quantize_pack_2d_ref(x, seed, bits=bits, offset=offset)
    _check_device("quantize_pack_2d", x.device, cols)
    words = torch.empty((rows, cols * bits // 32), dtype=torch.int32, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    lib = build.load("quant")
    err = lib.quantize_pack_2d_launch(x.data_ptr(), words.data_ptr(), scale.data_ptr(),
                                      rows, cols, bits, int(seed) & MASK32,
                                      int(offset) & MASK32, _stream(x.device))
    build.check_launch("quantize_pack_2d", err)
    build.count_call(quantize_pack_2d, launched=True)
    return words, scale


def unpack_dequant_axpy_2d(packed: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor,
                           *, bits: int, weight, acc_weight=1.0,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused unpack + dequantize + accumulate:
    ``acc_weight * acc + weight * dequant(packed)`` over (rows, cols).

    ``weight`` and ``acc_weight`` are host numbers, rounded to f32 as the JAX
    kernel's ``(2,)`` f32 operand rounds them.  ``out`` may be ``acc`` itself
    (in-place update, which the runtime uses for params and replicas).
    ``acc`` is float32 or bfloat16 (bf16 replicas: the bf16-accumulator
    kernel, counted as ``unpack_dequant_axpy_2d_bf16``)."""
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
    _check_acc(acc, out, (rows, cols), dev)
    if dev.type == "cpu":
        build.count_call(_acc_counter(unpack_dequant_axpy_2d, UNPACK_DEQUANT_AXPY_2D_BF16, acc))
        return _plain_into(unpack_dequant_axpy_2d_ref(packed, scale, acc, bits=bits,
                                                      weight=weight, acc_weight=acc_weight),
                           out)
    _check_device("unpack_dequant_axpy_2d", dev, cols)
    if out is None:
        out = torch.empty_like(acc)
    aw, wl = axpy_weights(bits, weight, acc_weight)
    lib = build.load("quant")
    bf16 = acc.dtype == torch.bfloat16
    launch = lib.unpack_dequant_axpy_2d_bf16_launch if bf16 \
        else lib.unpack_dequant_axpy_2d_launch
    err = launch(packed.data_ptr(), scale.data_ptr(), acc.data_ptr(), out.data_ptr(), rows,
                 cols, bits, aw, wl, _stream(dev))
    build.check_launch("unpack_dequant_axpy_2d", err)
    build.count_call(_acc_counter(unpack_dequant_axpy_2d, UNPACK_DEQUANT_AXPY_2D_BF16, acc),
                     launched=True)
    return out


def quantize_2d(x: torch.Tensor, seed: int, *, bits: int, offset: int = 0):
    """Quantize a (rows, cols) f32 tensor, one scale per row: K1's head
    with the codes unpacked, counters as K1's.  Returns (int8 codes (rows,
    cols), f32 scale (rows, 1)); ``bits`` in 2..8."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, cols), got shape {tuple(x.shape)}")
    rows, cols = x.shape
    if not 2 <= bits <= 8:
        raise ValueError(f"quantize takes 2..8 bits, got {bits}")
    _check_block(cols)
    _check_tensor("x", x, torch.float32, (rows, cols), x.device)
    if x.device.type == "cpu":
        build.count_call(quantize_2d)
        return quantize_2d_ref(x, seed, bits=bits, offset=offset)
    _check_device("quantize_2d", x.device, cols)
    codes = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    lib = build.load("quant")
    err = lib.quantize_2d_launch(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), rows, cols,
                                 levels_for(bits), int(seed) & MASK32, int(offset) & MASK32,
                                 _stream(x.device))
    build.check_launch("quantize_2d", err)
    build.count_call(quantize_2d, launched=True)
    return codes, scale


def dequantize_2d(codes: torch.Tensor, scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """``code * (scale * f32(1/L))`` over (rows, cols) int8 codes, any
    ``cols >= 1``; f32 (rows, cols)."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D (rows, cols), got {tuple(codes.shape)}")
    rows, cols = codes.shape
    if not 2 <= bits <= 8:
        raise ValueError(f"dequantize takes 2..8 bits, got {bits}")
    if cols < 1:
        raise ValueError("codes need at least one column")
    dev = codes.device
    _check_tensor("codes", codes, torch.int8, (rows, cols), dev)
    _check_tensor("scale", scale, torch.float32, (rows, 1), dev)
    if dev.type == "cpu":
        build.count_call(dequantize_2d)
        return dequantize_2d_ref(codes, scale, bits=bits)
    _check_device("dequantize_2d", dev)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    lib = build.load("quant")
    err = lib.dequantize_2d_launch(codes.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                                   cols, inv_levels(bits), _stream(dev))
    build.check_launch("dequantize_2d", err)
    build.count_call(dequantize_2d, launched=True)
    return out


def unpack_dequant_2d(packed: torch.Tensor, scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Fused unpack + dequantize: (rows, words) stream words, any whole
    number of ``bits``-wide groups a row -> f32 (rows, words*32/bits)."""
    if packed.dim() != 2:
        raise ValueError(f"packed must be 2-D (rows, words), got {tuple(packed.shape)}")
    rows, w = packed.shape
    if bits not in PACKABLE_BITS:
        raise ValueError(f"packable bits are {PACKABLE_BITS}, got {bits}")
    if w <= 0 or w % stream_geometry(bits)[1]:
        raise ValueError(f"word count {w} is not whole {bits}-bit groups")
    dev = packed.device
    _check_tensor("packed", packed, torch.int32, (rows, w), dev)
    _check_tensor("scale", scale, torch.float32, (rows, 1), dev)
    if dev.type == "cpu":
        build.count_call(unpack_dequant_2d)
        return unpack_dequant_2d_ref(packed, scale, bits=bits)
    _check_device("unpack_dequant_2d", dev)
    cols = w * 32 // bits
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    lib = build.load("quant")
    err = lib.unpack_dequant_2d_launch(packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                       rows, cols, bits, inv_levels(bits), _stream(dev))
    build.check_launch("unpack_dequant_2d", err)
    build.count_call(unpack_dequant_2d, launched=True)
    return out


def sign_pack_2d(x: torch.Tensor, *, scale_mode: str = "mean"):
    """Fused 1-bit sign + pack of a (rows, cols) f32 tensor: bit ``x >= 0``,
    32 per word (element ``j*G + g`` is bit ``j`` of word ``g``), one scale
    per row (``mean``: mean|x|, ``l2``: sqrt(mean x^2)).  Returns (int32
    words (rows, cols/32), f32 scale (rows, 1))."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, cols), got shape {tuple(x.shape)}")
    rows, cols = x.shape
    _check_block(cols)
    if scale_mode not in SIGN_SCALE_MODES:
        raise ValueError(f"sign scale modes are {SIGN_SCALE_MODES}, got {scale_mode!r}")
    _check_tensor("x", x, torch.float32, (rows, cols), x.device)
    if x.device.type == "cpu":
        build.count_call(sign_pack_2d)
        return sign_pack_2d_ref(x, scale_mode=scale_mode)
    _check_device("sign_pack_2d", x.device, cols)
    words = torch.empty((rows, cols // 32), dtype=torch.int32, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    lib = build.load("sign")
    err = lib.sign_pack_2d_launch(x.data_ptr(), words.data_ptr(), scale.data_ptr(), rows,
                                  cols, int(scale_mode == "l2"), _stream(x.device))
    build.check_launch("sign_pack_2d", err)
    build.count_call(sign_pack_2d, launched=True)
    return words, scale


def unpack_sign_axpy_2d(packed: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor,
                        *, weight, acc_weight=1.0,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused unpack + sign decode + accumulate:
    ``acc_weight * acc + (2u - 1) * (scale * weight)`` over (rows, cols).
    ``out`` may be ``acc`` itself (in-place update).  ``acc`` is float32 or
    bfloat16 (counted as ``unpack_sign_axpy_2d_bf16``)."""
    if packed.dim() != 2:
        raise ValueError(f"packed must be 2-D (rows, words), got {tuple(packed.shape)}")
    rows, w = packed.shape
    cols = w * 32
    _check_block(cols)
    dev = packed.device
    _check_tensor("packed", packed, torch.int32, (rows, w), dev)
    _check_tensor("scale", scale, torch.float32, (rows, 1), dev)
    _check_acc(acc, out, (rows, cols), dev)
    if dev.type == "cpu":
        build.count_call(_acc_counter(unpack_sign_axpy_2d, UNPACK_SIGN_AXPY_2D_BF16, acc))
        return _plain_into(unpack_sign_axpy_2d_ref(packed, scale, acc, weight=weight,
                                                   acc_weight=acc_weight), out)
    _check_device("unpack_sign_axpy_2d", dev, cols)
    if out is None:
        out = torch.empty_like(acc)
    lib = build.load("sign")
    bf16 = acc.dtype == torch.bfloat16
    launch = lib.unpack_sign_axpy_2d_bf16_launch if bf16 else lib.unpack_sign_axpy_2d_launch
    err = launch(packed.data_ptr(), scale.data_ptr(), acc.data_ptr(), out.data_ptr(), rows,
                 cols, f32_scalar(acc_weight), f32_scalar(weight), _stream(dev))
    build.check_launch("unpack_sign_axpy_2d", err)
    build.count_call(_acc_counter(unpack_sign_axpy_2d, UNPACK_SIGN_AXPY_2D_BF16, acc),
                     launched=True)
    return out


def sparse_select_pack_2d(x: torch.Tensor, seed: int, *, p: float, mode: str,
                          value_dtype=torch.float32, offset: int = 0):
    """Fused fixed-capacity selection of a (rows, cols) f32 tensor: ``k =
    ceil(p*cols)`` elements a row in canonical order (descending key, ties to
    the smaller index; ``topk`` key |x| with NaN last, ``randk`` key the PCG
    hash of the fold's counter ``offset + row*cols + lane``, values rescaled
    by cols/k), their indices
    stream-packed.  Returns (values (rows, k) ``value_dtype``, int32 words
    (rows, words)) with ``k, words`` from ``sparse_geometry(cols, p)``."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, cols), got shape {tuple(x.shape)}")
    rows, cols = x.shape
    _check_block(cols)
    if mode not in SPARSE_MODES:
        raise ValueError(f"sparse modes are {SPARSE_MODES}, got {mode!r}")
    if not 0.0 < p <= 1.0:
        raise ValueError(f"keep fraction p must be in (0, 1], got {p}")
    if value_dtype not in SPARSE_VALUE_DTYPES:
        raise TypeError(f"sparse values are {SPARSE_VALUE_DTYPES}, got {value_dtype}")
    _check_tensor("x", x, torch.float32, (rows, cols), x.device)
    if x.device.type == "cpu":
        build.count_call(sparse_select_pack_2d)
        return sparse_select_pack_2d_ref(x, seed, p=p, mode=mode, value_dtype=value_dtype,
                                         offset=offset)
    _check_device("sparse_select_pack_2d", x.device, cols)
    k, _, kpad, n_words = sparse_geometry(cols, p)
    values = torch.empty((rows, k), dtype=value_dtype, device=x.device)
    words = torch.empty((rows, n_words), dtype=torch.int32, device=x.device)
    lib = build.load("sparse")
    err = lib.sparse_select_pack_2d_launch(
        x.data_ptr(), values.data_ptr(), words.data_ptr(), rows, cols, k, kpad,
        int(mode == "topk"), int(value_dtype == torch.float16), int(seed) & MASK32,
        int(offset) & MASK32, f32_scalar(cols / k), _stream(x.device))
    build.check_launch("sparse_select_pack_2d", err)
    build.count_call(sparse_select_pack_2d, launched=True)
    return values, words


def sparse_select_pack_2d_grid(rows: int, cols: int, p: float) -> int:
    """The CUDA grid (CTAs) K6 takes for a 16-byte aligned (rows, cols) fold
    at keep fraction ``p``, read from the launcher's own dispatch without
    launching; builds the library on first use."""
    _check_block(cols)
    k, _, kpad, _ = sparse_geometry(cols, p)
    grid = build.load("sparse").sparse_select_pack_2d_grid(rows, cols, k, kpad)
    if grid < 0:
        raise ValueError(f"K6 takes no ({rows}, {cols}) fold at p={p}")
    return grid


def sparse_unpack_scatter_2d(values: torch.Tensor, packed: torch.Tensor, *,
                             cols: int) -> torch.Tensor:
    """Fused unpack + scatter: (rows, k) values and their stream-packed
    indices -> dense f32 (rows, cols), each value added into zeros (a kept
    -0.0 decodes to +0.0) and every other lane +0.0."""
    if values.dim() != 2:
        raise ValueError(f"values must be 2-D (rows, k), got {tuple(values.shape)}")
    rows, k = values.shape
    _check_block(cols)
    if not 0 < k <= cols:
        raise ValueError(f"k={k} values do not fit a {cols}-wide row")
    if values.dtype not in SPARSE_VALUE_DTYPES:
        raise TypeError(f"sparse values are {SPARSE_VALUE_DTYPES}, got {values.dtype}")
    idx_bits = idx_bits_for(cols)
    cpg, _ = stream_geometry(idx_bits)
    kpad = -(-k // cpg) * cpg
    dev = values.device
    _check_tensor("values", values, values.dtype, (rows, k), dev)
    _check_tensor("packed", packed, torch.int32, (rows, kpad * idx_bits // 32), dev)
    if dev.type == "cpu":
        build.count_call(sparse_unpack_scatter_2d)
        return sparse_unpack_scatter_2d_ref(values, packed, cols=cols)
    _check_device("sparse_unpack_scatter_2d", dev, cols)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    lib = build.load("sparse")
    err = lib.sparse_unpack_scatter_2d_launch(
        values.data_ptr(), packed.data_ptr(), out.data_ptr(), rows, cols, k, kpad,
        int(values.dtype == torch.float16), _stream(dev))
    build.check_launch("sparse_unpack_scatter_2d", err)
    build.count_call(sparse_unpack_scatter_2d, launched=True)
    return out


def sparse_scatter_axpy_2d(values: torch.Tensor, packed: torch.Tensor, acc: torch.Tensor,
                           *, weight, acc_weight=1.0,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused unpack + scatter + accumulate: ``acc_weight * acc + weight *
    scatter(values)`` over (rows, cols), a lane that receives no value
    adding +0.0.  ``out`` may be ``acc`` itself (in-place update).  ``acc``
    is float32 or bfloat16 (counted as ``sparse_scatter_axpy_2d_bf16``)."""
    if values.dim() != 2 or acc.dim() != 2:
        raise ValueError(f"values and acc must be 2-D, got {tuple(values.shape)}, "
                         f"{tuple(acc.shape)}")
    rows, k = values.shape
    cols = acc.shape[1]
    _check_block(cols)
    if not 0 < k <= cols:
        raise ValueError(f"k={k} values do not fit a {cols}-wide row")
    if values.dtype not in SPARSE_VALUE_DTYPES:
        raise TypeError(f"sparse values are {SPARSE_VALUE_DTYPES}, got {values.dtype}")
    idx_bits = idx_bits_for(cols)
    cpg, _ = stream_geometry(idx_bits)
    kpad = -(-k // cpg) * cpg
    dev = values.device
    _check_tensor("values", values, values.dtype, (rows, k), dev)
    _check_tensor("packed", packed, torch.int32, (rows, kpad * idx_bits // 32), dev)
    _check_acc(acc, out, (rows, cols), dev)
    if dev.type == "cpu":
        build.count_call(_acc_counter(sparse_scatter_axpy_2d, SPARSE_SCATTER_AXPY_2D_BF16, acc))
        return _plain_into(sparse_scatter_axpy_2d_ref(values, packed, acc, weight=weight,
                                                      acc_weight=acc_weight), out)
    _check_device("sparse_scatter_axpy_2d", dev, cols)
    if out is None:
        out = torch.empty_like(acc)
    lib = build.load("sparse")
    bf16 = acc.dtype == torch.bfloat16
    launch = lib.sparse_scatter_axpy_2d_bf16_launch if bf16 \
        else lib.sparse_scatter_axpy_2d_launch
    err = launch(values.data_ptr(), packed.data_ptr(), acc.data_ptr(), out.data_ptr(), rows,
                 cols, k, kpad, int(values.dtype == torch.float16), f32_scalar(acc_weight),
                 f32_scalar(weight), _stream(dev))
    build.check_launch("sparse_scatter_axpy_2d", err)
    build.count_call(_acc_counter(sparse_scatter_axpy_2d, SPARSE_SCATTER_AXPY_2D_BF16, acc),
                     launched=True)
    return out


KERNEL_WRAPPERS = (quantize_pack_2d, unpack_dequant_axpy_2d, quantize_2d, dequantize_2d,
                   unpack_dequant_2d, sign_pack_2d, unpack_sign_axpy_2d,
                   sparse_select_pack_2d, sparse_unpack_scatter_2d, sparse_scatter_axpy_2d,
                   lowrank_project_2d, lowrank_axpy_2d, UNPACK_DEQUANT_AXPY_2D_BF16,
                   UNPACK_SIGN_AXPY_2D_BF16, SPARSE_SCATTER_AXPY_2D_BF16, LOWRANK_AXPY_2D_BF16,
                   markov_walk, adamw_update)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_call_counts() -> None:
    """Set every kernel's call count to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.calls = 0


def call_counts() -> dict:
    """Every wrapper's calls on real tensors, its plain version's included:
    on the card ``call_counts() == launch_counts()`` shows that no wrapper
    ran its plain version."""
    return {fn.__name__: fn.calls for fn in KERNEL_WRAPPERS}


reset_launch_counts()
reset_call_counts()
