"""Wrappers of the low-rank wire kernels: low-rank project (K7a) and low-rank
axpy (K7b) in ``csrc/lowrank.cu``.

The JAX package's ``lowrank_project_2d`` / ``lowrank_axpy_2d`` take one
(rows, n) slab; these take a whole leaf's lead batch in one launch (the JAX
runtime vmaps the kernel over it): ``m`` and ``acc`` (batch, rows, n), ``p``
(batch, rows, r), and the right factor ``v`` (batch, n, r) whose batch
stride is ``n*r`` (a factor per slab, the warm wire and every payload) or
0 (one (n, r) factor shared by the batch, the cold start: pass
``v0.expand(batch, n, r)``, no copy).  2-D arguments are a batch of one.

Same contract as ``kernels/quant.py``: each wrapper checks device, dtype,
shape, contiguity and strides, runs the plain version (``kernels/ref.py``)
for CPU tensors, returns an empty result of the right shape for ``meta``
tensors (wire accounting) and for CUDA tensors launches its kernel on the
current stream or raises; there is no fallback.  Ranks 1..128 (the JAX
wire's range); K7b needs ``n % 128 == 0``, the wire's gate.  Each counts its
launches in ``launches``; plain and shapes-only runs do not count.  Each
counts in ``calls`` every run on real tensors, the plain version's too
(meta, shapes only, is no call).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import f32_scalar, lowrank_axpy_2d_ref, lowrank_project_2d_ref

MAX_RANK = 128
# the launch count of K7b's bf16-accumulator variant (bf16 replicas)
LOWRANK_AXPY_2D_BF16 = build.LaunchCount("lowrank_axpy_2d_bf16")
# the accumulators of the fused receives (K2, K5b, K6c, K7b): float32, or
# bfloat16 for bf16 replicas and estimates, each dtype its own kernel
ACC_DTYPES = (torch.float32, torch.bfloat16)
MAX_BATCH = 65535           # one grid dimension of CTAs per slab
AXPY_MAX_ROWS = 65535 * 16  # K7b's row tiles of 16 in one grid dimension


def _as_batched(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dim() == 2:
        return t.unsqueeze(0)
    if t.dim() != 3:
        raise ValueError(f"{name} must be 2-D or 3-D (batch first), got {tuple(t.shape)}")
    return t


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device: torch.device,
           dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_contiguous(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _factor_batch_stride(v: torch.Tensor) -> int:
    """The batch stride of a (batch, n, r) factor: its slabs are contiguous
    (n, r) and either shared (stride 0) or consecutive (stride n*r)."""
    batch, n, r = v.shape
    if n > 1 and v.stride(1) != r or r > 1 and v.stride(2) != 1:
        raise ValueError(f"the factor's (n, r) slabs must be contiguous, strides {v.stride()}")
    if batch > 1 and v.stride(0) not in (0, n * r):
        raise ValueError(f"the factor's batch stride must be 0 or n*r={n * r}, "
                         f"got {v.stride(0)}")
    return v.stride(0) if batch > 1 else 0


def _check_cuda(fn_name: str, dev: torch.device, batch: int, r: int) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{fn_name} runs on cpu, meta or cuda tensors, got {dev}")
    if batch > MAX_BATCH:
        raise ValueError(f"{fn_name}'s kernel takes at most {MAX_BATCH} slabs, got {batch}")


def _check_rank(r: int) -> None:
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lowrank ranks are 1..{MAX_RANK}, got {r}")


def lowrank_project_2d(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``P = M @ V``: (batch, rows, n) f32 x (batch, n, r) f32 -> (batch,
    rows, r) f32 (2-D in, 2-D out), the sum over ``n`` in the fixed order of
    :func:`~repro_torch.kernels.ref.lowrank_project_2d_ref`."""
    two_d = m.dim() == 2
    mb, vb = _as_batched(m, "m"), _as_batched(v, "v")
    batch, rows, n = mb.shape
    r = vb.shape[-1]
    _check_rank(r)
    dev = m.device
    _check("m", mb, (batch, rows, n), dev)
    _check("v", vb, (batch, n, r), dev)
    _check_contiguous("m", mb)
    if dev.type == "meta":
        out = torch.empty((batch, rows, r), dtype=torch.float32, device=dev)
    elif dev.type == "cpu":
        build.count_call(lowrank_project_2d)
        out = lowrank_project_2d_ref(mb, vb)
    else:
        _check_cuda("lowrank_project_2d", dev, batch, r)
        v_bstride = _factor_batch_stride(vb)
        out = torch.empty((batch, rows, r), dtype=torch.float32, device=dev)
        lib = build.load("lowrank")
        err = lib.lowrank_project_2d_launch(mb.data_ptr(), vb.data_ptr(), out.data_ptr(),
                                            batch, rows, n, r, v_bstride,
                                            torch.cuda.current_stream(dev).cuda_stream)
        build.check_launch("lowrank_project_2d", err)
        build.count_call(lowrank_project_2d, launched=True)
    return out[0] if two_d else out


def lowrank_axpy_2d(p: torch.Tensor, v: torch.Tensor, acc: torch.Tensor, *, weight,
                    acc_weight=1.0, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused rank-r reconstruction + accumulate: ``acc_weight * acc + weight
    * (P @ V^T)`` over (batch, rows, n), P (batch, rows, r), V (batch, n, r)
    (2-D: a batch of one).  ``weight`` and ``acc_weight`` are host numbers
    rounded to f32; ``out`` may be ``acc`` itself (in-place update).
    ``acc`` is float32 or bfloat16 (the bf16-accumulator kernel, counted as
    ``lowrank_axpy_2d_bf16``)."""
    two_d = acc.dim() == 2
    pb, vb, ab = _as_batched(p, "p"), _as_batched(v, "v"), _as_batched(acc, "acc")
    batch, rows, n = ab.shape
    r = pb.shape[-1]
    _check_rank(r)
    if n % 128 or n <= 0:
        raise ValueError(f"lowrank_axpy_2d needs n % 128 == 0, got n={n}")
    dev = acc.device
    _check("p", pb, (batch, rows, r), dev)
    _check("v", vb, (batch, n, r), dev)
    _check("acc", ab, (batch, rows, n), dev, ACC_DTYPES)
    _check_contiguous("p", pb)
    _check_contiguous("acc", ab)
    if out is not None:
        _check("out", out, tuple(acc.shape), dev, (acc.dtype,))
        _check_contiguous("out", out)
    if dev.type == "meta":
        return torch.empty_like(acc) if out is None else out
    if dev.type == "cpu":
        build.count_call(LOWRANK_AXPY_2D_BF16 if acc.dtype == torch.bfloat16
                         else lowrank_axpy_2d)
        res = lowrank_axpy_2d_ref(pb, vb, ab, weight=weight, acc_weight=acc_weight)
        res = res[0] if two_d else res
        return res if out is None else out.copy_(res)
    _check_cuda("lowrank_axpy_2d", dev, batch, r)
    if rows > AXPY_MAX_ROWS:
        raise ValueError(f"lowrank_axpy_2d's kernel takes at most {AXPY_MAX_ROWS} rows a slab, "
                         f"got {rows}")
    v_bstride = _factor_batch_stride(vb)
    if out is None:
        out = torch.empty_like(acc)
    lib = build.load("lowrank")
    bf16 = acc.dtype == torch.bfloat16
    launch = lib.lowrank_axpy_2d_bf16_launch if bf16 else lib.lowrank_axpy_2d_launch
    err = launch(pb.data_ptr(), vb.data_ptr(), ab.data_ptr(), out.data_ptr(), batch, rows, n,
                 r, v_bstride, f32_scalar(acc_weight), f32_scalar(weight),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("lowrank_axpy_2d", err)
    build.count_call(LOWRANK_AXPY_2D_BF16 if bf16 else lowrank_axpy_2d, launched=True)
    return out


lowrank_project_2d.launches = lowrank_project_2d.calls = 0
lowrank_axpy_2d.launches = lowrank_axpy_2d.calls = 0
