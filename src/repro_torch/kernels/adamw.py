"""Wrapper of the optim layer's AdamW kernel (``csrc/adamw.cu``).

:func:`adamw_update` updates one leaf's moments ``m`` and ``v`` in place and
returns its update in a new float32 tensor, in one pass that reads ``g``,
``p``, ``m`` and ``v`` once (``kernels/ref.py``, :func:`~repro_torch.kernels.
ref.adamw_update_ref`, is the eager body it replaces).  Same contract as
``kernels/markov.py``: it checks device, dtype, shape and contiguity, runs
the plain version for CPU tensors, and for CUDA tensors launches the kernel
on the current stream or raises; there is no fallback.  ``g`` and ``p`` are
both float32 or both bfloat16 (ECD's bf16 estimates make both bf16 after
the first step), ``m`` and ``v`` float32.  ``launches`` counts its kernel launches,
``calls`` every call, the plain version's too, so ``launches / calls`` is
the share of updates that took the kernel; both are read and reset with the
wire kernels' counts (``kernels/quant.py`` :data:`~repro_torch.kernels.quant.
KERNEL_WRAPPERS`).

On the card ``m``, ``v`` and the update are bit-equal to the plain
version's on the card: the kernel takes the scalars that torch's eager
kernels take (:func:`adamw_scalars`) and rounds each operation as they do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import adamw_bias_corrections, adamw_update_ref

LEAF_DTYPES = (torch.float32, torch.bfloat16)       # of g and p; m and v are float32


def adamw_scalars(*, b1: float, b2: float, eps: float, weight_decay: float, lr: float,
                  t: int) -> tuple:
    """The kernel's float32 scalars ``(b1, 1-b1, b2, 1-b2, 1/bc1, 1/bc2, eps,
    wd, -lr)`` as torch's CUDA functors take them from the eager body: each
    Python scalar rounded to float32 (``1 - b1`` and ``-lr`` computed in
    Python first), and a division by a host scalar as the product with the
    float32 reciprocal ``f32(1) / f32(bc)``."""
    f32 = np.float32
    bc1, bc2 = adamw_bias_corrections(b1, b2, t)
    return tuple(float(x) for x in (
        f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(1) / f32(bc1), f32(1) / f32(bc2),
        f32(eps), f32(weight_decay), f32(-lr)))


def _check(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, p: torch.Tensor) -> None:
    if g.dtype != p.dtype or g.dtype not in LEAF_DTYPES:
        raise TypeError(f"g and p must be both float32 or both bfloat16, got {g.dtype}, "
                        f"{p.dtype}")
    for name, x in (("m", m), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if not g.shape == m.shape == v.shape == p.shape:
        raise ValueError(f"g, m, v and p must have one shape, got {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}, {tuple(p.shape)}")
    if not all(x.is_contiguous() for x in (g, m, v, p)):
        raise ValueError("g, m, v and p must be contiguous")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"adamw_update runs on cpu or cuda tensors, got {g.device}")
    if not g.device == m.device == v.device == p.device:
        raise ValueError(f"g, m, v and p must be on one device, got {g.device}, {m.device}, "
                         f"{v.device}, {p.device}")


def adamw_update(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, p: torch.Tensor, *,
                 b1: float, b2: float, eps: float, weight_decay: float, lr: float,
                 t: int) -> torch.Tensor:
    """One AdamW step of a leaf: gradient ``g``, moments ``m`` and ``v``
    (updated in place), parameters ``p``, host scalars, ``t`` the 1-based
    step.  Returns ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, float32."""
    _check(g, m, v, p)
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, lr=lr, t=t)
    if g.device.type == "cpu":
        build.count_call(adamw_update)
        return adamw_update_ref(g, m, v, p, **kw)
    out = torch.empty_like(m)
    err = build.load("adamw").adamw_update_launch(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), out.data_ptr(), g.numel(),
        int(g.dtype == torch.bfloat16), *adamw_scalars(**kw),
        torch.cuda.current_stream(g.device).cuda_stream)
    build.check_launch("adamw_update", err)
    build.count_call(adamw_update, launched=True)
    return out


adamw_update.launches = 0
adamw_update.calls = 0
