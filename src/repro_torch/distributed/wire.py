"""The gossip wire-format protocol: quant, sign, sparse, fp16 and identity.

The port of the JAX package's ``distributed/wire.py`` for those five
formats: the same per-leaf protocol (``encode`` / ``decode`` /
``decode_axpy``), the same (step, salt, leaf) seeding and the same blocked
payload containers, so a payload encoded here is bit-equal to the JAX
package's for the same leaf and counter (the sign codec's per-block scale
excepted: it is a sum, taken here in the kernel's fixed order, and agrees
with the JAX package's ``jnp.mean`` to rounding).

* ``encode(leaf, seed)`` blocks the LAST dim: the leaf (lead..., d) is padded
  to whole blocks and folded row-major to (rows, block).  With
  ``block % 128 == 0``, the JAX package's gate, the fold goes through the
  format's send kernel (whose wrapper raises on a CUDA row wider than the
  kernel takes, ``MAX_COLS``) —
  K1 :func:`~repro_torch.kernels.quant.quantize_pack_2d` (``quant`` at bits
  2..7), K5a :func:`~repro_torch.kernels.quant.sign_pack_2d` (``sign``), K6
  :func:`~repro_torch.kernels.quant.sparse_select_pack_2d` (``sparse``) —
  whose counter ``row*block + lane`` is the flat index of the blocked view
  (:func:`_block_counters`).  Other blocks, ``quant`` at 8 bits, and the
  shapes-only ``meta`` accounting run the plain versions.  (The JAX runtime
  encodes in jnp; the port puts a kernel on the send side too, held to the
  same words.)
* ``decode_axpy_(payload, acc, weight, acc_weight)`` adds the decoded payload
  into ``acc`` IN PLACE through the format's receive kernel (K2, K5b, K6c)
  behind the same gate (the JAX package's ``block % 128``); off the gate it
  runs the plain decode-then-axpy.  The JAX package is pure and returns new
  arrays; the port updates params, replicas and estimates in place, because
  at full width every leaf-sized temporary costs gigabytes.

Payloads: ``quant`` ``{"codes": (lead..., nblk, W) int32 words | (lead...,
nblk, block) int8, "scale": (lead..., nblk, 1) f32}``; ``sign`` ``{"codes":
(lead..., nblk, block/32) int32 words, "scale": (lead..., nblk, 1) f32}``;
``sparse`` ``{"values": (lead..., nblk, k) f32 | f16, "idx": (lead..., nblk,
words) int32}``; ``fp16`` and ``identity`` ``{"values": leaf}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.quant import (
    quantize_pack_2d,
    sign_pack_2d,
    sparse_scatter_axpy_2d,
    sparse_select_pack_2d,
    unpack_dequant_axpy_2d,
    unpack_sign_axpy_2d,
)
from repro_torch.kernels.ref import (
    MASK32,
    SIGN_SCALE_MODES,
    SPARSE_MODES,
    aligned_block,
    assert_packable,
    dequantize_2d_ref,
    levels_for,
    packed_auto,
    quantize_pack_2d_ref,
    sign_pack_2d_ref,
    sparse_select_pack_2d_ref,
    sparse_unpack_scatter_2d_ref,
    uniform_from_hash,
    unpack_codes,
    unpack_sign_2d_ref,
)
from repro_torch.tree import leaf_items, tree_from_items

Payload = Dict[str, torch.Tensor]


def leaf_seed(step: int, salt: int, leaf_index: int) -> int:
    """``uint32(step) * 2654435761 ^ uint32(salt*97 + leaf)`` — the JAX
    package's (step, salt, leaf) seeding recipe (``wire.py:86``)."""
    return (((int(step) & MASK32) * 2654435761) & MASK32) ^ ((salt * 97 + leaf_index) & MASK32)


def _block_counters(shape: Tuple[int, ...], device) -> torch.Tensor:
    """Flat uint32 counter (as int64) of every element of a blocked view of
    ``shape`` — mod 2^32 like the JAX package's."""
    idx = torch.zeros(shape, dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        view = [1] * len(shape)
        view[d] = shape[d]
        iota = torch.arange(shape[d], dtype=torch.int64, device=device).reshape(view)
        idx = (idx + iota * (stride % (1 << 32))) & MASK32
        stride *= shape[d]
    return idx


def _pad_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """(lead..., d) -> (lead..., nblk, block), zero-padding the last dim."""
    last = x.shape[-1]
    pad = (-last) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], (last + pad) // block, block)


def _quantize_nd(x: torch.Tensor, seed: int, *, bits: int, block: int):
    """Plain stochastic quantization blocked along the last dim (the JAX
    package's ``_quantize_nd``): int8 codes (..., nblk, block), scales."""
    levels = levels_for(bits)
    xb = _pad_blocks(x.to(torch.float32), block)
    scale = xb.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    v = xb * (torch.full_like(safe, levels) / safe)   # true division, see kernels/ref.py
    u = uniform_from_hash(_block_counters(tuple(xb.shape), xb.device), seed)
    floor = torch.floor(v)
    q = floor + (u < (v - floor)).to(torch.float32)
    return q.clamp(-levels, levels).to(torch.int8), scale


def _dequantize_nd(codes: torch.Tensor, scale: torch.Tensor, *, bits: int,
                   orig_last: int, dtype) -> torch.Tensor:
    vals = dequantize_2d_ref(codes, scale, bits=bits)   # broadcasts per block
    out = vals.reshape(*vals.shape[:-2], vals.shape[-2] * vals.shape[-1])
    return out[..., :orig_last].to(dtype)


def _axpy_folded_(acc: torch.Tensor, nblk: int, block: int,
                  launch: Callable[[torch.Tensor], Any]) -> torch.Tensor:
    """Run ``launch(f2d)``, a receive kernel that updates the (rows, block)
    fold ``f2d`` of ``acc`` in place, and return ``acc``.  A leaf whose last
    dim is not whole blocks is padded into a temporary fold and copied back
    (as the JAX package pads its accumulator)."""
    if acc.dtype != torch.float32:
        raise TypeError(f"the fused receive accumulates in float32, got {acc.dtype}")
    last = acc.shape[-1]
    folded = acc if nblk * block == last and acc.is_contiguous() \
        else F.pad(acc, (0, nblk * block - last)).contiguous()
    launch(folded.view(-1, block))
    if folded is not acc:
        acc.copy_(folded[..., :last])
    return acc


def _unfold(vals2d: torch.Tensor, lead: Tuple[int, ...], orig_last: int, dtype) -> torch.Tensor:
    """(rows, block) decoded fold -> (lead..., d): the inverse of
    :func:`_pad_blocks` with the fold, ``lead`` ending in the block count."""
    out = vals2d.reshape(*lead[:-1], lead[-1] * vals2d.shape[-1])
    return out[..., :orig_last].to(dtype)


def payload_nbytes(payload: Payload) -> int:
    return sum(t.numel() * t.element_size() for t in payload.values())


# ------------------------------------------------------------------- protocol

class WireFormat:
    """Base class: the per-leaf protocol plus the shared tree plumbing."""

    name: ClassVar[str] = "base"

    def encode(self, leaf: torch.Tensor, seed: int) -> Payload:
        raise NotImplementedError

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode_axpy_(self, payload: Payload, acc: torch.Tensor, weight,
                     acc_weight=1.0) -> torch.Tensor:
        """``acc <- acc_weight*acc + weight*decode(payload)`` in place; the
        default decodes at f32 then accumulates (the JAX base path)."""
        d = self.decode(payload, torch.empty(acc.shape, dtype=torch.float32, device="meta"))
        acc.copy_(acc_weight * acc + weight * d)
        return acc

    def decode_axpy(self, payload: Payload, acc: torch.Tensor, weight,
                    acc_weight=1.0) -> torch.Tensor:
        """Functional form of :meth:`decode_axpy_` (``acc`` is left as is)."""
        return self.decode_axpy_(payload, acc.clone(), weight, acc_weight)

    @property
    def packed(self) -> bool:
        return False

    @property
    def wire_format(self) -> str:
        """Human-readable container description."""
        return self.name

    @staticmethod
    def _kernel_ok(block: int) -> bool:
        """The one fused-kernel gate: the kernels' lane contract is
        ``block % 128 == 0``."""
        return block % 128 == 0

    # --- tree-level plumbing (one step/salt/leaf seeding path) ------------
    def encode_tree(self, tree: Any, step: int, salt: int):
        """tree of (n, ...) leaves -> (paths, [payload per leaf]), seeded by
        the leaf's index in JAX flatten order."""
        items = leaf_items(tree)
        return ([p for p, _ in items],
                [self.encode(leaf, leaf_seed(step, salt, li))
                 for li, (_, leaf) in enumerate(items)])

    def decode_tree(self, paths, payloads, like_tree: Any) -> Any:
        likes = [leaf for _, leaf in leaf_items(like_tree)]
        return tree_from_items([(p, self.decode(pl, like))
                                for p, pl, like in zip(paths, payloads, likes)])

    def decode_axpy_tree(self, paths, payloads, acc_tree: Any, weight,
                         acc_weight=1.0) -> Any:
        accs = [leaf for _, leaf in leaf_items(acc_tree)]
        return tree_from_items([(p, self.decode_axpy(pl, acc, weight, acc_weight))
                                for p, pl, acc in zip(paths, payloads, accs)])

    # --- wire accounting from the real containers -------------------------
    def wire_nbytes(self, tree: Any) -> int:
        """Wire bytes of one encoded payload of ``tree``, from the containers
        the encoder builds on ``meta`` tensors (shapes only, nothing computed)."""
        metas = [torch.empty(leaf.shape, dtype=torch.float32, device="meta")
                 for _, leaf in leaf_items(tree)]
        return sum(payload_nbytes(self.encode(m, 0)) for m in metas)

    def wire_bits_per_element(self, shape=None) -> float:
        n = 1
        for d in (shape if shape is not None else (getattr(self, "block", 128),)):
            n *= int(d)
        return 8.0 * self.wire_nbytes({"x": torch.empty((n,), device="meta")}) / n


# ------------------------------------------------------------ implementations

@dataclasses.dataclass(frozen=True)
class QuantWire(WireFormat):
    """Stochastic ``bits``-bit codes + per-block scales; stream-packed uint32
    words (int32 containers) at bits 2..7, int8 codes at 8."""

    bits: int = 8
    block: int = 1024
    pack: Optional[bool] = None

    name: ClassVar[str] = "quant"

    def __post_init__(self):
        if not 2 <= self.bits <= 8:
            raise ValueError("2..8-bit levels supported")
        if self.pack:
            assert_packable(self.bits, self.block)

    @property
    def packed(self) -> bool:
        return packed_auto(self.bits, self.block) if self.pack is None else self.pack

    @property
    def levels(self) -> int:
        return levels_for(self.bits)

    @property
    def wire_format(self) -> str:
        return "packed-stream-u32" if self.packed else "int8"

    def _block_for(self, last: int) -> int:
        if self.packed:
            return aligned_block(self.block, last, bits=self.bits)
        return min(self.block, max(last, 1))

    def encode(self, leaf: torch.Tensor, seed: int) -> Payload:
        block = self._block_for(leaf.shape[-1])
        if not self.packed:
            codes, scale = _quantize_nd(leaf, seed, bits=self.bits, block=block)
            return {"codes": codes, "scale": scale}
        xb = _pad_blocks(leaf.to(torch.float32), block)
        lead = xb.shape[:-1]
        x2d = xb.reshape(-1, block)
        if self._kernel_ok(block) and leaf.device.type != "meta":
            words, scale = quantize_pack_2d(x2d, seed, bits=self.bits)
        else:   # off the kernel gate (or shapes only): the plain encode
            words, scale = quantize_pack_2d_ref(x2d, seed, bits=self.bits)
        return {"codes": words.reshape(*lead, words.shape[-1]),
                "scale": scale.reshape(*lead, 1)}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        codes = unpack_codes(payload["codes"], bits=self.bits) \
            if self.packed else payload["codes"]
        return _dequantize_nd(codes, payload["scale"], bits=self.bits,
                              orig_last=like.shape[-1], dtype=like.dtype)

    def decode_axpy_(self, payload: Payload, acc: torch.Tensor, weight,
                     acc_weight=1.0) -> torch.Tensor:
        """One K2 launch per packed leaf: unpack -> dequantize ->
        ``acc_weight*acc + weight*value``, written back into ``acc``."""
        codes = payload["codes"]
        block = codes.shape[-1] * 32 // self.bits if self.packed else codes.shape[-1]
        if not (self.packed and self._kernel_ok(block)):
            return super().decode_axpy_(payload, acc, weight, acc_weight)
        return _axpy_folded_(acc, codes.shape[-2], block, lambda f2d: unpack_dequant_axpy_2d(
            codes.reshape(-1, codes.shape[-1]), payload["scale"].reshape(-1, 1), f2d,
            bits=self.bits, weight=weight, acc_weight=acc_weight, out=f2d))


@dataclasses.dataclass(frozen=True)
class SparseWire(WireFormat):
    """Fixed-capacity values + stream-packed indices: every ``block``-element
    block of a leaf's last dim keeps ``k = ceil(p * block)`` values
    (``randk``: a seeded uniform k-subset rescaled by ``block/k``; ``topk``:
    the k largest magnitudes) and their block-local indices at
    ``ceil(log2(block))`` bits each."""

    p: float = 0.25
    block: int = 128
    mode: str = "randk"
    value_dtype: str = "float32"    # "float32" | "float16" (wire container)

    name: ClassVar[str] = "sparse"

    def __post_init__(self):
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"keep fraction p must be in (0, 1], got {self.p}")
        if self.mode not in SPARSE_MODES:
            raise ValueError(f"sparse modes are {SPARSE_MODES}, got {self.mode!r}")
        if self.value_dtype not in ("float32", "float16"):
            raise ValueError(f"value_dtype is float32 or float16, got {self.value_dtype!r}")

    @property
    def packed(self) -> bool:
        return True

    @property
    def wire_format(self) -> str:
        vals = "f16" if self.value_dtype == "float16" else "f32"
        return f"sparse-{self.mode}-{vals}+packed-idx-u32"

    def _block_for(self, last: int) -> int:
        return min(self.block, max(last, 1))

    def encode(self, leaf: torch.Tensor, seed: int) -> Payload:
        block = self._block_for(leaf.shape[-1])
        xb = _pad_blocks(leaf.to(torch.float32), block)
        lead = xb.shape[:-1]
        x2d = xb.reshape(-1, block)
        vdtype = getattr(torch, self.value_dtype)
        select = sparse_select_pack_2d if self._kernel_ok(block) \
            and leaf.device.type != "meta" else sparse_select_pack_2d_ref
        vals, idx = select(x2d, seed, p=self.p, mode=self.mode, value_dtype=vdtype)
        return {"values": vals.reshape(*lead, vals.shape[-1]),
                "idx": idx.reshape(*lead, idx.shape[-1])}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        vals, idx = payload["values"], payload["idx"]
        block = self._block_for(like.shape[-1])
        dense = sparse_unpack_scatter_2d_ref(vals.reshape(-1, vals.shape[-1]),
                                             idx.reshape(-1, idx.shape[-1]), cols=block)
        return _unfold(dense, vals.shape[:-1], like.shape[-1], like.dtype)

    def decode_axpy_(self, payload: Payload, acc: torch.Tensor, weight,
                     acc_weight=1.0) -> torch.Tensor:
        """One K6c launch per leaf: unpack the indices -> scatter ->
        ``acc_weight*acc + weight*value``, written back into ``acc``."""
        block = self._block_for(acc.shape[-1])
        if not self._kernel_ok(block):
            return super().decode_axpy_(payload, acc, weight, acc_weight)
        vals, idx = payload["values"], payload["idx"]
        return _axpy_folded_(acc, vals.shape[-2], block, lambda f2d: sparse_scatter_axpy_2d(
            vals.reshape(-1, vals.shape[-1]), idx.reshape(-1, idx.shape[-1]), f2d,
            weight=weight, acc_weight=acc_weight, out=f2d))


@dataclasses.dataclass(frozen=True)
class SignWire(WireFormat):
    """1-bit sign + one magnitude scale per ``block``-element block of a
    leaf's last dim (``mean``: mean|x|, a delta-contraction; ``l2``:
    sqrt(mean x^2)); ``1 + 32/block`` wire bits an element.  Biased, so DCD
    and ECD are outside their guarantees while CHOCO and DeepSqueeze
    converge.  Deterministic: the seed is unused."""

    block: int = 1024
    scale: str = "mean"

    name: ClassVar[str] = "sign"

    def __post_init__(self):
        if self.scale not in SIGN_SCALE_MODES:
            raise ValueError(f"sign scale modes are {SIGN_SCALE_MODES}, got {self.scale!r}")
        if self.block % 32:
            raise ValueError(f"sign block must pack whole uint32 words (block % 32 == 0), "
                             f"got {self.block}")

    @property
    def packed(self) -> bool:
        return True

    @property
    def wire_format(self) -> str:
        return f"sign-{self.scale}-packed-u32"

    def _block_for(self, last: int) -> int:
        return aligned_block(self.block, last, bits=1)

    def encode(self, leaf: torch.Tensor, seed: int) -> Payload:
        block = self._block_for(leaf.shape[-1])
        xb = _pad_blocks(leaf.to(torch.float32), block)
        lead = xb.shape[:-1]
        x2d = xb.reshape(-1, block)
        pack = sign_pack_2d if self._kernel_ok(block) and leaf.device.type != "meta" \
            else sign_pack_2d_ref
        words, scale = pack(x2d, scale_mode=self.scale)
        return {"codes": words.reshape(*lead, words.shape[-1]),
                "scale": scale.reshape(*lead, 1)}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        codes = payload["codes"]
        vals = unpack_sign_2d_ref(codes.reshape(-1, codes.shape[-1]),
                                  payload["scale"].reshape(-1, 1))
        return _unfold(vals, codes.shape[:-1], like.shape[-1], like.dtype)

    def decode_axpy_(self, payload: Payload, acc: torch.Tensor, weight,
                     acc_weight=1.0) -> torch.Tensor:
        """One K5b launch per leaf: unpack the sign bits ->
        ``acc_weight*acc + (2u - 1)*(scale*weight)``, written back into ``acc``."""
        codes = payload["codes"]
        block = codes.shape[-1] * 32
        if not self._kernel_ok(block):
            return super().decode_axpy_(payload, acc, weight, acc_weight)
        return _axpy_folded_(acc, codes.shape[-2], block, lambda f2d: unpack_sign_axpy_2d(
            codes.reshape(-1, codes.shape[-1]), payload["scale"].reshape(-1, 1), f2d,
            weight=weight, acc_weight=acc_weight, out=f2d))


@dataclasses.dataclass(frozen=True)
class Fp16Wire(WireFormat):
    """Half-precision cast: 16 wire bits an element; the seed is unused."""

    name: ClassVar[str] = "fp16"

    def encode(self, leaf: torch.Tensor, seed: int) -> Payload:
        return {"values": leaf.to(torch.float16)}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        return payload["values"].to(like.dtype)


@dataclasses.dataclass(frozen=True)
class IdentityWire(WireFormat):
    """No-op: the full-precision leaf is the payload (exact D-PSGD).  The
    payload is the leaf itself, not a copy."""

    name: ClassVar[str] = "identity"

    def encode(self, leaf: torch.Tensor, seed: int) -> Payload:
        return {"values": leaf}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        return payload["values"].to(like.dtype)


def wire_spec(w: WireFormat) -> str:
    """Canonical spec string (inverse of :func:`make_wire_format`)."""
    if isinstance(w, QuantWire):
        s = f"quant:{w.bits}:{w.block}"
        return s if w.pack is None else s + f":pack={str(w.pack).lower()}"
    if isinstance(w, SparseWire):
        s = f"sparse:{w.p:g}:{w.mode}:{w.block}"
        return s if w.value_dtype == "float32" else s + f":value_dtype={w.value_dtype}"
    if isinstance(w, SignWire):
        return f"sign:{w.scale}:{w.block}"
    if isinstance(w, Fp16Wire):
        return "fp16"
    if isinstance(w, IdentityWire):
        return "identity"
    raise TypeError(f"no canonical spec for wire format {w!r}")


# name -> (constructor, positional spec-arg names in order)
WIRE_FORMATS: Dict[str, Tuple[Callable[..., WireFormat], Tuple[str, ...]]] = {
    "quant": (QuantWire, ("bits", "block")),
    "sparse": (SparseWire, ("p", "mode", "block")),
    "sign": (SignWire, ("scale", "block")),
    "fp16": (Fp16Wire, ()),
    "identity": (IdentityWire, ()),
}


def _coerce(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    return text


def make_wire_format(spec, **overrides) -> WireFormat:
    """spec -> :class:`WireFormat`: a registered instance (returned, or
    ``dataclasses.replace``d with ``overrides``) or ``name[:arg[:arg...]]``
    with positional or ``key=value`` args (``quant:4``, ``quant:bits=3,block=128``,
    ``sparse:0.05:topk``, ``sign:l2:256``, ``fp16``, ``identity``).  ``lowrank``
    and ``adaptive`` are not ported."""
    if isinstance(spec, WireFormat):
        return dataclasses.replace(spec, **overrides) if overrides else spec
    if not isinstance(spec, str):
        raise TypeError(f"wire spec must be a WireFormat or str, got {type(spec)}")
    name, *args = spec.split(":")
    if name not in WIRE_FORMATS:
        raise ValueError(f"unknown or unported wire format {name!r}; "
                         f"ported: {sorted(WIRE_FORMATS)}")
    ctor, positional = WIRE_FORMATS[name]
    kwargs: Dict[str, Any] = {}
    pos = 0
    for arg in args:
        for piece in arg.split(","):
            if not piece:
                continue
            if "=" in piece:
                key, val = piece.split("=", 1)
                kwargs[key] = _coerce(val)
            else:
                if pos >= len(positional):
                    raise ValueError(f"too many positional args in wire spec {spec!r} "
                                     f"(format {name!r} takes {positional})")
                kwargs[positional[pos]] = _coerce(piece)
                pos += 1
    kwargs.update(overrides)
    return ctor(**kwargs)
