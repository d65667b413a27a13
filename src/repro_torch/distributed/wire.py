"""The gossip wire-format protocol: quant, sign, sparse, fp16, identity,
lowrank and the adaptive per-leaf combinator.

The port of the JAX package's ``distributed/wire.py``: the same per-leaf
protocol (``encode`` / ``decode`` / ``decode_axpy``), the same (step, salt,
leaf) seeding and the same blocked payload containers, so a payload encoded
here is bit-equal to the JAX package's for the same leaf and counter (the
sign codec's per-block scale and the low-rank factors excepted: they are
sums, taken here in the kernels' fixed orders, and agree with the JAX
package to rounding).

* ``encode(leaf, seed)`` blocks the LAST dim: the leaf (lead..., d) is padded
  to whole blocks and folded row-major to (rows, block).  With
  ``block % 128 == 0``, the JAX package's gate, the fold goes through the
  format's send kernel (whose wrapper raises on a CUDA row wider than the
  kernel takes, ``MAX_COLS``) —
  K1 :func:`~repro_torch.kernels.quant.quantize_pack_2d` (``quant`` at bits
  2..7), K3 :func:`~repro_torch.kernels.quant.quantize_2d` (``quant`` in the
  int8 container, 8 bits), K5a :func:`~repro_torch.kernels.quant.sign_pack_2d`
  (``sign``), K6 :func:`~repro_torch.kernels.quant.sparse_select_pack_2d`
  (``sparse``) — whose counter ``row*block + lane`` is the flat index of the
  blocked view (:func:`_block_counters`).  ``encode(leaf, seed, offset)``
  adds ``offset`` to that counter: a rank that holds node ``i``'s slice of
  a stacked leaf, shape ``(1, ...)``, encodes with
  :meth:`WireFormat.node_offset` and hashes the stacked fold's counters, so
  its words are rows ``i`` of the stacked encode.  Other blocks (the quickstart's
  block 32) and the shapes-only ``meta`` accounting run the plain versions:
  that gate is the JAX wire's own, not a fallback.  (The JAX runtime
  encodes in jnp; the port puts a kernel on the send side too, held to the
  same words.)
* ``decode(payload, like)`` is the dense decode, through K4a
  :func:`~repro_torch.kernels.quant.dequantize_2d` (int8 codes, any block),
  K4b :func:`~repro_torch.kernels.quant.unpack_dequant_2d` (packed words,
  any whole number of stream groups) or, for ``sparse`` behind the 128-lane
  gate, K6b :func:`~repro_torch.kernels.quant.sparse_unpack_scatter_2d`.
* ``decode_axpy_(payload, acc, weight, acc_weight)`` adds the decoded payload
  into ``acc`` IN PLACE through the format's receive kernel (K2, K5b, K6c)
  behind the same gate (the JAX package's ``block % 128``); off the gate it
  runs the decode, then the axpy (the JAX base path: an int8 ``quant``
  payload's receive is K4a and the axpy in torch).  The JAX package is pure
  and returns new arrays; the port updates params, replicas and estimates
  in place, because at full width every leaf-sized temporary costs
  gigabytes.

* ``lowrank`` is not blocked: a stacked matrix leaf (lead..., m, n) ships
  rank-r factors of one power-iteration step (:class:`LowRankWire`), its
  projection through K7a :func:`~repro_torch.kernels.lowrank.lowrank_project_2d`
  and its receive through K7b
  :func:`~repro_torch.kernels.lowrank.lowrank_axpy_2d` behind
  ``n % 128 == 0``; ``lowrank:<r>:warm`` carries the right factor across
  rounds as codec state (:attr:`WireFormat.stateful`).
* ``adaptive`` routes each leaf to a sub-format by path and size
  (:class:`AdaptiveWire`); the rounds ask :meth:`WireFormat.route` for a
  leaf's format, which is the wire itself for every other format.

Payloads: ``quant`` ``{"codes": (lead..., nblk, W) int32 words | (lead...,
nblk, block) int8, "scale": (lead..., nblk, 1) f32}``; ``sign`` ``{"codes":
(lead..., nblk, block/32) int32 words, "scale": (lead..., nblk, 1) f32}``;
``sparse`` ``{"values": (lead..., nblk, k) f32 | f16, "idx": (lead..., nblk,
words) int32}``; ``lowrank`` ``{"p": (lead..., m, r) f32, "v": (lead..., n,
r) f32}`` or, for ``ndim <= 2``, ``{"values": leaf f16}``; ``fp16`` and
``identity`` ``{"values": leaf}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import math
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.lowrank import ACC_DTYPES, lowrank_axpy_2d, lowrank_project_2d
from repro_torch.kernels.quant import (
    dequantize_2d,
    quantize_2d,
    quantize_pack_2d,
    sign_pack_2d,
    sparse_scatter_axpy_2d,
    sparse_select_pack_2d,
    sparse_unpack_scatter_2d,
    unpack_dequant_2d,
    unpack_dequant_axpy_2d,
    unpack_sign_axpy_2d,
)
from repro_torch.kernels.ref import (
    MASK32,
    SIGN_SCALE_MODES,
    SPARSE_MODES,
    aligned_block,
    assert_packable,
    _factor_matmul,
    levels_for,
    lowrank_orthonormalize_ref,
    packed_auto,
    quantize_2d_ref,
    quantize_pack_2d_ref,
    sign_pack_2d_ref,
    sparse_select_pack_2d_ref,
    sparse_unpack_scatter_2d_ref,
    uniform_from_hash,
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


def _node_elems(shape: Tuple[int, ...], block: int) -> int:
    """Elements one node holds in the padded, blocked view of a stacked leaf
    of ``shape``: ``prod(xb.shape[1:])`` of :func:`_pad_blocks`'s ``xb``."""
    if len(shape) < 2:
        raise ValueError(f"a stacked leaf has a node axis and a last dim, got shape {shape}")
    return math.prod(shape[1:-1]) * (-(-int(shape[-1]) // block) * block)


def _pad_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """(lead..., d) -> (lead..., nblk, block), zero-padding the last dim."""
    last = x.shape[-1]
    pad = (-last) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], (last + pad) // block, block)


def _axpy_folded_(acc: torch.Tensor, nblk: int, block: int,
                  launch: Callable[[torch.Tensor], Any]) -> torch.Tensor:
    """Run ``launch(f2d)``, a receive kernel that updates the (rows, block)
    fold ``f2d`` of ``acc`` in place, and return ``acc``.  A leaf whose last
    dim is not whole blocks is padded into a temporary fold and copied back
    (as the JAX package pads its accumulator).  ``acc`` is float32 or
    bfloat16 (bf16 replicas: the kernels' bf16-accumulator variants)."""
    if acc.dtype not in ACC_DTYPES:
        raise TypeError(f"the fused receive accumulates into {ACC_DTYPES}, got {acc.dtype}")
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

    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
        """The payload of ``leaf``; a format that hashes an element counter
        starts it at ``offset`` (see :meth:`node_offset`), the others ignore
        it."""
        raise NotImplementedError

    def node_offset(self, shape, node: int) -> int:
        """The counter offset of node ``node``'s rows in the blocked fold of a
        stacked leaf of ``shape`` (``node * prod(xb.shape[1:])`` mod 2^32):
        what a rank holding that node's ``(1, ...)`` slice passes to
        :meth:`encode`.  0 for a format that hashes no counter."""
        return 0

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode_axpy_(self, payload: Payload, acc: torch.Tensor, weight,
                     acc_weight=1.0) -> torch.Tensor:
        """``acc <- acc_weight*acc + weight*decode(payload)`` in place; the
        default decodes at f32 then accumulates in f32, rounding once into
        ``acc``'s dtype (the JAX base path's ``.astype(acc.dtype)``)."""
        d = self.decode(payload, torch.empty(acc.shape, dtype=torch.float32, device="meta"))
        acc.copy_(acc_weight * acc.to(torch.float32) + weight * d)
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

    def route(self, path: str, shape) -> "WireFormat":
        """The format that carries the leaf at ``path`` (``/``-joined, as
        :func:`~repro_torch.tree.leaf_items` names it) of stacked ``shape``:
        the wire itself, but for :class:`AdaptiveWire`."""
        return self

    # --- optional cross-step codec state (per-leaf aux channel) -----------
    @property
    def stateful(self) -> bool:
        """True when the codec carries per-leaf state across rounds (the
        warm factors of ``lowrank:<r>:warm``).  ``init_dist_state(...,
        wire=)`` then keeps :meth:`init_aux`'s dict under :attr:`aux_name`
        in the state's aux, and the rounds encode through
        :meth:`encode_leaf_stateful`."""
        return False

    @property
    def aux_name(self) -> str:
        """The aux key the codec state rides under."""
        return f"wire_{self.name}"

    def init_aux(self, tree: Any) -> Dict[str, torch.Tensor]:
        """Initial codec state for ``tree`` (stacked leaves); none for a
        stateless format."""
        return {}

    def encode_leaf_stateful(self, leaf: torch.Tensor, seed: int, leaf_index: int,
                             state: Dict[str, torch.Tensor], offset: int = 0):
        """Encode the leaf of flatten index ``leaf_index`` with the codec
        state ``state`` (the dict under :attr:`aux_name`), which it updates IN
        PLACE for that leaf; returns ``(payload, state)``.  Stateless formats
        encode as :meth:`encode` and leave ``state`` as it is."""
        return self.encode(leaf, seed, offset), state

    # --- tree-level plumbing (one step/salt/leaf seeding path) ------------
    def encode_tree(self, tree: Any, step: int, salt: int):
        """tree of (n, ...) leaves -> (paths, [payload per leaf]), seeded by
        the leaf's index in JAX flatten order, each leaf through its
        :meth:`route`."""
        items = leaf_items(tree)
        return ([p for p, _ in items],
                [self.route(p, leaf.shape).encode(leaf, leaf_seed(step, salt, li))
                 for li, (p, leaf) in enumerate(items)])

    def encode_tree_stateful(self, tree: Any, step: int, salt: int,
                             aux: Dict[str, torch.Tensor]):
        """Like :meth:`encode_tree`, threading the codec state: returns
        ``(paths, payloads, new_aux)``; ``aux`` itself is left as it is.  A
        stateless format passes ``aux`` through."""
        if not self.stateful:
            return (*self.encode_tree(tree, step, salt), aux)
        items = leaf_items(tree)
        state, payloads = dict(aux), []
        for li, (_, leaf) in enumerate(items):
            payload, state = self.encode_leaf_stateful(leaf, leaf_seed(step, salt, li), li,
                                                       state)
            payloads.append(payload)
        return [p for p, _ in items], payloads, state

    def decode_tree(self, paths, payloads, like_tree: Any) -> Any:
        likes = [leaf for _, leaf in leaf_items(like_tree)]
        return tree_from_items([(p, self.route(p, like.shape).decode(pl, like))
                                for p, pl, like in zip(paths, payloads, likes)])

    def decode_axpy_tree(self, paths, payloads, acc_tree: Any, weight,
                         acc_weight=1.0) -> Any:
        accs = [leaf for _, leaf in leaf_items(acc_tree)]
        return tree_from_items([(p, self.route(p, acc.shape).decode_axpy(
            pl, acc, weight, acc_weight)) for p, pl, acc in zip(paths, payloads, accs)])

    # --- wire accounting from the real containers -------------------------
    def wire_nbytes(self, tree: Any) -> int:
        """Wire bytes of one encoded payload of ``tree``, from the containers
        the encoder builds on ``meta`` tensors (shapes only, nothing computed)."""
        return sum(payload_nbytes(self.route(p, leaf.shape).encode(
            torch.empty(leaf.shape, dtype=torch.float32, device="meta"), 0))
            for p, leaf in leaf_items(tree))

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

    def node_offset(self, shape, node: int) -> int:
        return (node * _node_elems(shape, self._block_for(shape[-1]))) & MASK32

    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
        block = self._block_for(leaf.shape[-1])
        xb = _pad_blocks(leaf.to(torch.float32), block)
        lead = xb.shape[:-1]
        x2d = xb.reshape(-1, block)
        on_gate = self._kernel_ok(block) and leaf.device.type != "meta"
        if self.packed:     # K1, or off the kernel gate (or shapes only) its plain version
            quant = quantize_pack_2d if on_gate else quantize_pack_2d_ref
        else:               # K3 likewise
            quant = quantize_2d if on_gate else quantize_2d_ref
        codes, scale = quant(x2d, seed, bits=self.bits, offset=offset)
        return {"codes": codes.reshape(*lead, codes.shape[-1]),
                "scale": scale.reshape(*lead, 1)}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        """One K4b (packed) or K4a (int8) launch per leaf, whatever the block."""
        codes = payload["codes"]
        c2d, s2d = codes.reshape(-1, codes.shape[-1]), payload["scale"].reshape(-1, 1)
        vals = unpack_dequant_2d(c2d, s2d, bits=self.bits) if self.packed \
            else dequantize_2d(c2d, s2d, bits=self.bits)
        return _unfold(vals, codes.shape[:-1], like.shape[-1], like.dtype)

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

    def node_offset(self, shape, node: int) -> int:
        return (node * _node_elems(shape, self._block_for(shape[-1]))) & MASK32

    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
        block = self._block_for(leaf.shape[-1])
        xb = _pad_blocks(leaf.to(torch.float32), block)
        lead = xb.shape[:-1]
        x2d = xb.reshape(-1, block)
        vdtype = getattr(torch, self.value_dtype)
        select = sparse_select_pack_2d if self._kernel_ok(block) \
            and leaf.device.type != "meta" else sparse_select_pack_2d_ref
        vals, idx = select(x2d, seed, p=self.p, mode=self.mode, value_dtype=vdtype,
                           offset=offset)
        return {"values": vals.reshape(*lead, vals.shape[-1]),
                "idx": idx.reshape(*lead, idx.shape[-1])}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        """One K6b launch per leaf behind the 128-lane gate."""
        vals, idx = payload["values"], payload["idx"]
        block = self._block_for(like.shape[-1])
        scatter = sparse_unpack_scatter_2d if self._kernel_ok(block) \
            else sparse_unpack_scatter_2d_ref
        dense = scatter(vals.reshape(-1, vals.shape[-1]), idx.reshape(-1, idx.shape[-1]),
                        cols=block)
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

    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
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

    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
        return {"values": leaf.to(torch.float16)}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        return payload["values"].to(like.dtype)


@dataclasses.dataclass(frozen=True)
class IdentityWire(WireFormat):
    """No-op: the full-precision leaf is the payload (exact D-PSGD).  The
    payload is the leaf itself, not a copy."""

    name: ClassVar[str] = "identity"

    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
        return {"values": leaf}

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        return payload["values"].to(like.dtype)


# ------------------------------------------------------------ low-rank codec

@contextlib.contextmanager
def _full_f32_matmul():
    """``torch.matmul`` in full f32 inside, whatever the global TF32 setting
    (``torch.backends.cuda.matmul.allow_tf32``) is outside: the factors'
    re-projection keeps f32 like the JAX package's ``dot_general``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _batch_dot(a: torch.Tensor, b: torch.Tensor, a_dim: int, b_dim: int) -> torch.Tensor:
    """Contract ``a``'s axis ``a_dim`` with ``b``'s ``b_dim`` (each -1 or -2)
    in full f32, batching over the shared leading dims: ``(..., free_a,
    free_b)``, as the JAX package's ``_batch_dot`` (``wire.py:692``)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a = a.mT if a_dim == -2 else a
    b = b.mT if b_dim == -1 else b
    with _full_f32_matmul():
        return torch.matmul(a, b)


@dataclasses.dataclass(frozen=True)
class LowRankWire(WireFormat):
    """Rank-r power-iteration wire format (PowerGossip).  A matrix leaf, a
    stacked ``(lead..., m, n)`` leaf with ``ndim >= 3``, ships one
    power-iteration step of its trailing (m, n) view as rank-``r`` factors::

        P  = M @ V0          (K7a, the sum over n in its fixed order)
        P  = MGS(P)          (columns orthonormalized, safe-norm'd)
        Vt = M^T @ P         (re-projection, torch.matmul in full f32)
        payload = {p: (..., m, r) f32, v: (..., n, r) f32}
        decode  = P @ Vt^T   (K7b fuses it into the receive axpy)

    ``32*r*(m+n)`` wire bits against the dense ``32*m*n``.  Leaves with
    ``ndim <= 2`` ride the fp16 container.  ``warm=False`` seeds ``V0`` from
    the (step, salt, leaf) counter every round, one (n, r) start shared by
    every node and layer; ``warm=True`` carries each matrix leaf's last
    ``Vt`` as codec state under ``wire_lowrank:<r>`` (:meth:`init_aux`,
    :meth:`encode_leaf_stateful`), one more subspace iteration a round.
    The port of the JAX package's ``LowRankWire`` (``wire.py:707``)."""

    rank: int = 2
    warm: bool = False

    name: ClassVar[str] = "lowrank"

    def __post_init__(self):
        if not 1 <= int(self.rank) <= 128:
            raise ValueError(f"lowrank rank must be in 1..128, got {self.rank}")
        object.__setattr__(self, "rank", int(self.rank))
        object.__setattr__(self, "warm", bool(self.warm))

    @property
    def packed(self) -> bool:
        """The factors have a fused receive kernel (K7b, behind the same
        128-lane gate); the containers are plain f32."""
        return True

    @property
    def wire_format(self) -> str:
        return f"lowrank-r{self.rank}-{'warm' if self.warm else 'cold'}-f32"

    @property
    def stateful(self) -> bool:
        return self.warm

    @property
    def aux_name(self) -> str:
        return f"wire_lowrank:{self.rank}"

    @staticmethod
    def _eligible(shape) -> bool:
        """Matrix routing by STACKED shape: ``(lead..., m, n)`` needs
        ``ndim >= 3``, so a stacked 1-D param ``(nodes, d)`` is not a matrix
        (a stacked ``(nodes, 1, d)`` norm is, with m = 1)."""
        return len(shape) >= 3

    def _factor_init(self, n: int, seed: int, device) -> torch.Tensor:
        """Seeded ``(n, r)`` start factor ``uniform_from_hash(i*r + c) - 0.5``,
        bit-equal to the JAX package's; never zero."""
        rows = torch.arange(n, dtype=torch.int64, device=device)
        cols = torch.arange(self.rank, dtype=torch.int64, device=device)
        idx = (rows[:, None] * self.rank + cols[None, :]) & MASK32
        return uniform_from_hash(idx, int(seed) & MASK32) - 0.5

    def _encode_leaf(self, leaf: torch.Tensor, v0: torch.Tensor):
        """One power-iteration step of ``leaf``'s trailing (m, n) view against
        ``v0`` ((n, r) shared start, or (lead..., n, r) warm factors).
        Returns (payload, new right factor)."""
        m = leaf.to(torch.float32)
        lead, (rows, n) = m.shape[:-2], m.shape[-2:]
        batch = math.prod(lead)
        vb = v0.expand(batch, n, self.rank) if v0.dim() == 2 \
            else v0.reshape(batch, n, self.rank)
        p = lowrank_project_2d(m.reshape(batch, rows, n).contiguous(), vb)
        p = lowrank_orthonormalize_ref(p.reshape(*lead, rows, self.rank))
        vt = _batch_dot(m, p, -2, -2)
        return {"p": p, "v": vt}, vt

    # --- per-leaf protocol -------------------------------------------------
    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
        """Cold-start encode (also the shapes-only accounting of the warm
        format: the factor shapes do not depend on warmth)."""
        if not self._eligible(leaf.shape):
            return {"values": leaf.to(torch.float16)}
        payload, _ = self._encode_leaf(leaf, self._factor_init(leaf.shape[-1], seed,
                                                                leaf.device))
        return payload

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        if "values" in payload:
            return payload["values"].to(like.dtype)
        return _factor_matmul(payload["p"], payload["v"]).to(like.dtype)

    def decode_axpy_(self, payload: Payload, acc: torch.Tensor, weight,
                     acc_weight=1.0) -> torch.Tensor:
        """One K7b launch per matrix leaf over its whole lead batch:
        ``acc_weight*acc + weight*(P @ V^T)`` written back into ``acc``; the
        dense reconstruction never exists.  The fp16 leaves and a last dim
        off the 128-lane gate take the plain decode-then-axpy."""
        if "values" in payload or not self._kernel_ok(acc.shape[-1]):
            return super().decode_axpy_(payload, acc, weight, acc_weight)
        lead, (rows, n) = acc.shape[:-2], acc.shape[-2:]
        batch = math.prod(lead)
        target = acc if acc.is_contiguous() else acc.contiguous()
        a3 = target.view(batch, rows, n)
        lowrank_axpy_2d(payload["p"].reshape(batch, rows, self.rank).contiguous(),
                        payload["v"].reshape(batch, n, self.rank), a3,
                        weight=weight, acc_weight=acc_weight, out=a3)
        if target is not acc:
            acc.copy_(target)
        return acc

    # --- cross-step codec state (the warm factors) --------------------------
    def init_aux(self, tree: Any) -> Dict[str, torch.Tensor]:
        """Warm factors for every matrix leaf of the stacked ``tree``, keyed by
        flatten index: the cold factor at the fixed seed ``0x9E3779B9 ^
        (li*101)``, one copy per lead slab.  Empty when cold."""
        if not self.warm:
            return {}
        aux: Dict[str, torch.Tensor] = {}
        for li, (_, leaf) in enumerate(leaf_items(tree)):
            if self._eligible(leaf.shape):
                f = self._factor_init(leaf.shape[-1], 0x9E3779B9 ^ (li * 101), leaf.device)
                aux[str(li)] = f.expand(*leaf.shape[:-2], *f.shape).contiguous()
        return aux

    def encode_leaf_stateful(self, leaf: torch.Tensor, seed: int, leaf_index: int,
                             state: Dict[str, torch.Tensor], offset: int = 0):
        """Warm: project the matrix leaf against ITS carried factor and put
        the re-projected factor in its place in ``state``.  Cold formats and
        fp16 leaves encode as :meth:`encode`."""
        if not (self.warm and self._eligible(leaf.shape)):
            return self.encode(leaf, seed), state
        payload, vt = self._encode_leaf(leaf, state[str(leaf_index)])
        state[str(leaf_index)] = vt
        return payload, state

    # --- accounting --------------------------------------------------------
    def wire_bits_per_element(self, shape=None) -> float:
        """From the factor containers on ``meta``: a 2-D ``(m, n)`` shape is
        the un-stacked matrix, measured as ``(1, m, n)``; no shape gives a
        1024 x 1024 matrix; 1-D shapes the fp16 figure."""
        shape = (1, 1024, 1024) if shape is None else tuple(int(d) for d in shape)
        if len(shape) == 2:
            shape = (1,) + shape
        leaf = torch.empty(shape if shape else (1,), dtype=torch.float32, device="meta")
        return 8.0 * payload_nbytes(self.encode(leaf, 0)) / float(math.prod(shape))

    @staticmethod
    def parse_spec_args(args) -> Dict[str, Any]:
        """``lowrank:<rank>[:warm]``: the bare literal ``warm`` sets the flag,
        ``key=value`` args pass through, the one positional is the rank."""
        kwargs: Dict[str, Any] = {}
        pos = 0
        for part in args:
            for piece in part.split(","):
                if not piece:
                    continue
                if piece == "warm":
                    kwargs["warm"] = True
                elif "=" in piece:
                    key, val = piece.split("=", 1)
                    kwargs[key] = _coerce(val)
                else:
                    if pos >= 1:
                        raise ValueError(f"lowrank spec takes one positional arg (rank); "
                                         f"unexpected {piece!r}")
                    kwargs["rank"] = int(piece)
                    pos += 1
        return kwargs


# --------------------------------------------------------- adaptive combinator

def leaf_path_str(path) -> str:
    """``blocks/attn/wk``-style leaf path: the keys joined by ``/``, the
    naming of the JAX package's ``leaf_path_str`` and of
    :func:`~repro_torch.tree.leaf_items` (a string is already one)."""
    return path if isinstance(path, str) else "/".join(str(k) for k in path)


def routed_size(shape) -> int:
    """Per-replica element count of a stacked leaf, what ``adaptive``
    thresholds compare against: the leading node axis is excluded; a 1-D
    leaf is taken whole."""
    shape = tuple(int(d) for d in shape)
    if len(shape) > 1:
        return math.prod(shape[1:])
    return math.prod(shape)


@dataclasses.dataclass(frozen=True)
class AdaptiveWire(WireFormat):
    """Per-leaf combinator: one wire format per leaf.  Routing, first
    ``leaf.<pattern>=`` override whose fnmatch pattern matches the leaf's
    ``/``-joined path, else by per-replica size (:func:`routed_size`): below
    ``threshold`` through ``small``, the rest through ``large``::

        adaptive:<threshold>[:small=<spec>][:large=<spec>][:leaf.<pat>=<spec>]*
        adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4

    Seeds, payloads and accounting are each leaf's sub-format's.  Nesting
    is refused.  The per-leaf methods see no path and route by size alone;
    the tree methods and the rounds (:meth:`route`) apply the overrides.
    Not stateful, as in the JAX package: a warm ``lowrank`` sub-format
    encodes cold here every round.  The port of ``wire.py:981``."""

    threshold: int = 4096
    small: Any = "fp16"            # WireFormat | spec str (normalized in init)
    large: Any = "quant:4"
    overrides: Tuple[Tuple[str, Any], ...] = ()   # ((fnmatch pattern, wire)..)

    name: ClassVar[str] = "adaptive"

    def __post_init__(self):
        if int(self.threshold) < 0:
            raise ValueError(f"adaptive threshold must be >= 0, got {self.threshold}")
        object.__setattr__(self, "threshold", int(self.threshold))
        for fld in ("small", "large"):
            object.__setattr__(self, fld, self._sub(getattr(self, fld)))
        ov = self.overrides
        if isinstance(ov, dict):
            ov = tuple(ov.items())
        object.__setattr__(self, "overrides",
                           tuple((str(pat), self._sub(w)) for pat, w in ov))

    @staticmethod
    def _sub(spec) -> WireFormat:
        w = make_wire_format(spec)
        if isinstance(w, AdaptiveWire):
            raise ValueError("adaptive wire formats do not nest")
        return w

    # --- routing ----------------------------------------------------------
    def route_size(self, shape) -> WireFormat:
        return self.small if routed_size(shape) < self.threshold else self.large

    def route(self, path: str, shape) -> WireFormat:
        for pat, w in self.overrides:
            if fnmatch.fnmatchcase(path, pat):
                return w
        return self.route_size(shape)

    def leaf_wires(self, tree: Any) -> Tuple[Tuple[str, WireFormat], ...]:
        """``(path, routed sub-format)`` per leaf in flatten order."""
        return tuple((p, self.route(p, leaf.shape)) for p, leaf in leaf_items(tree))

    # --- per-leaf protocol (size-routed: no path at this level) -----------
    def encode(self, leaf: torch.Tensor, seed: int, offset: int = 0) -> Payload:
        return self.route_size(leaf.shape).encode(leaf, seed, offset)

    def node_offset(self, shape, node: int) -> int:
        return self.route_size(shape).node_offset(shape, node)

    def decode(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        return self.route_size(like.shape).decode(payload, like)

    def decode_axpy_(self, payload: Payload, acc: torch.Tensor, weight,
                     acc_weight=1.0) -> torch.Tensor:
        return self.route_size(acc.shape).decode_axpy_(payload, acc, weight, acc_weight)

    # --- accounting / display --------------------------------------------
    def wire_bits_per_element(self, shape=None) -> float:
        """With a shape: that leaf through its size-routed sub-format; with
        none: the ``large`` route's figure."""
        if shape is None:
            return self.large.wire_bits_per_element()
        return self.route_size(shape).wire_bits_per_element(shape)

    @property
    def packed(self) -> bool:
        return self.small.packed or self.large.packed or \
            any(w.packed for _, w in self.overrides)

    @property
    def wire_format(self) -> str:
        ov = "".join(f";{pat}={w.wire_format}" for pat, w in self.overrides)
        return (f"adaptive<{self.threshold};small={self.small.wire_format};"
                f"large={self.large.wire_format}{ov}>")

    @staticmethod
    def parse_spec_args(args) -> Dict[str, Any]:
        """Sub-specs contain ``:`` and ``,``, so every part that does not
        start a reserved key (``threshold=``/``small=``/``large=``/
        ``leaf.<pat>=``) is absorbed into the preceding key's sub-spec:
        ``adaptive:4096:large=quant:4`` keeps the ``4`` with ``quant``."""
        kwargs: Dict[str, Any] = {}
        overrides: list = []
        current: Optional[str] = None    # key whose sub-spec absorbs parts
        pos = 0
        for part in args:
            key = part.split("=", 1)[0] if "=" in part else None
            if key in ("threshold", "small", "large") or \
                    (key is not None and key.startswith("leaf.")):
                val = part.split("=", 1)[1]
                if key.startswith("leaf."):
                    overrides.append([key[len("leaf."):], val])
                    current = "__override__"
                elif key == "threshold":
                    kwargs["threshold"] = int(val)
                    current = None
                else:
                    kwargs[key] = val
                    current = key
            elif current == "__override__":
                overrides[-1][1] += ":" + part
            elif current is not None:
                kwargs[current] += ":" + part
            else:
                if pos >= 1:
                    raise ValueError(f"adaptive spec takes one positional arg (threshold); "
                                     f"unexpected {part!r}")
                kwargs["threshold"] = int(part)
                pos += 1
        if overrides:
            kwargs["overrides"] = tuple((p, sp) for p, sp in overrides)
        return kwargs


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
    if isinstance(w, LowRankWire):
        return f"lowrank:{w.rank}" + (":warm" if w.warm else "")
    if isinstance(w, AdaptiveWire):
        parts = [f"adaptive:{w.threshold}", f"small={wire_spec(w.small)}",
                 f"large={wire_spec(w.large)}"]
        parts += [f"leaf.{pat}={wire_spec(sub)}" for pat, sub in w.overrides]
        return ":".join(parts)
    raise TypeError(f"no canonical spec for wire format {w!r}")


# name -> (constructor, positional spec-arg names in order)
WIRE_FORMATS: Dict[str, Tuple[Callable[..., WireFormat], Tuple[str, ...]]] = {}


def register_wire_format(name: str, ctor: Callable[..., WireFormat],
                         positional: Tuple[str, ...] = ()) -> None:
    """Register a wire format under ``name`` for :func:`make_wire_format`;
    ``positional`` names the constructor kwargs that bare spec args map to,
    in order (``("bits", "block")`` makes ``"quant:4:128"`` work)."""
    WIRE_FORMATS[name] = (ctor, positional)


register_wire_format("quant", QuantWire, positional=("bits", "block"))
register_wire_format("sparse", SparseWire, positional=("p", "mode", "block"))
register_wire_format("sign", SignWire, positional=("scale", "block"))
register_wire_format("fp16", Fp16Wire)
register_wire_format("identity", IdentityWire)
register_wire_format("lowrank", LowRankWire, positional=("rank",))
register_wire_format("adaptive", AdaptiveWire, positional=("threshold",))


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
    ``sparse:0.05:topk``, ``sign:l2:256``, ``fp16``, ``identity``,
    ``lowrank:2``, ``lowrank:2:warm``,
    ``adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4``).  A
    format whose class has a ``parse_spec_args`` staticmethod (``lowrank``,
    ``adaptive``) parses its own args."""
    if isinstance(spec, WireFormat):
        return dataclasses.replace(spec, **overrides) if overrides else spec
    if not isinstance(spec, str):
        raise TypeError(f"wire spec must be a WireFormat or str, got {type(spec)}")
    name, *args = spec.split(":")
    if name not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {name!r}; registered: {sorted(WIRE_FORMATS)}")
    ctor, positional = WIRE_FORMATS[name]
    parse = getattr(ctor, "parse_spec_args", None)
    if parse is not None:
        kwargs = parse(args)
        kwargs.update(overrides)
        return ctor(**kwargs)
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
