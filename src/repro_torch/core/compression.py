"""Unbiased stochastic compression operators (paper §4, Assumption 1.5 / 2).

The port of the JAX package's ``core/compression.py``.  The paper requires
``E[C(z)] = z`` (unbiased) with either

* a *signal-to-noise* bound ``alpha² = sup ||z - C(z)||² / ||z||²``
  (DCD-PSGD, Theorem 1 needs ``(1-rho)² - 4 mu² alpha² > 0``), or
* a *bounded variance* ``E||C(z) - z||² <= sigma_tilde²/2`` (ECD-PSGD).

Every operator is a stacked-reference view over a
:class:`~repro_torch.distributed.wire.WireFormat` (``Compressor.wire``): the
encode and decode live in the wire module the runtime uses, and this module
adds the paper-facing API (calls with a key, alpha and delta bounds,
Monte-Carlo diagnostics).

Keys.  An operator takes either an integer step counter or a
``torch.Generator``.  An integer step uses the wire module's (step, salt,
leaf) seeding verbatim (``leaf_seed(step, salt, leaf)``), so the payloads
are bit-equal to the JAX package's at the same step.  A generator draws an
independent 32-bit seed for every call (and every leaf of a tree), the
counterpart of the JAX package's PRNG keys.  :meth:`Compressor._seed` turns
either into one integer and hands that to the wire or to ``kernels/ops.py``;
so ``use_kernel=True`` works with both, where the JAX package's
``use_kernel`` route passes its key to ``jax.random.bits`` and takes PRNG
keys only.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.wire import (
    Fp16Wire,
    IdentityWire,
    QuantWire,
    SignWire,
    SparseWire,
    WireFormat,
    leaf_seed,
    make_wire_format,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sparse_geometry
from repro_torch.tree import leaf_items

Payload = Any
Key = Any   # int step counter | torch.Generator


def _rebuild(tree: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`leaf_items` order) in the structure of ``tree``
    (a nested dict, or one tensor)."""
    if not isinstance(tree, dict):
        return leaves[0]
    it = iter(leaves)

    def walk(node):
        return {k: walk(node[k]) for k in sorted(node)} if isinstance(node, dict) else next(it)
    return walk(tree)


def _meta_like(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class Compressor:
    """Base class: compression ``C`` as a view over a :class:`WireFormat`
    (``self.wire``); subclasses provide the wire object and the
    paper-facing bounds."""

    name: str = "base"
    salt: int = 0

    @property
    def wire(self) -> WireFormat:
        """The shared wire-format object this operator is a view over."""
        raise NotImplementedError

    def _seed(self, key: Key, leaf_index: int = 0) -> int:
        """Generator -> 32 fresh random bits; integer step -> the wire
        module's (step, salt, leaf) seed."""
        if isinstance(key, torch.Generator):
            return int(torch.randint(0, 1 << 32, (1,), generator=key, dtype=torch.int64,
                                     device=key.device).item())
        return leaf_seed(int(key), self.salt, leaf_index)

    def compress(self, key: Key, x: torch.Tensor) -> Payload:
        """``x`` (any shape) -> wire payload of the flattened leaf."""
        return self.wire.encode(x.reshape(-1), self._seed(key))

    def decompress(self, payload: Payload, like: torch.Tensor) -> torch.Tensor:
        """``like`` gives the shape and dtype (any device, ``meta`` too)."""
        flat = self.wire.decode(payload, _meta_like((like.numel(),), like.dtype))
        return flat.reshape(like.shape)

    def __call__(self, key: Key, x: torch.Tensor) -> torch.Tensor:
        """``C(x)``, compress-then-decompress (what the receiver reconstructs)."""
        return self.decompress(self.compress(key, x), x)

    def wire_bits_per_element(self, shape=None) -> float:
        """Measured wire bits an element of the actual payload containers."""
        return self.wire.wire_bits_per_element(shape)

    # --- trees -------------------------------------------------------------
    def apply_leaf(self, key: Key, leaf: torch.Tensor, leaf_index: int = 0,
                   path: str = "") -> torch.Tensor:
        """``C`` of leaf ``leaf_index`` (at ``path``) of a tree.  A generator
        compresses the flattened leaf with a fresh seed; an integer step
        encodes the stacked leaf through the wire's route with
        ``leaf_seed(step, salt, leaf_index)`` — one leaf of
        :meth:`WireFormat.encode_tree`, the sharded runtime's encode."""
        if isinstance(key, torch.Generator):
            return self(key, leaf)
        w = self.wire.route(path, leaf.shape)
        return w.decode(w.encode(leaf, self._seed(key, leaf_index)), leaf)

    def tree_apply(self, key: Key, tree: Any) -> Any:
        """``C`` of every leaf of a tree (nested dicts or one tensor): with a
        generator an independent seed per leaf, with an integer step the
        wire's (step, salt, leaf index) seeding, bit-equal to the JAX
        package's."""
        return _rebuild(tree, [self.apply_leaf(key, leaf, li, path)
                               for li, (path, leaf) in enumerate(leaf_items(tree))])

    def tree_compress(self, key: Key, tree: Any):
        """``(paths, [payload per leaf])``, each leaf flattened as in
        :meth:`compress`: with a generator an independent seed per leaf, with
        an integer step ``leaf_seed(step, salt, leaf_index)``."""
        items = leaf_items(tree)
        return ([p for p, _ in items],
                [self.wire.encode(leaf.reshape(-1), self._seed(key, li))
                 for li, (_, leaf) in enumerate(items)])

    def tree_decompress(self, paths, payloads, like_tree: Any) -> Any:
        """Inverse of :meth:`tree_compress`, shaped and typed like ``like_tree``."""
        items = leaf_items(like_tree)
        if [p for p, _ in items] != list(paths):
            raise ValueError("the payloads were compressed from another tree")
        return _rebuild(like_tree, [self.decompress(pl, like)
                                    for pl, (_, like) in zip(payloads, items)])


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    """No-op compression: ``C(z) = z`` (alpha = 0, sigma_tilde = 0)."""

    name: str = "identity"
    salt: int = 0

    @property
    def wire(self) -> WireFormat:
        return IdentityWire()

    def wire_bits_per_element(self, shape=None) -> float:
        return 32.0

    def alpha_bound(self) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class HalfPrecisionCompressor(Compressor):
    """Deterministic fp16 cast: 16 wire bits an element, relative error 2^-11."""

    name: str = "fp16"
    salt: int = 0

    @property
    def wire(self) -> WireFormat:
        return Fp16Wire()

    def alpha_bound(self) -> float:
        return 2.0 ** -11


@dataclasses.dataclass(frozen=True)
class RandomQuantizer(Compressor):
    """Stochastic ``bits``-bit quantization with per-block max-abs scales.

    For a block with scale ``s = max|b|`` and ``L = 2^(bits-1) - 1`` levels,
    each element is stochastically rounded to ``q in {-L..L}`` with
    ``E[q * s / L] = v``.  Wire format: one f32 scale per ``block_size``
    elements plus the codes in their container — stream-packed words for
    ``bits in 2..7`` (``pack=None``), int8 at 8 bits.

    ``use_kernel=True`` compresses through ``kernels/ops.py`` (K1 or K3 on
    the whole flattened tensor, ``block_size % 128 == 0``); the default goes
    through :class:`~repro_torch.distributed.wire.QuantWire`, which reaches
    the same kernels behind its 128-lane gate.  Both hash the same counters,
    so they emit the same payload for the same seed.
    """

    bits: int = 8
    block_size: int = 1024
    name: str = "quant"
    use_kernel: bool = False
    pack: Optional[bool] = None
    salt: int = 0

    def __post_init__(self):
        self.wire  # noqa: B018  (constructing the wire validates bits and pack)

    @property
    def wire(self) -> QuantWire:
        return QuantWire(bits=self.bits, block=self.block_size, pack=self.pack)

    @property
    def packed(self) -> bool:
        return self.wire.packed

    @property
    def levels(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def compress(self, key, x):
        if self.use_kernel:
            return ops.quantize(self._seed(key), x, bits=self.bits,
                                block_size=self.block_size, pack=self.packed)
        return super().compress(key, x)

    def alpha_bound(self) -> float:
        """Worst-case signal-to-noise ratio: ``||Q||² <= N (s/L)²/4`` over a
        block while ``||Z||²`` can be as small as ``s²`` => ``alpha <=
        sqrt(N)/(2L)``."""
        return np.sqrt(self.block_size) / (2.0 * self.levels)


@dataclasses.dataclass(frozen=True)
class _SparseCodecCompressor(Compressor):
    """The fixed-capacity sparsifiers: a view over
    :class:`~repro_torch.distributed.wire.SparseWire` (``k = ceil(p *
    block)`` values a block, f32 or f16, and their indices stream-packed at
    ``ceil(log2(block))`` bits).  ``use_kernel=True`` compresses through
    ``kernels/ops.py`` when the (shrunken) block keeps the 128-lane
    contract, with the same block geometry as the wire."""

    p: float = 0.25
    block_size: int = 128
    value_dtype: str = "float32"    # "float32" | "float16" (wire container)
    use_kernel: bool = False
    mode: str = "randk"
    salt: int = 0

    def __post_init__(self):
        self.wire  # noqa: B018  (validates p, mode, value_dtype)

    @property
    def wire(self) -> SparseWire:
        return SparseWire(p=self.p, block=self.block_size, mode=self.mode,
                          value_dtype=self.value_dtype)

    def _keep_fraction(self, n: int) -> float:
        """The effective keep fraction k/block (>= p because k is a ceil)."""
        block = min(self.block_size, max(n, 1))
        k, _, _, _ = sparse_geometry(block, self.p)
        return k / block

    def compress(self, key, x):
        bs = min(self.block_size, max(x.numel(), 1))
        if self.use_kernel and bs % 128 == 0:
            return ops.sparse_compress(self._seed(key), x, p=self.p, block_size=bs,
                                       mode=self.mode,
                                       value_dtype=getattr(torch, self.value_dtype))
        return super().compress(key, x)


@dataclasses.dataclass(frozen=True)
class RandomSparsifier(_SparseCodecCompressor):
    """Fixed-capacity random-k: a seeded uniform ``k``-subset of every block
    rescaled by ``block/k``, so ``E[C(z)] = z`` and ``E||C(z)-z||² = (1/p_eff
    - 1)||z||²``."""

    name: str = "sparsify"
    mode: str = "randk"

    def alpha_bound(self) -> float:
        return float(np.sqrt(1.0 / self._keep_fraction(self.block_size) - 1.0))


@dataclasses.dataclass(frozen=True)
class TopKSparsifier(_SparseCodecCompressor):
    """Fixed-capacity top-k by magnitude (ties to the smaller index):
    biased, with ``||z - C(z)||² <= (1 - k/n) ||z||²``."""

    name: str = "topk"
    mode: str = "topk"

    def alpha_bound(self) -> float:
        return float(np.sqrt(1.0 - self._keep_fraction(self.block_size)))


@dataclasses.dataclass(frozen=True)
class SignCompressor(Compressor):
    """1-bit scaled sign, a view over
    :class:`~repro_torch.distributed.wire.SignWire`: biased, outside the
    paper's assumptions; the error-feedback algorithms converge with it.
    ``scale="mean"`` is a delta-contraction, ``scale="l2"`` is not."""

    block_size: int = 1024
    scale: str = "mean"
    name: str = "sign"
    salt: int = 0

    def __post_init__(self):
        self.wire  # noqa: B018  (validates scale mode and block alignment)

    @property
    def wire(self) -> SignWire:
        return SignWire(block=self.block_size, scale=self.scale)

    def alpha_bound(self) -> float:
        """``sqrt(1 - 1/d)`` for ``mean`` (attained by a 1-sparse block),
        ``sqrt(2)`` for ``l2``."""
        if self.scale == "mean":
            return float(np.sqrt(1.0 - 1.0 / self.block_size))
        return float(np.sqrt(2.0))

    def delta_bound(self) -> float:
        """The delta of ``E||z - C(z)||² <= (1 - delta)||z||²`` (mean scale)."""
        if self.scale != "mean":
            raise ValueError("l2 sign scale is not a contraction")
        return 1.0 / self.block_size


@dataclasses.dataclass(frozen=True)
class WireViewCompressor(Compressor):
    """A stacked view over any wire format without paper-facing bounds
    (``adaptive``, ``lowrank``).  ``compress``/``decompress`` keep the leaf's
    shape: shape-routed formats must see it."""

    wire_obj: WireFormat = dataclasses.field(default_factory=IdentityWire)
    salt: int = 0

    name: str = "wire-view"

    @property
    def wire(self) -> WireFormat:
        return self.wire_obj

    def compress(self, key, x):
        return self.wire.encode(x, self._seed(key))

    def decompress(self, payload, like):
        return self.wire.decode(payload, like)


def measured_alpha(comp: Compressor, generator: torch.Generator, z: torch.Tensor,
                   n_samples: int = 16) -> float:
    """Monte-Carlo estimate of ``||C(z)-z|| / ||z||``, a fresh seed a sample."""
    errs = torch.stack([torch.linalg.vector_norm(comp(generator, z) - z)
                        for _ in range(n_samples)])
    return float(errs.mean() / (torch.linalg.vector_norm(z) + 1e-12))


def compressor_for(wire, salt: int = 0) -> Compressor:
    """The stacked-reference view of a wire format (or spec string), sharing
    the runtime's wire implementation."""
    w = make_wire_format(wire)
    if isinstance(w, QuantWire):
        return RandomQuantizer(bits=w.bits, block_size=w.block, pack=w.pack, salt=salt)
    if isinstance(w, SparseWire):
        cls = TopKSparsifier if w.mode == "topk" else RandomSparsifier
        return cls(p=w.p, block_size=w.block, value_dtype=w.value_dtype, mode=w.mode,
                   salt=salt)
    if isinstance(w, SignWire):
        return SignCompressor(block_size=w.block, scale=w.scale, salt=salt)
    if isinstance(w, Fp16Wire):
        return HalfPrecisionCompressor(salt=salt)
    if isinstance(w, IdentityWire):
        return IdentityCompressor(salt=salt)
    return WireViewCompressor(wire_obj=w, salt=salt)


REGISTRY = {
    "identity": lambda **kw: IdentityCompressor(),
    "fp16": lambda **kw: HalfPrecisionCompressor(),
    "quant": lambda **kw: RandomQuantizer(**kw),
    "sparsify": lambda **kw: RandomSparsifier(**kw),
    "topk": lambda **kw: TopKSparsifier(**kw),
}


def make_compressor(name: str, **kwargs) -> Compressor:
    """Deprecated: construct the operator class directly, or go through
    ``make_wire_format(spec)`` and :func:`compressor_for`."""
    warnings.warn(
        "make_compressor(name=...) is deprecated; use the compressor classes "
        "directly or compressor_for(make_wire_format(spec))",
        DeprecationWarning, stacklevel=2)
    return REGISTRY[name](**kwargs)

