"""Placement rules: the partition of every param, cache and batch leaf over
a device layout, as pure shape logic.

The port of the JAX package's ``distributed/sharding.py``.  The JAX rules
map each leaf to a ``PartitionSpec`` over a ``Mesh`` of devices; here a
spec is a tuple with one entry a dim, an axis name or ``None``, and a
layout is anything with ``axis_names`` and ``devices.shape`` (the port's
:class:`~repro_torch.launch.mesh.LogicalMesh`, or a JAX ``Mesh``).  The
port's runtime shards no node over devices: these rules size the plan, and
:func:`per_device_bytes` does the arithmetic of XLA's
``memory_analysis().argument_size_in_bytes`` for the inputs.

The rules (derived from shapes and path names, so they cover all ten
architectures without per-arch tables):

* ``experts`` leaves get expert parallelism: the expert dim -> ``model``.
* otherwise the tensor-parallel dim by weight name (column-parallel: the
  output dim; row-parallel: the input dim), the vocab of ``embed`` and
  ``lm_head``, or the largest divisible dim -> ``model``; the next largest
  divisible dim -> ``fsdp`` (ZeRO-style within a node).
* tiny and 1-D leaves (norm gains, biases) replicate, but for the SSM's
  per-head vectors.
* stacked leading axes (node, layer, period) are never sharded, except the
  explicit ``node`` axis of decentralized state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.tree import leaf_items, tree_from_items

Spec = Tuple[Optional[str], ...]

# Megatron-style tensor-parallel direction by weight name (the trailing two
# dims of a weight are (d_in, d_out)): column-parallel (shard d_out) for QKV,
# MLP up/gate and the SSM input projections; row-parallel (shard d_in) for
# the output projections, closed by one all-reduce a block.
_COL_PARALLEL = ("wq", "wk", "wv", "wi", "wg", "w1", "wz", "wx", "wbc", "wdt",
                 "wuk", "wuv")
_ROW_PARALLEL = ("wo", "out_proj", "w2")
_HEAD_VECTORS = ("A_log", "D", "dt_bias", "norm_g", "conv_b")   # shard last dim
# MLA's shared latent and rope-key projections: small outputs that every
# head reads, so replicated
_REPLICATED = ("router", "wkr", "wdkv")


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a layout."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _leaf_base(name: str) -> str:
    return name.rsplit("/", 1)[-1]


def param_pspec(name: str, shape: Tuple[int, ...], mesh, *, node_axis: bool,
                n_stack_axes: int = 0, n_routed: Optional[int] = None,
                use_fsdp: bool = True) -> Spec:
    """The spec of the parameter leaf at path ``name`` (``/``-joined keys)
    of ``shape``.  ``node_axis``: the leading dim is the decentralized node
    axis (stacked replicas); ``n_stack_axes``: further leading stacked axes
    (layer, period), never sharded."""
    base = _leaf_base(name)
    reserved = (1 if node_axis else 0) + n_stack_axes
    axes = axis_sizes(mesh)
    # serving layout (dp, mp): mp plays "model", dp plays "fsdp"
    model_name, model = ("mp", axes["mp"]) if "mp" in axes else ("model", axes.get("model", 1))
    fsdp_name, fsdp = ("dp", axes["dp"]) if "dp" in axes else ("fsdp", axes.get("fsdp", 1))

    spec: List[Optional[str]] = [None] * len(shape)
    free = list(range(reserved, len(shape)))

    def put(axis_name: str, size: int, dim: int) -> bool:
        if dim in free and shape[dim] % size == 0 and shape[dim] >= size and size > 1:
            spec[dim] = axis_name
            free.remove(dim)
            return True
        return False

    ndim_body = len(shape) - reserved
    if n_routed and "experts" in name:
        # expert parallelism: E -> model; the remaining big dim -> fsdp
        for i in list(free):
            if shape[i] == n_routed:
                put(model_name, model, i)
                break
    elif base in _REPLICATED or ndim_body == 0:
        pass
    elif ndim_body == 1:
        if base in _HEAD_VECTORS:
            put(model_name, model, len(shape) - 1)
    elif base in _COL_PARALLEL or base == "conv_w":
        put(model_name, model, len(shape) - 1)              # d_out / channels
    elif base in _ROW_PARALLEL:
        put(model_name, model, len(shape) - 2)              # d_in
    elif base == "embed":
        # vocab (padded) over model keeps activations replicated across TP
        if not put(model_name, model, len(shape) - 2):
            put(model_name, model, len(shape) - 1)
    elif base == "lm_head":
        put(model_name, model, len(shape) - 1)              # vocab, so logits shard
    else:
        # an unknown 2-D+ weight: the largest divisible trailing dim
        for i in sorted(free, key=lambda i: -shape[i]):
            if put(model_name, model, i):
                break

    # ZeRO/FSDP: the largest remaining divisible dim within the node (serving
    # skips this when the bf16 weights fit a device already)
    if fsdp > 1 and use_fsdp:
        for i in sorted(free, key=lambda i: -shape[i]):
            if shape[i] >= 2 * fsdp and put(fsdp_name, fsdp, i):
                break

    if node_axis:
        spec[0] = "node"
    return tuple(spec)


def stack_depth(name: str) -> int:
    """How many leading stacked-layer axes the leaf at path ``name`` has."""
    if name.startswith("pm/"):
        return 2          # (n_periods, per_period, ...)
    for pref in ("blocks/", "blocks0/", "tail/", "enc/", "dec/"):
        if name.startswith(pref):
            return 1
    return 0


def params_shardings(params: Any, mesh, *, node_axis: bool, n_routed: Optional[int] = None,
                     use_fsdp: bool = True) -> Any:
    """The tree of specs matching ``params`` (possibly node-stacked)."""
    return tree_from_items([
        (p, param_pspec(p, tuple(leaf.shape), mesh, node_axis=node_axis,
                        n_stack_axes=stack_depth(p), n_routed=n_routed, use_fsdp=use_fsdp))
        for p, leaf in leaf_items(params)])


def batch_shardings(batch: Any, mesh, *, node_axis: bool) -> Any:
    """Batch dim -> fsdp (within a node), with the leading node axis when
    stacked; -> dp on the serving layout."""
    axes = axis_sizes(mesh)

    def one(leaf) -> Spec:
        spec: List[Optional[str]] = [None] * leaf.dim()
        if node_axis:
            spec[0] = "node"
            if leaf.shape[1] % axes.get("fsdp", 1) == 0 and axes.get("fsdp", 1) > 1:
                spec[1] = "fsdp"
        else:
            dp_name = "dp" if "dp" in axes else "fsdp"
            if leaf.shape[0] % axes.get(dp_name, 1) == 0 and axes.get(dp_name, 1) > 1:
                spec[0] = dp_name
        return tuple(spec)

    if isinstance(batch, torch.Tensor):
        return one(batch)
    return tree_from_items([(p, one(l)) for p, l in leaf_items(batch)])


def cache_items(caches: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``[(path, tensor), ...]`` of a cache tree: dicts by sorted key, a cache
    record (``KVCache``, ``MLACache``, ``SSMCache``, ``CrossCache``) by its
    tensor fields, named as the JAX rules name a record's field (``.k``: its
    path entry prints so).  The host-integer positions are no leaves here
    (JAX's (L,) ``pos`` replicates)."""
    if isinstance(caches, torch.Tensor):
        return [(prefix, caches)]
    if isinstance(caches, dict):
        out = []
        for k in sorted(caches):
            out.extend(cache_items(caches[k], f"{prefix}/{k}" if prefix else k))
        return out
    if dataclasses.is_dataclass(caches):
        out = []
        for f in dataclasses.fields(caches):
            v = getattr(caches, f.name)
            if isinstance(v, torch.Tensor):
                out.append((f"{prefix}/.{f.name}" if prefix else f".{f.name}", v))
        return out
    return []


# Where the tensor-parallel axis lives in each cache leaf (negative dim):
# KV and cross caches by KV heads, MLA by the latent / rope dim, SSM by heads.
# The JAX rules key it by the leaf's base name, and a cache record's field is
# named ``.k`` there, not ``k``; so for the decode caches the table matches
# no leaf and the largest divisible dim takes mp.  The port keeps the JAX
# package's placements, this included.
_CACHE_MP_DIM = {"k": -2, "v": -2, "c_kv": -1, "k_rope": -1, "h": -3, "conv": -1}


def cache_pspec(name: str, shape: Tuple[int, ...], mesh, *, batch: int) -> Spec:
    """A decode cache leaf on the (dp, mp) serving layout: batch -> dp when it
    divides; for batch 1 (long-context decode) the capacity dim takes dp
    instead (sequence sharding).  The tensor-parallel dim is keyed by the
    cache leaf's name (``_CACHE_MP_DIM``)."""
    axes = axis_sizes(mesh)
    dp, mp = axes["dp"], axes["mp"]
    spec: List[Optional[str]] = [None] * len(shape)
    base = _leaf_base(name)
    if len(shape) <= 1 or base == "pos":
        return tuple(spec)
    b_idx = next((i for i, s in enumerate(shape) if s == batch and i <= 2), None)
    if b_idx is not None and batch % dp == 0 and batch >= dp and dp > 1:
        spec[b_idx] = "dp"
    mp_dim = _CACHE_MP_DIM.get(base)
    if mp_dim is not None and mp > 1:
        i = len(shape) + mp_dim
        if 0 <= i < len(shape) and spec[i] is None and shape[i] % mp == 0 and shape[i] >= mp:
            spec[i] = "mp"
    # mp still unassigned: the largest remaining divisible dim
    if "mp" not in spec and mp > 1:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % mp == 0 and shape[i] >= mp:
                spec[i] = "mp"
                break
    # batch too small for dp: the largest remaining dim (capacity)
    if "dp" not in spec and dp > 1:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % dp == 0 and shape[i] >= dp:
                spec[i] = "dp"
                break
    return tuple(spec)


def cache_shardings(caches: Any, mesh, *, batch: int) -> Dict[str, Spec]:
    """``{path: spec}`` of every cache tensor (:func:`cache_items`)."""
    return {p: cache_pspec(p, tuple(t.shape), mesh, batch=batch)
            for p, t in cache_items(caches)}


def replicated(ndim: int = 0) -> Spec:
    return (None,) * ndim


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of a leaf: each sharded dim divided by its axis
    size (the rules shard only dims the axis divides)."""
    axes = axis_sizes(mesh)
    return tuple(d // axes[a] if a is not None else d for d, a in zip(shape, spec))


def per_device_bytes(leaves: List[Tuple[torch.Tensor, Spec]], mesh) -> int:
    """The bytes one device holds of ``leaves`` (each with its spec): the
    sum of the shards' sizes, XLA's ``argument_size_in_bytes`` for inputs."""
    return sum(math.prod(shard_shape(tuple(t.shape), spec, mesh)) * t.element_size()
               for t, spec in leaves)
