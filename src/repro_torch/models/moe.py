"""Mixture-of-Experts FFN: shared + routed experts, top-k router.

The port of the JAX package's ``models/moe.py``: DeepSeek-MoE style
fine-grained experts, ``n_shared`` always active plus ``n_routed`` of which
each token picks ``top_k`` by router score.  The top-k takes a stable
descending sort, so ties go to the lower expert index as in
``jax.lax.top_k``.  Two ways to route:

* capacity (:func:`moe_forward`, JAX's): one-hot dispatch/combine tensors
  over token groups of ``group``, each expert taking at most its capacity
  of a group and dropping the rest.  The tokens are padded to a whole group
  first and the zero rows are routed too, taking capacity, as in JAX.  The
  dispatch and combine tensors are sums of 0/1 products in float32 and so
  exact, and the routing weights are normalized by their sum taken in
  order, as XLA takes it.
* dropless (:func:`moe_dropless`): every (token, choice) pair is computed,
  by the experts this device holds (a share of them, as expert parallelism
  places them); the pairs that chose an expert held elsewhere are left to
  it.  The step reads nothing on the host: the held experts' row counts
  stay on the device as the offsets of one grouped product.

Aux outputs: load-balance loss (Switch-style) + router z-loss.

Dropless routing also takes Nemotron-H's (DeepSeek-V3's router with one
group): a sigmoid score a logit, the chosen scores over their sum times a
routed scale, and non-gated ``relu(x wi)^2 wo`` experts.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (
    Params,
    dense_init,
    gelu_mlp_init,
    relu2,
    relu2_mlp,
    swiglu,
    swiglu_init,
)
from repro_torch.trace import span


def moe_init(gen: torch.Generator, d: int, d_expert: int, n_routed: int, n_shared: int, *,
             device, lead: tuple = (), n_held: Optional[int] = None,
             act: str = "swiglu") -> Params:
    """The router over all ``n_routed`` experts; ``n_held`` of them (all
    when None) stacked under ``experts``; SwiGLU experts, or with ``act``
    ``relu2`` the non-gated ``wi`` and ``wo`` alone."""
    held = n_routed if n_held is None else n_held
    init = swiglu_init if act == "swiglu" else gelu_mlp_init
    p: Params = {"router": dense_init(gen, d, n_routed, device=device, scale=0.02, lead=lead),
                 "experts": init(gen, d, d_expert, device=device, lead=lead + (held,))}
    if n_shared:
        p["shared"] = init(gen, d, d_expert * n_shared, device=device, lead=lead)
    return p


def _top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: float32, and an all-zero row for an index outside
    ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _normalized(weights: torch.Tensor) -> torch.Tensor:
    """The chosen weights (T, k) over their sum.  XLA sums the k weights in
    order; so does this, for the same bits."""
    total = weights[:, :1]
    for i in range(1, weights.shape[1]):
        total = total + weights[:, i:i + 1]
    return weights / torch.clamp(total, min=1e-9)


def _dispatch_indices(gates: torch.Tensor, top_k: int, capacity: int):
    """gates (T, E) -> one-hot dispatch (T, E, C) and combine weights (T, E, C)."""
    T, E = gates.shape
    weights, experts = _top_k(gates, top_k)                          # (T, k)
    weights = _normalized(weights)
    onehot = _one_hot(experts, E)                                    # (T, k, E)
    # position of each (token, choice) within its expert's capacity buffer
    prio = onehot.reshape(T * top_k, E)
    pos = (torch.cumsum(prio, dim=0) - 1.0) * prio                   # rank within expert
    pos = pos.reshape(T, top_k, E)
    keep = (pos < capacity).to(torch.float32) * onehot
    pos_oh = _one_hot(pos.to(torch.int32), capacity)
    dispatch = torch.einsum("tke,tkec->tec", keep, pos_oh * keep[..., None])
    combine = torch.einsum("tke,tkec->tec", weights[..., None] * keep, pos_oh)
    return dispatch, combine


def moe_forward(x: torch.Tensor, p: Params, *, n_routed: int, n_shared: int, top_k: int,
                capacity_factor: float = 1.25, group: int = 1024
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (B, S, d), aux losses.  Tokens processed in groups of ``group``."""
    B, S, d = x.shape
    T = B * S
    g = min(group, T)
    pad = (-T) % g
    flat = x.reshape(T, d)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
    G = flat.shape[0] // g
    xg = flat.reshape(G, g, d)

    logits = torch.einsum("Gtd,de->Gte", xg, p["router"].to(x.dtype)).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)                            # (G, g, E)
    capacity = max(int(g * top_k * capacity_factor / n_routed), top_k)

    pairs = [_dispatch_indices(gates[i], top_k, capacity) for i in range(G)]
    dispatch = torch.stack([dp for dp, _ in pairs])
    combine = torch.stack([cb for _, cb in pairs])
    expert_in = torch.einsum("Gtd,Gtec->Gecd", xg, dispatch.to(x.dtype))
    expert_out = _expert_apply(expert_in, p["experts"])
    out = torch.einsum("Gecd,Gtec->Gtd", expert_out, combine.to(x.dtype))

    out = out.reshape(-1, d)[:T].reshape(B, S, d)
    if n_shared:
        out = out + swiglu(x, p["shared"])

    # Switch-style load-balance loss + router z-loss
    me = gates.mean(dim=1)                                           # (G, E)
    ce = dispatch.sum(dim=-1).mean(dim=1)                            # fraction routed
    lb = n_routed * torch.mean(torch.sum(me * ce, dim=-1))
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out, {"lb_loss": lb, "z_loss": zloss}


def _expert_apply(expert_in: torch.Tensor, experts: Params) -> torch.Tensor:
    """expert_in (G, E, C, d) through stacked expert params (E, ...) -> (G, E, C, d)."""
    def dense_e(x, w):
        return torch.einsum("gecd,edf->gecf", x, w.to(x.dtype))

    h = torch.nn.functional.silu(dense_e(expert_in, experts["wg"])) \
        * dense_e(expert_in, experts["wi"])
    return dense_e(h, experts["wo"])


def moe_dropless(x: torch.Tensor, p: Params, *, n_routed: int, n_shared: int, top_k: int,
                 norm_topk: bool = True, first_held: int = 0, score: str = "softmax",
                 routed_scale: float = 1.0, act: str = "swiglu"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (B, S, d), aux terms; no token is dropped.

    The router's logits are taken in float32 over all ``n_routed`` experts
    (input and weight), then a softmax and a greedy top-k (ties to the lower
    index); the chosen weights are the raw gate values unless ``norm_topk``.
    With ``score`` ``sigmoid`` the top-k is of each logit's sigmoid, and
    ``norm_topk`` divides the chosen scores by their sum plus 1e-20, as
    DeepSeek-V3's router does.  The weights are then multiplied by
    ``routed_scale``.  The experts of ``p["experts"]`` are experts
    ``first_held, ..., first_held + E_held - 1``.  The (token, choice) pairs
    that chose one of them are sorted by expert, their rows run through the
    held experts' SwiGLU (or, with ``act`` ``relu2``, ``relu(x wi)^2 wo``)
    as grouped products (``torch._grouped_mm``, the expert row counts as
    their device offsets), and the weighted rows are summed back into their
    tokens.  The shared experts are added once.  What the experts held
    elsewhere would add is left out.

    Aux terms, over the whole batch as one group and all ``n_routed`` gates
    (a sigmoid router's gates are each token's scores over their sum):
    ``lb_loss = n_routed * sum_e mean_t(gate_te) * (tokens choosing e) / T``
    (Switch) and ``z_loss = mean_t logsumexp(logits_t)^2``.  Metrics (no
    gradient): ``moe_held_rows``, the pairs the held experts computed, and
    ``moe_max_load``, the largest held expert's rows over their mean.
    """
    B, S, d = x.shape
    T = B * S
    held = p["experts"]["wi"].shape[0]
    flat = x.reshape(T, d)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    with span("model.moe.route"):
        logits = flat.to(torch.float32) @ p["router"].to(torch.float32)     # (T, E)
        if score == "sigmoid":
            scores = torch.sigmoid(logits)
            weights, experts = _top_k(scores, top_k)                        # (T, k)
            if norm_topk:
                weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
            gates = scores / scores.sum(dim=-1, keepdim=True)
        else:
            gates = torch.softmax(logits, dim=-1)
            weights, experts = _top_k(gates, top_k)                         # (T, k)
            if norm_topk:
                weights = _normalized(weights)
        if routed_scale != 1.0:
            weights = weights * routed_scale
        # the pairs of the held experts first, by expert; the others after
        local = experts.reshape(-1) - first_held
        local = torch.where((local >= 0) & (local < held), local, held)
        local, order = torch.sort(local, stable=True)
        bounds = torch.arange(1, held + 1, device=x.device, dtype=local.dtype)
        offs = torch.searchsorted(local, bounds).to(torch.int32)            # group ends
        valid = (torch.arange(T * top_k, device=x.device) < offs[-1])[:, None]
        rows = flat[:, None, :].expand(T, top_k, d).reshape(T * top_k, d)[order]
        rows = torch.where(valid, rows, zero)
    with span("model.moe.experts"):
        # rows past the last offset are not computed: masked on both sides
        e = p["experts"]
        if act == "relu2":
            h = relu2(_grouped(rows, e["wi"], offs))
        else:
            h = torch.nn.functional.silu(_grouped(rows, e["wg"], offs)) \
                * _grouped(rows, e["wi"], offs)
        y = torch.where(valid, _grouped(h, e["wo"], offs), zero)
        w = weights.reshape(-1)[order].to(x.dtype)
        pairs = torch.empty_like(y).index_copy_(0, order, y * w[:, None])   # (token, choice)
        out = pairs.reshape(T, top_k, d).sum(dim=1).reshape(B, S, d)
    if n_shared:
        out = out + (relu2_mlp if act == "relu2" else swiglu)(x, p["shared"])

    counts = _one_hot(experts, n_routed).sum(dim=1)                         # (T, E) 0/1
    lb = n_routed * torch.sum(gates.mean(dim=0) * counts.mean(dim=0))
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    with torch.no_grad():
        rows_e = torch.diff(offs, prepend=offs[:1] * 0).to(torch.float32)
        held_rows = offs[-1].to(torch.float32)
        max_load = rows_e.max() * held / torch.clamp(held_rows, min=1.0)
    return out, {"lb_loss": lb, "z_loss": zloss, "moe_held_rows": held_rows,
                 "moe_max_load": max_load}


def _grouped(rows: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """rows (M, i) through expert ``g``'s ``w[g]`` (i, o) for the rows of group
    ``g`` (ends ``offs``); the rows past ``offs[-1]`` are left unwritten."""
    return torch._grouped_mm(rows, w.to(rows.dtype), offs=offs)
