"""Mixture-of-Experts FFN: shared + routed experts, top-k router, capacity dispatch.

The port of the JAX package's ``models/moe.py``: DeepSeek-MoE style
fine-grained experts, ``n_shared`` always active plus ``n_routed`` of which
each token picks ``top_k`` by router score, dispatched with one-hot
dispatch/combine tensors over token groups of ``group``.  The tokens are
padded to a whole group first and the zero rows are routed too, taking
capacity, as in JAX.  The top-k takes a stable descending sort, so ties go to
the lower expert index as in ``jax.lax.top_k``; the dispatch and combine
tensors are sums of 0/1 products in float32 and so exact, and the routing
weights are normalized by their sum taken in order, as XLA takes it.

Aux outputs: load-balance loss (Switch-style) + router z-loss.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import Params, dense_init, swiglu, swiglu_init


def moe_init(gen: torch.Generator, d: int, d_expert: int, n_routed: int, n_shared: int, *,
             device, lead: tuple = ()) -> Params:
    p: Params = {"router": dense_init(gen, d, n_routed, device=device, scale=0.02, lead=lead),
                 "experts": swiglu_init(gen, d, d_expert, device=device, lead=lead + (n_routed,))}
    if n_shared:
        p["shared"] = swiglu_init(gen, d, d_expert * n_shared, device=device, lead=lead)
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


def _dispatch_indices(gates: torch.Tensor, top_k: int, capacity: int):
    """gates (T, E) -> one-hot dispatch (T, E, C) and combine weights (T, E, C)."""
    T, E = gates.shape
    weights, experts = _top_k(gates, top_k)                          # (T, k)
    # XLA sums the k weights in order; so does this, for the same bits
    total = weights[:, :1]
    for i in range(1, top_k):
        total = total + weights[:, i:i + 1]
    weights = weights / torch.clamp(total, min=1e-9)
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
