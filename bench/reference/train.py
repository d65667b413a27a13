"""The first steps of a training cell, worked out without the program.

Every node holds a copy of the same float32 parameters.  Step ``t``: node
``i`` takes the gradient ``g_i`` of its batch's mean token loss; AdamW
(``b1 0.9, b2 0.95, eps 1e-8``, decoupled weight decay) turns it into an
update ``u_i = -lr_t ((m/(1-b1^k)) / (sqrt(v/(1-b2^k)) + eps) + wd x_i)``
with ``lr_t`` a linear warm-up from 0 over ``warmup`` steps; and the nodes
mix over the gossip graph ``W`` (a ring: self and both neighbours at 1/3):

* ``dpsgd``: ``X <- W X + U``, every node sending its dense parameters;
* ``dcd``: ``X <- X + Q(W X + U - X)``, where ``Q`` is the quantized wire
  (:mod:`bench.reference.wire`, salt 2) and every node's neighbours decode
  the same codes, so the neighbours' copies of ``X`` are ``X`` itself.

The record: each step's loss averaged over nodes, the first step's gradient
norm and the change of the parameters after the last step, both per leaf,
the bytes the nodes handed the network, and the batches.
"""
from __future__ import annotations

import torch

from bench.reference import data, model, wire

SALT = {"dcd": 2}


def leaf_items(tree, prefix: str = ""):
    """``[(path, leaf)]`` by sorted key, depth first (the wire's leaf order)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaf_items(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _from_items(items):
    out: dict = {}
    for path, leaf in items:
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def mixing_matrix(topology: str, n: int) -> torch.Tensor:
    if topology != "ring" or n < 3:
        raise ValueError(f"the reference mixes over a ring of 3 or more nodes, got "
                         f"{topology} of {n}")
    w = torch.zeros((n, n), dtype=torch.float32)
    for i in range(n):
        for j in (i - 1, i, i + 1):
            w[i, j % n] = 1.0 / 3.0
    return w


def learning_rate(traffic: dict, step: int) -> float:
    if step < traffic["warmup"]:
        return traffic["lr"] * step / traffic["warmup"]
    raise ValueError("the reference follows the warm-up steps only")


def run(cfg: dict, traffic: dict, seed: int, params0: dict, steps: int, device,
        precision: str = "f32", node=None) -> dict:
    """``steps`` steps from ``params0`` (one node's tree) on every node.

    With ``node`` this process holds that node alone, one of the
    ``n_nodes`` processes of an initialized ``torch.distributed`` group, and
    gathers every node's parameters leaf by leaf to mix them; its record is
    its node's batches and the group's losses, norms and bytes."""
    algo, n = traffic["algo"], traffic["n_nodes"]
    if algo not in ("dcd", "dpsgd") or traffic["optimizer"] != "adamw":
        raise ValueError(f"the reference runs dcd and dpsgd under adamw, got {algo}")
    wspec = wire.parse(traffic["wire"]) if algo == "dcd" else None
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, traffic["weight_decay"]
    mix = mixing_matrix(traffic["topology"], n).to(device)
    mine = slice(0, n) if node is None else slice(node, node + 1)
    items0 = leaf_items(params0)
    paths = [p for p, _ in items0]
    xs = [l.detach().to(torch.float32).unsqueeze(0).repeat((mine.stop - mine.start,)
                                                           + (1,) * l.dim())
          for _, l in items0]
    ms = [torch.zeros_like(x) for x in xs]
    vs = [torch.zeros_like(x) for x in xs]
    rec = {"losses": [], "tokens": [], "labels": [], "sent_bytes": 0}
    for t in range(steps):
        batch = data.node_batches(seed, t, vocab=cfg["vocab"], seq_len=traffic["seq_len"],
                                  global_batch=traffic["global_batch"], nodes=n, device=device)
        rec["tokens"].append(batch["tokens"][mine])
        rec["labels"].append(batch["labels"][mine])
        grads = [torch.empty_like(x) for x in xs]
        losses = 0.0
        for i, k in enumerate(range(mine.start, mine.stop)):
            leaves = [x[i].clone().requires_grad_(True) for x in xs]
            with torch.enable_grad():
                loss_k = model.loss(cfg, _from_items(list(zip(paths, leaves))),
                                    batch["tokens"][k], batch["labels"][k], precision)
                loss_k.backward()
            losses += float(loss_k.detach())
            for g, leaf in zip(grads, leaves):
                g[i] = leaf.grad
            del leaves, loss_k
        rec["losses"].append(_sum([losses], node)[0] / n)
        if t == 0:
            squares = _sum([float(g.square().sum()) for g in grads], node)
            rec["grad_norms"] = {p: sq ** 0.5 for p, sq in zip(paths, squares)}
        lr, k = learning_rate(traffic, t), t + 1
        for li, (x, m, v, g) in enumerate(zip(xs, ms, vs, grads)):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / (1 - b1 ** k)) / (torch.sqrt(v / (1 - b2 ** k)) + eps) + wd * x
            mixed = torch.einsum("ij,j...->i...", mix[mine], _gather(x, n, node)) - lr * upd
            if algo == "dpsgd":
                rec["sent_bytes"] += x.numel() * x.element_size()
                x.copy_(mixed)
            else:
                z = mixed - x
                x.add_(wire.quantize_dequantize(z, wire.leaf_seed(t, SALT[algo], li), wspec,
                                                mine.start))
                rec["sent_bytes"] += wire.container_bytes(wspec, x.shape)
            del upd, mixed
            grads[li] = None
    rec["sent_bytes"] = int(_sum([rec["sent_bytes"]], node)[0])
    squares = _sum([float((x - l.to(torch.float32)).square().sum())
                    for x, (_, l) in zip(xs, items0)], node)
    rec["change_norms"] = {p: sq ** 0.5 for p, sq in zip(paths, squares)}
    return rec


def _sum(values, node) -> list:
    """``values`` summed over the group's processes (as they are alone)."""
    if node is None:
        return list(values)
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=_device())
    dist.all_reduce(t)
    return t.tolist()


def _gather(x: torch.Tensor, n: int, node) -> torch.Tensor:
    """Every node's ``(n, ...)`` leaf: ``x`` itself, or gathered from the
    group's processes in node order."""
    if node is None:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _device():
    import torch.distributed as dist

    return torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
