"""How a plan shift moves a payload: on one device, or between node ranks.

The JAX runtime moves an encoded payload along plan shift ``s`` with a
collective-permute of the stacked node axis; a device that holds node ``i``
receives node ``(i - s) % n``'s payload.  The port has two transports for
that move, with one interface, so the rounds of
:mod:`~repro_torch.distributed.decentralized` are written once:

* :class:`StackedTransport` — every node on one device, a leading node axis
  of length ``n``: a shift is ``torch.roll(payload, s, dims=0)``, made when
  the round reads it, so a round holds one rolled neighbour at a time.
* :class:`RankTransport` — one process a node (a
  :class:`~repro_torch.launch.mesh.NodeGroup`), each holding its node's
  ``(1, ...)`` slice: for shift ``s`` rank ``i`` sends to rank ``(i + s) % n``
  and receives from ``(i - s) % n``, one ``dist.batch_isend_irecv`` for every
  shift of a round and leaf.  An edge whose drop mask is 0 carries nothing:
  both ends read the same host mask, so the sender does not send and the
  receiver gets ``None``.  Under ``gloo`` a CUDA tensor is staged through
  pinned host memory and what arrives is copied back to the rank's device
  before it is decoded, so the receive kernels run on the card; under
  ``nccl`` the containers go device to device.

The rank transport counts what it sends, by label
(:class:`TransportStats`): ``wire`` (encoded containers), ``dense`` (D-PSGD's
full-precision X), ``resync`` (X at a phase boundary's rekey),
``allreduce`` (C-PSGD's node mean), ``metric`` (the loss and consensus
metrics) and ``checkpoint`` (the gather to rank 0).  Each call of either
transport runs in the span ``transport.<label>`` (:mod:`repro_torch.trace`),
whose host time on ranks includes staging and the copies back.  On the
stacked transport a ``wire`` or ``dense`` span covers the whitelist check
and the stats only: its rolls are made later, inside whichever span reads
them.

The payload whitelist (the JAX package's ``check_permute_payload_whitelist``):
a ``wire`` exchange refuses a float32 or float64 tensor shaped like a dense
param leaf unless the wire's own containers have that shape (``identity``
ships the leaf) — see :func:`wire_refused_shapes`.  It raises; a wire run
never sends a dense leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.trace import span

Payload = Dict[str, torch.Tensor]

_DENSE_DTYPES = (torch.float32, torch.float64)


class Lazy(dict):
    """``{s: make(s)}`` made on access and not kept, so that a mix holds one
    rolled or decoded neighbour at a time."""

    def __init__(self, make: Callable[[int], object]):
        super().__init__()
        self.make = make

    def __missing__(self, s: int):
        return self.make(s)


@dataclasses.dataclass
class TransportStats:
    """What a transport was handed, by label: bytes, and the dtypes and the
    ``(dtype, shape)`` of the tensors.  A rank counts what it sends; the
    stacked transport what each exchange was handed, once whatever its
    shifts."""
    sent: Dict[str, int] = dataclasses.field(default_factory=dict)
    shapes: Dict[str, set] = dataclasses.field(default_factory=dict)

    @property
    def dtypes(self) -> Dict[str, set]:
        """The dtype names handed, by label."""
        return {label: {d for d, _ in pairs} for label, pairs in self.shapes.items()}

    def add(self, label: str, tensors: Iterable[torch.Tensor]) -> None:
        tensors = list(tensors)
        self.sent[label] = self.sent.get(label, 0) + sum(t.numel() * t.element_size()
                                                         for t in tensors)
        self.shapes.setdefault(label, set()).update(
            (str(t.dtype).removeprefix("torch."), tuple(t.shape)) for t in tensors)

    def reset(self) -> None:
        self.sent.clear()
        self.shapes.clear()


def wire_refused_shapes(leaves: Sequence[torch.Tensor], wires: Sequence) -> FrozenSet[tuple]:
    """The shapes a ``wire`` exchange refuses: every float32/float64 param
    leaf's, less every float container shape the leaves' wires build
    (computed on ``meta`` tensors, shapes only)."""
    dense = {tuple(l.shape) for l in leaves if l.dtype in _DENSE_DTYPES}
    allowed = set()
    for leaf, w in zip(leaves, wires):
        payload = w.encode(torch.empty(leaf.shape, dtype=torch.float32, device="meta"), 0)
        allowed |= {tuple(t.shape) for t in payload.values() if t.dtype in _DENSE_DTYPES}
    return frozenset(dense - allowed)


def _check_whitelist(payload: Payload, label: str, refuse: FrozenSet[tuple]) -> None:
    if label != "wire":
        return
    for k, t in payload.items():
        if t.dtype in _DENSE_DTYPES and tuple(t.shape) in refuse:
            raise ValueError(f"the wire exchange was handed a dense {t.dtype} tensor "
                             f"{k!r} of param-leaf shape {tuple(t.shape)}: only wire "
                             f"containers may be sent")


class StackedTransport:
    """All ``n`` nodes stacked on one device; ``stats`` records what each
    exchange is handed (it refuses nothing: the whitelist guards a rank)."""

    def __init__(self, n: int):
        self.n = n
        self.rank: Optional[int] = None
        self.nodes = n          # nodes this process holds
        self.stats = TransportStats()

    def local(self, w):
        """A per-node weight or mask as this process holds it: all of it."""
        return w

    def exchange(self, payload: Payload, shifts: Sequence[int],
                 masks: Optional[Mapping[int, torch.Tensor]] = None, *, label: str = "wire",
                 refuse: FrozenSet[tuple] = frozenset()) -> Mapping[int, Optional[Payload]]:
        """``{s: roll(payload, s)}`` for each shift, rolled on access.  Drops
        are the caller's (it restores the dropped rows)."""
        with span(f"transport.{label}"):
            _check_whitelist(payload, label, refuse)
            self.stats.add(label, payload.values())
        return Lazy(lambda s: {k: torch.roll(v, s, dims=0) for k, v in payload.items()})

    def shift_tree(self, leaves: List[torch.Tensor], s: int) -> List[torch.Tensor]:
        """Every node's copy of node ``(i - s)``'s leaves (a rekey's resync)."""
        with span("transport.resync"):
            return [torch.roll(l, s, dims=0) for l in leaves]

    def node_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over nodes, keeping a node axis of 1."""
        with span("transport.allreduce"):
            return t.mean(dim=0, keepdim=True)

    def gather_nodes(self, t: torch.Tensor) -> torch.Tensor:
        """Every node's values of a (nodes, ...) tensor, stacked in node order."""
        with span("transport.metric"):
            return t

    def consensus(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """``sum_leaves sum_i ||x_i - mean_j x_j||^2`` in float32, the mean
        taken of the differences to node 0, so that identical replicas give
        exactly 0 (a float32 mean of equal values need not return the
        value)."""
        with span("transport.metric"):
            total = 0.0
            for l in leaves:
                l = l.to(torch.float32)
                d = l - l[:1]
                d.sub_(d.mean(dim=0, keepdim=True))
                total = total + torch.sum(d.square_())
            return total


class RankTransport(StackedTransport):
    """Node ``group.rank`` of ``group.n``, one process each; counts what it
    sends in ``group.stats``."""

    def __init__(self, group):
        super().__init__(group.n)
        import torch.distributed as dist

        self.dist = dist
        self.group = group
        self.stats = group.stats
        self.rank = group.rank
        self.nodes = 1
        self.device = group.device
        # gloo moves host tensors: CUDA tensors are staged through pinned memory
        self.stage = group.backend == "gloo" and group.device.type == "cuda"

    def local(self, w):
        """This rank's entry of an (n,) per-node vector, kept as a vector of
        one; a scalar weight as it is."""
        if isinstance(w, (np.ndarray, torch.Tensor)) and w.ndim == 1:
            return w[self.rank:self.rank + 1]
        return w

    # --- staging ------------------------------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend sends it (a pinned host copy under gloo)."""
        t = t.contiguous()
        if not self.stage:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        if self.stage:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=like.dtype, device=self.device)

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True) if self.stage else t

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # --- exchanges ------------------------------------------------------------
    def exchange(self, payload: Payload, shifts: Sequence[int],
                 masks: Optional[Mapping[int, torch.Tensor]] = None, *, label: str = "wire",
                 refuse: FrozenSet[tuple] = frozenset()) -> Dict[int, Optional[Payload]]:
        """``{s: node (rank - s)'s payload}`` on this rank's device, or
        ``None`` where the mask dropped the edge; one batch of sends and
        receives covers every shift."""
        with span(f"transport.{label}"):
            return self._exchange(payload, shifts, masks, label, refuse)

    def _exchange(self, payload, shifts, masks, label, refuse) -> Dict[int, Optional[Payload]]:
        _check_whitelist(payload, label, refuse)
        i, n = self.rank, self.n
        keys = sorted(payload)
        out = {k: self._out(payload[k]) for k in keys}
        self._sync()
        P2POp = self.dist.P2POp
        ops, recv, sent = [], {}, []
        for si, s in enumerate(shifts):
            dst, src = (i + s) % n, (i - s) % n
            tags = range(si * len(keys), (si + 1) * len(keys))
            if masks is None or float(masks[s][dst]) != 0.0:
                ops += [P2POp(self.dist.isend, out[k], dst, tag=tag) for k, tag in zip(keys, tags)]
                sent += [out[k] for k in keys]
            if masks is None or float(masks[s][i]) != 0.0:
                recv[s] = {k: self._buffer(out[k]) for k in keys}
                ops += [P2POp(self.dist.irecv, recv[s][k], src, tag=tag)
                        for k, tag in zip(keys, tags)]
            else:
                recv[s] = None
        if ops:
            for work in self.dist.batch_isend_irecv(ops):
                work.wait()
        got = {s: None if p is None else {k: self._back(v) for k, v in p.items()}
               for s, p in recv.items()}
        self._sync()
        self.stats.add(label, sent)
        return got

    def shift_tree(self, leaves: List[torch.Tensor], s: int) -> List[torch.Tensor]:
        return [self.exchange({"x": l}, (s,), label="resync")[s]["x"] for l in leaves]

    def _collective(self, t: torch.Tensor, label: str, run) -> torch.Tensor:
        """Run ``run(buffer)`` (a collective, in place) on ``t``'s staged copy;
        returns the result on the device.  The caller's span times it."""
        buf = self._out(t) if self.stage else t.clone(memory_format=torch.contiguous_format)
        self._sync()
        run(buf)
        res = self._back(buf)
        self._sync()
        self.stats.add(label, [buf])
        return res

    def node_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The all-reduce mean over ranks: every rank gets the same bits."""
        with span("transport.allreduce"):
            summed = self._collective(t, "allreduce", self.dist.all_reduce)
            return summed.div_(self.n)

    def gather_nodes(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's (1, ...) values stacked in rank order: (n, ...)."""
        with span("transport.metric"):
            buf = t.detach().contiguous()
            buf = buf.cpu() if self.stage else buf
            parts = [torch.empty_like(buf) for _ in range(self.n)]
            self.dist.all_gather(parts, buf)
            self.stats.add("metric", [buf])
            return torch.cat(parts).to(t.device)

    def gather_to_root(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """Rank 0 gets every rank's (1, ...) tensor stacked in rank order (on
        the host); the other ranks get None."""
        with span("transport.checkpoint"):
            buf = t.detach().contiguous()
            buf = buf.cpu() if self.stage else buf
            parts = [torch.empty_like(buf) for _ in range(self.n)] if self.rank == 0 else None
            self.dist.gather(buf, parts, dst=0)
            self.stats.add("checkpoint", [buf])
            return torch.cat(parts).cpu() if parts is not None else None

    def consensus(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """The stacked definition across ranks: node 0's params broadcast,
        the differences' mean all-reduced, the squares summed and
        all-reduced (label ``metric``)."""
        bcast = lambda b: self.dist.broadcast(b, src=0)
        with span("transport.metric"):
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for l in leaves:
                l = l.to(torch.float32)
                d = l - self._collective(l, "metric", bcast)
                d.sub_(self._collective(d, "metric", self.dist.all_reduce).div_(self.n))
                total = total + torch.sum(d.square_())
            return self._collective(total.reshape(1), "metric", self.dist.all_reduce)[0]


def make_transport(group, n: int) -> StackedTransport:
    """The stacked transport for ``group=None``, else the rank transport of
    ``group`` (which must hold ``n`` ranks)."""
    if group is None:
        return StackedTransport(n)
    if group.n != n:
        raise ValueError(f"the plan has {n} nodes but the group {group.n} ranks")
    return RankTransport(group)
