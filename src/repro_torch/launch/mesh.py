"""The node axis across processes: one rank per gossip node.

The port's counterpart of the node axis of the JAX package's
``launch/mesh.py`` (``derive_train_mesh``), over which the JAX runtime
shards its stacked state.  Here each node of the gossip plan is a process of
a ``torch.distributed`` group, a :class:`NodeGroup`: its rank, the node
count, its device and the backend.

* From torchrun's environment: ``init_node_group(backend)`` reads ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and ``LOCAL_RANK``.
* From :func:`spawn_ranks`: ``n`` new processes meet at a ``file://``
  rendezvous in a fresh temporary directory (no TCP port to race for).

The production layouts of the JAX package's ``launch/mesh.py``
(:func:`make_production_mesh`, :func:`derive_train_mesh`,
:func:`derive_serve_mesh`) are :class:`LogicalMesh` es here: axis names and
sizes and the device ids in the JAX mesh's pod-major order, touching no
device.  The dryrun sizes its plans over them
(:mod:`repro_torch.distributed.sharding`).

``backend`` is the caller's choice, never switched.  ``nccl`` takes one GPU a
rank and raises when a host has more ranks than GPUs; ``gloo`` lets ranks
share a GPU (on a one-card machine every rank runs on ``cuda:0``) and stages
CUDA tensors through pinned host memory.  Without ``device="cpu"`` every rank
runs on CUDA.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.transport import TransportStats

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class NodeGroup:
    """This process's place on the node axis: node ``rank`` of ``n``."""
    rank: int
    n: int
    device: torch.device
    backend: str
    stats: TransportStats = dataclasses.field(default_factory=TransportStats)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()

    def close(self) -> None:
        """Leave the process group."""
        import torch.distributed as dist

        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A device layout by name: ``devices`` holds the device ids (0..size-1)
    in an array whose shape is the axis sizes, as a JAX ``Mesh`` holds its
    devices; nothing here touches a device."""
    axis_names: Tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, device: int) -> Dict[str, int]:
        """The axis coordinates of device id ``device``."""
        where = np.argwhere(self.devices == device)
        if len(where) != 1:
            raise ValueError(f"device {device} is not in this {self.size}-device layout")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The 256-device (data 16, model 16) layout, or 512 with a pod axis of
    2 outermost."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(axes, np.arange(int(np.prod(shape))).reshape(shape))


def derive_train_mesh(mesh: LogicalMesh, n_nodes: int, tp: Optional[int] = None
                      ) -> LogicalMesh:
    """The same devices as (node, fsdp, model=tp), pod-major: with two pods
    the pod axis is the outermost part of the node axis, so the gossip ring
    crosses the slow links between pods.  ``tp`` defaults to the layout's
    model width; a smaller one folds the spare factor into fsdp."""
    total = mesh.size
    tp = tp if tp is not None else mesh.devices.shape[-1]
    if total % (n_nodes * tp):
        raise ValueError(f"node={n_nodes} x tp={tp} must divide {total}")
    fsdp = total // (n_nodes * tp)
    return LogicalMesh(("node", "fsdp", "model"),
                       mesh.devices.reshape(-1).reshape(n_nodes, fsdp, tp))


def derive_serve_mesh(mesh: LogicalMesh, mp: int) -> LogicalMesh:
    """The same devices as (dp, mp) for serving (no gossip axis)."""
    total = mesh.size
    if total % mp:
        raise ValueError(f"mp={mp} must divide {total}")
    return LogicalMesh(("dp", "mp"), mesh.devices.reshape(-1).reshape(total // mp, mp))


def rank_device(backend: str, device, local_rank: int, local_n: int) -> torch.device:
    """The device of the rank ``local_rank`` of ``local_n`` on this host."""
    if backend not in BACKENDS:
        raise ValueError(f"backends are {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl moves CUDA tensors only; CPU ranks take backend='gloo'")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"ranks run on cpu or cuda, got {dev}")
    count = torch.cuda.device_count()
    if backend == "nccl" and local_n > count:
        raise ValueError(f"nccl takes one GPU a rank: {local_n} ranks on a host with {count} "
                         f"GPU(s); pass backend='gloo' to let ranks share a GPU")
    if count == 0:
        raise RuntimeError("no CUDA device; pass device='cpu' for a CPU run")
    return torch.device("cuda", local_rank % count)


def init_node_group(backend: str, *, rank: Optional[int] = None, n: Optional[int] = None,
                    init_method: Optional[str] = None, device="cuda",
                    timeout_s: Optional[float] = None) -> NodeGroup:
    """Join the process group as node ``rank`` of ``n`` at ``init_method``;
    with no ``rank``, from torchrun's environment.  ``timeout_s`` bounds
    every collective (the backend's default when None)."""
    import torch.distributed as dist

    if rank is None:
        rank, n, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    if n is None or not 0 <= rank < n:
        raise ValueError(f"rank {rank} of {n} ranks")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    dev = rank_device(backend, device, local_rank, local_n)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n, **kwargs)
    return NodeGroup(rank=rank, n=n, device=dev, backend=backend)


def _rank_main(rank: int, n: int, backend: str, device, init_method: str,
               timeout_s: Optional[float], results, fn: Callable, args: tuple) -> None:
    """A spawned rank: join the group, run ``fn(group, *args)``, hand back
    its result."""
    group = init_node_group(backend, rank=rank, n=n, init_method=init_method, device=device,
                            timeout_s=timeout_s)
    if group.device.type == "cpu":
        torch.set_num_threads(1)       # n ranks share the host's cores
    out = fn(group, *args)
    group.close()
    results.put((rank, out))


def spawn_ranks(fn: Callable, n: int, backend: str, *args: Any, device="cuda",
                timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(group, *args)`` in ``n`` new processes, one a rank (``fn``
    and its arguments are pickled, so ``fn`` is a module-level function), and
    return their results in rank order.  CPU ranks run one thread each.  If
    any rank fails, the others are stopped and the failure is raised."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = mp.start_processes(_rank_main, nprocs=n, join=False, start_method="spawn",
                                   args=(n, backend, device, init, timeout_s, results, fn,
                                         args))
        done = False
        while not done:
            # drain while joining: a rank's result may not fit the pipe
            try:
                rank, res = results.get(timeout=0.05)
                out[rank] = res
            except queue.Empty:
                pass
            done = procs.join(timeout=0.05)
        while len(out) < n:
            rank, res = results.get(timeout=60)
            out[rank] = res
    return [out[r] for r in range(n)]
