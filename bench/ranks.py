"""A cell on ranks: one process a gossip node, each on a card of its own,
the program's rank runtime (``NodeGroup``, ``RankTransport``) over the
traffic's ``backend``, spawned by the program's own launcher
(``repro_torch.launch.mesh.spawn_ranks``).

Each rank sets up, drives the first steps and measures the window as a
stacked run does (:mod:`bench.harness`), every step ending in a
synchronize and a barrier and rank 0's clock deciding when the window
closes; then each rank frees its state and works its own node's reference
out again, the nodes gathering each other's parameters through
``torch.distributed``.  Rank 0 returns the result: the losses, norms and
bytes are the group's, the peak memory the fullest card's, the device's busy
seconds the ranks' mean, the breakdown rank 0's.  Each rank also reports
the modules of JAX or of ``repro`` it holds once its window has closed.
"""
from __future__ import annotations

import os
import pathlib
import time

import torch

from repro_torch.kernels import build
from repro_torch.launch.mesh import spawn_ranks

from bench import cells, harness
from bench.run import forbidden_modules

RANK_TIMEOUT_S = 600


def _backend(cell: cells.Cell, device) -> str:
    return cell.traffic["backend"] if torch.device(device).type == "cuda" else "gloo"


def _prepare(device) -> None:
    """Build the kernels once here, so the ranks load them; NCCL's
    bootstrap stays on the loopback interface (one host)."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if torch.device(device).type == "cuda":
        for name in build.SIGNATURES:
            build.compile_library(name)


def run(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool,
        started: float, device="cuda") -> dict:
    """One run of the rank cell ``workload``; the result object, its
    ``loaded`` the modules of JAX or of ``repro`` that any rank held once
    its window had closed."""
    cell = cells.find(root, workload)
    _prepare(device)
    outs = spawn_ranks(_rank_run, cell.traffic["n_nodes"], _backend(cell, device), str(root),
                       workload, seed, seconds, trace, started, device=device,
                       timeout_s=RANK_TIMEOUT_S)
    result = outs[0]
    result["loaded"] = sorted(set().union(*(out["loaded"] for out in outs)))
    return result


def _rank_run(group, root, workload, seed, seconds, trace, started):
    cell = cells.find(pathlib.Path(root), workload)
    cuda = group.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(group.device)
    prog = harness.Program(cell, seed, None, group)
    got = harness.first_steps(prog, cell, seed)
    setup_s = time.perf_counter() - started
    win = harness.window(prog, seconds, spans=trace)
    prof = harness.profile_steps(prog, harness.PROFILED_STEPS) if trace else None
    peak = prog.total([torch.cuda.max_memory_allocated(group.device) if cuda else 0], "max")[0]
    shapes = [tuple(leaf.shape) for _, leaf in prog.leaves()]
    win["sent_bytes"] = prog.total([win["sent_bytes"]])[0]
    if prof is not None:
        prof["busy_s"] = prog.total([prof["busy_s"]])[0] / group.n
    harness.free(prog)
    verdict = harness.judge(cell, seed, got, group.device, group.rank, prog.total)
    loaded = forbidden_modules()
    if group.rank != 0:
        return {"loaded": loaded}
    return {**harness.result(pathlib.Path(root), cell, win, prof, shapes, setup_s, peak, verdict,
                             group.device, group.n), "loaded": loaded}


def readings(root: pathlib.Path, workload: str, seeds, faulty: int, device="cuda",
             names=None) -> list:
    """:func:`bench.calibrate.readings` of a rank cell, every rank reading in
    one spawn; rank 0's list."""
    cell = cells.find(root, workload)
    _prepare(device)
    outs = spawn_ranks(_rank_readings, cell.traffic["n_nodes"], _backend(cell, device),
                       str(root), workload, list(seeds), faulty, names, device=device,
                       timeout_s=RANK_TIMEOUT_S)
    return outs[0]


def _rank_readings(group, root, workload, seeds, faulty, names):
    from bench import calibrate

    out = list(calibrate.readings(pathlib.Path(root), workload, seeds, faulty, group.device,
                                  names, group))
    return out if group.rank == 0 else None
