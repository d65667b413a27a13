"""Decentralized training entry point.

The port of the JAX package's ``launch/train.py``: the same ``TrainConfig``
fields and defaults and the same phase loop, checkpoints and edge drops.
The stacked node axis lives on one device — the GPU unless ``device="cpu"``
— and every gossip payload rides the port's kernels.

    python -m repro_torch.launch.train --algo dcd --wire quant:4 --steps 20
    python -m repro_torch.launch.train --algo choco --wire sign --steps 20
    python -m repro_torch.launch.train --algo dcd --wire lowrank:2:warm --steps 20
    python -m repro_torch.launch.train --algo dpsgd --topology chain --steps 20
    python -m repro_torch.launch.train --algo naive --wire quant:4 --drop-rate 0.1
    python -m repro_torch.launch.train --algo dcd --topology full_logn --steps 20
    python -m repro_torch.launch.train --algo dcd \
        --phase-plan "0@ring@quant:8;150@full_logn@quant:4"
    python -m repro_torch.launch.train --algo dcd --ckpt-dir ckpt --ckpt-every 50
    python -m repro_torch.launch.train --ranks 4 --backend gloo --algo dcd --wire quant:4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --backend nccl --algo dcd

``--algo`` is any of cpsgd, dpsgd, naive, dcd, ecd, choco and deepsqueeze;
``--topology`` any name of
:data:`~repro_torch.distributed.gossip.GOSSIP_TOPOLOGIES`.  ``--phase-plan``
(:class:`~repro_torch.netsim.controller.PhasePlan`) overrides ``--wire`` and
``--topology`` with a step-indexed schedule: the step is rebuilt at each
boundary and the aux trees resync to the new plan and wire
(:func:`~repro_torch.distributed.decentralized.rekey_dist_state`).
``--ckpt-dir`` resumes from the directory's latest checkpoint and, with
``--ckpt-every``, saves there.

Ranks: with a :class:`~repro_torch.launch.mesh.NodeGroup` (``group=``),
each process runs one node on its own device and draws its own shard,
``sample_batch(dc, t, shard=rank)``; the nodes exchange only encoded wire
containers (:mod:`~repro_torch.distributed.transport`).  ``--ranks N
--backend gloo|nccl`` spawns ``N`` such processes (``n_nodes`` becomes
``N``) after building the CUDA kernels once; under ``torchrun`` every
process is a rank (``--backend`` still names the backend).  On a machine
with one GPU the ranks share it over ``gloo``: ``nccl`` refuses two ranks on
one GPU.  Rank 0 prints the history the stacked run prints; a checkpoint is
one file, gathered by rank 0, that the stacked run reads too.

Where the port differs from the JAX driver on purpose: the JAX driver jits
each phase's step and guards against retraces (a step that compiles more
than once a segment raises); the port runs eagerly, compiles nothing, and
has no such guard.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import trace
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, sample_batch, stacked_node_batches
from repro_torch.distributed.decentralized import (
    init_dist_state,
    make_dist_train_step,
    rekey_dist_state,
)
from repro_torch.distributed.failures import make_drop_spec
from repro_torch.distributed.gossip import make_gossip_plan
from repro_torch.distributed.wire import make_wire_format
from repro_torch.kernels import build
from repro_torch.launch.mesh import BACKENDS, NodeGroup, init_node_group, spawn_ranks
from repro_torch.models.api import build_model
from repro_torch.netsim.controller import Phase, PhasePlan
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import linear_warmup_cosine


@dataclasses.dataclass
class TrainConfig:
    arch: Optional[str] = None          # assigned arch id, or None for custom cfg
    algo: str = "dcd"                   # cpsgd | dpsgd | naive | dcd | ecd | choco | deepsqueeze
    wire: str = "quant:8"               # gossip wire-format spec (make_wire_format)
    gamma: float = 0.5                  # CHOCO consensus stepsize, in (0, 1]
    topology: str = "ring"              # gossip plan name (make_gossip_plan)
    phase_plan: Optional[str] = None    # "start@topology@wire;..." overrides wire+topology
    n_nodes: int = 8
    seq_len: int = 256
    global_batch: int = 32
    steps: int = 300
    lr: float = 3e-3
    warmup: int = 20
    optimizer: str = "adamw"
    drop_rate: float = 0.0              # per-edge gossip drop probability (0 = reliable)
    drop_salt: int = 0                  # stream salt for the deterministic drop mask
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 10
    reduced: bool = True                # use the reduced config (CPU-scale)


GOSSIP_ALGOS = ("naive", "dcd", "ecd", "choco", "deepsqueeze")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg: ArchConfig, tc: TrainConfig, *, device="cuda",
                 group: Optional[NodeGroup] = None) -> Dict[str, Any]:
    """Train ``cfg`` for ``tc.steps`` steps (from the latest checkpoint of
    ``tc.ckpt_dir`` when there is one); returns the history: logged
    ``step``/``loss``/``consensus``, the ``phases`` of the plan, per-step
    ``losses`` and host-clock ``step_s`` of the steps this run took (each
    ends in a device synchronize), ``wall_s``, ``final_loss``, and the final
    ``state`` (a :class:`~repro_torch.distributed.decentralized.DistState`).
    With ``group`` (``tc.n_nodes`` ranks) this process is node
    ``group.rank`` on ``group.device``: the state is its node's slice, the
    losses every node's, and ``transport`` what the rank sent
    (:class:`~repro_torch.distributed.transport.TransportStats`) and, with
    tracing on (:mod:`repro_torch.trace`), the host seconds of its
    ``transport.<label>`` spans by label under ``seconds``.  With tracing
    on, the spans the run recorded are collected into ``spans``."""
    device = torch.device(device) if group is None else group.device
    say = print if group is None or group.rank == 0 else (lambda *a, **k: None)
    model = build_model(cfg)
    opt = make_optimizer(tc.optimizer, **({"weight_decay": 0.01} if tc.optimizer == "adamw" else {}))
    sched = linear_warmup_cosine(tc.lr, tc.warmup, tc.steps)
    drop = make_drop_spec(tc.drop_rate, salt=tc.drop_salt)

    # one static {topology, wire} is a one-phase plan
    pplan = PhasePlan.parse(tc.phase_plan) if tc.phase_plan \
        else PhasePlan((Phase(0, tc.topology, tc.wire),))

    def wire_of(phase: Phase):
        return make_wire_format(phase.wire) if tc.algo in GOSSIP_ALGOS else None

    start = 0
    resume_step = latest_step(tc.ckpt_dir) if tc.ckpt_dir else None
    # a checkpoint at step s was written under the phase that governs step
    # s - 1: the restore template takes that phase's aux keys
    init_phase = pplan.phase_at(max(0, (resume_step or 0) - 1))
    params0 = model.init(tc.seed, device=device)
    state = init_dist_state(tc.algo, params0, make_gossip_plan(init_phase.topology, tc.n_nodes),
                            opt, drop=drop, wire=wire_of(init_phase), group=group)
    del params0
    if resume_step is not None:
        state, manifest = restore(tc.ckpt_dir, state, resume_step,
                                  node=None if group is None else group.rank)
        start = manifest["step"]
        say(f"resumed from step {start}", flush=True)

    dc = DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len, global_batch=tc.global_batch,
                    n_shards=tc.n_nodes, seed=tc.seed)
    hist: Dict[str, Any] = {"step": [], "loss": [], "consensus": [], "phases": pplan.records(),
                            "losses": [], "step_s": []}
    _sync(device)
    t0 = time.perf_counter()
    for seg_start, seg_stop, phase in pplan.segments(tc.steps):
        if seg_stop <= start:
            continue
        plan, wire = make_gossip_plan(phase.topology, tc.n_nodes), wire_of(phase)
        if 0 < seg_start and seg_start >= start:
            # phase boundary: resync the aux to the new plan and wire (a
            # function of the params, so a resume at the boundary equals the
            # run through it)
            state = rekey_dist_state(state, tc.algo, plan, drop=drop, wire=wire, group=group)
            say(f"phase switch @ step {seg_start}: topology={phase.topology} "
                  f"wire={phase.wire}", flush=True)
        step_fn = make_dist_train_step(model.loss, tc.algo, opt, wire, plan, sched,
                                       gamma=tc.gamma, drop=drop, group=group)
        for t in range(max(seg_start, start), seg_stop):
            ts = time.perf_counter()
            if group is None:
                batch = stacked_node_batches(dc, t, cfg, device=device)
            else:
                batch = {k: v.unsqueeze(0) for k, v in
                         sample_batch(dc, t, group.rank, cfg, device=device).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            _sync(device)
            if group is not None:
                group.barrier()
            hist["step_s"].append(time.perf_counter() - ts)
            hist["losses"].append(loss)
            if (t + 1) % tc.log_every == 0 or t == tc.steps - 1:
                consensus = float(metrics["consensus"])
                hist["step"].append(t + 1)
                hist["loss"].append(loss)
                hist["consensus"].append(consensus)
                say(f"step {t+1:5d} loss={loss:.4f} consensus={consensus:.3e} "
                      f"lr={metrics['lr']:.2e}", flush=True)
            if tc.ckpt_dir and (t + 1) % tc.ckpt_every == 0:
                save(tc.ckpt_dir, t + 1, state, metadata={"loss": loss}, group=group)
    hist["wall_s"] = time.perf_counter() - t0
    hist["final_loss"] = hist["losses"][-1] if hist["losses"] else None
    if trace.enabled():
        hist["spans"] = trace.collect()
    if group is not None:
        st = group.stats
        hist["transport"] = {"sent": dict(st.sent),
                             "dtypes": {k: sorted(v) for k, v in st.dtypes.items()}}
        if "spans" in hist:
            hist["transport"]["seconds"] = trace.seconds_by_name(hist["spans"], "transport.")
    hist["state"] = state
    return hist


def _train_rank(group: NodeGroup, cfg: ArchConfig, tcs: Sequence[TrainConfig]) -> List[dict]:
    """One spawned rank: each run of ``tcs`` in turn; its histories without
    the state."""
    out = []
    for tc in tcs:
        group.stats.reset()
        hist = run_training(cfg, tc, group=group)
        del hist["state"]
        out.append(hist)
    return out


def spawn_training(cfg: ArchConfig, tcs: Sequence[TrainConfig], backend: str, *,
                   device="cuda", timeout_s: Optional[float] = None) -> List[List[dict]]:
    """Run each of ``tcs`` in turn on ``tcs[0].n_nodes`` spawned ranks, one a
    node (:func:`~repro_torch.launch.mesh.spawn_ranks`); returns, per run,
    every rank's history without its state.  The CUDA kernels are built
    here first, so the ranks load them and none runs ``nvcc``."""
    ranks = tcs[0].n_nodes
    if any(tc.n_nodes != ranks for tc in tcs):
        raise ValueError("the runs of one spawn share their node count")
    if torch.device(device).type == "cuda":
        for name in build.SIGNATURES:
            build.compile_library(name)
    per_rank = spawn_ranks(_train_rank, ranks, backend, cfg, list(tcs), device=device,
                           timeout_s=timeout_s)
    return [[runs[i] for runs in per_rank] for i in range(len(tcs))]


def main():
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        flag = f"--{f.name.replace('_', '-')}"
        if f.type in ("int", int):
            ap.add_argument(flag, type=int, default=f.default)
        elif f.type in ("float", float):
            ap.add_argument(flag, type=float, default=f.default)
        elif f.type in ("bool", bool):
            ap.add_argument(flag, action="store_true", default=f.default)
        else:
            ap.add_argument(flag, default=f.default)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="spawn one process a node (sets --n-nodes); 0: stacked on one device")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="the ranks' torch.distributed backend (with --ranks or torchrun)")
    args = ap.parse_args()
    tc = TrainConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)})
    cfg = get_config(tc.arch or "granite-3-2b")
    if tc.reduced:
        cfg = cfg.reduced()
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if (args.ranks or torchrun) and args.backend is None:
        ap.error("a rank run needs --backend gloo or --backend nccl")
    if torchrun:
        group = init_node_group(args.backend, device=args.device)
        hist = run_training(cfg, dataclasses.replace(tc, n_nodes=group.n), group=group)
        group.close()
        if group.rank != 0:
            return
    elif args.ranks:
        hist = spawn_training(cfg, [dataclasses.replace(tc, n_nodes=args.ranks)], args.backend,
                              device=args.device)[0][0]
    else:
        hist = run_training(cfg, tc, device=args.device)
    print(json.dumps({k: v for k, v in hist.items() if isinstance(v, (int, float))}, indent=2))


if __name__ == "__main__":
    main()
