"""Decentralized training entry point (single phase).

The port of the JAX package's ``launch/train.py``: the same ``TrainConfig``
fields and defaults, one static {topology, wire} for the whole run.  The
stacked node axis lives on one device — the GPU unless ``device="cpu"`` —
and every gossip payload rides the port's kernels.

    python -m repro_torch.launch.train --algo dcd --wire quant:4 --steps 20
    python -m repro_torch.launch.train --algo choco --wire sign --steps 20
    python -m repro_torch.launch.train --algo dcd --wire lowrank:2:warm --steps 20
    python -m repro_torch.launch.train --algo choco --steps 20 \
        --wire adaptive:4096:small=fp16:large=lowrank:2:leaf.embed=quant:4

Not ported yet (the flags exist and raise when set): checkpoints
(``--ckpt-dir``), phase plans (``--phase-plan``) and edge drops
(``--drop-rate``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, stacked_node_batches
from repro_torch.distributed.decentralized import init_dist_state, make_dist_train_step
from repro_torch.distributed.gossip import make_gossip_plan
from repro_torch.distributed.wire import make_wire_format
from repro_torch.models.api import build_model
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import linear_warmup_cosine


@dataclasses.dataclass
class TrainConfig:
    arch: Optional[str] = None          # assigned arch id, or None for custom cfg
    algo: str = "dcd"                   # dcd | ecd | choco | deepsqueeze
    wire: str = "quant:8"               # gossip wire-format spec (make_wire_format)
    gamma: float = 0.5                  # CHOCO consensus stepsize
    topology: str = "ring"              # gossip plan name (make_gossip_plan)
    phase_plan: Optional[str] = None    # not ported
    n_nodes: int = 8
    seq_len: int = 256
    global_batch: int = 32
    steps: int = 300
    lr: float = 3e-3
    warmup: int = 20
    optimizer: str = "adamw"
    drop_rate: float = 0.0              # not ported: must stay 0
    drop_salt: int = 0
    seed: int = 0
    ckpt_dir: Optional[str] = None      # not ported
    ckpt_every: int = 100
    log_every: int = 10
    reduced: bool = True                # use the reduced config (CPU-scale)


def _check_ported(tc: TrainConfig) -> None:
    if tc.phase_plan:
        raise NotImplementedError("--phase-plan is not ported yet")
    if tc.drop_rate:
        raise NotImplementedError("--drop-rate is not ported yet")
    if tc.ckpt_dir:
        raise NotImplementedError("--ckpt-dir (checkpoints) is not ported yet")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg: ArchConfig, tc: TrainConfig, *, device="cuda") -> Dict[str, Any]:
    """Train ``cfg`` for ``tc.steps`` steps; returns the history: logged
    ``step``/``loss``/``consensus``, per-step ``losses`` and host-clock
    ``step_s`` (each step ends in a device synchronize), ``wall_s``,
    ``final_loss``, and the final ``state`` (a
    :class:`~repro_torch.distributed.decentralized.DistState`)."""
    _check_ported(tc)
    device = torch.device(device)
    model = build_model(cfg)
    opt = make_optimizer(tc.optimizer, **({"weight_decay": 0.01} if tc.optimizer == "adamw" else {}))
    sched = linear_warmup_cosine(tc.lr, tc.warmup, tc.steps)
    plan = make_gossip_plan(tc.topology, tc.n_nodes)
    wire = make_wire_format(tc.wire)
    step_fn = make_dist_train_step(model.loss, tc.algo, opt, wire, plan, sched, gamma=tc.gamma)
    params0 = model.init(tc.seed, device=device)
    state = init_dist_state(tc.algo, params0, plan, opt, wire=wire)
    del params0
    dc = DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len, global_batch=tc.global_batch,
                    n_shards=tc.n_nodes, seed=tc.seed)
    hist: Dict[str, Any] = {"step": [], "loss": [], "consensus": [], "losses": [], "step_s": []}
    _sync(device)
    t0 = time.perf_counter()
    for t in range(tc.steps):
        ts = time.perf_counter()
        batch = stacked_node_batches(dc, t, device=device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        _sync(device)
        hist["step_s"].append(time.perf_counter() - ts)
        hist["losses"].append(loss)
        if (t + 1) % tc.log_every == 0 or t == tc.steps - 1:
            consensus = float(metrics["consensus"])
            hist["step"].append(t + 1)
            hist["loss"].append(loss)
            hist["consensus"].append(consensus)
            print(f"step {t+1:5d} loss={loss:.4f} consensus={consensus:.3e} "
                  f"lr={metrics['lr']:.2e}", flush=True)
    hist["wall_s"] = time.perf_counter() - t0
    hist["final_loss"] = hist["losses"][-1]
    hist["state"] = state
    return hist


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
    args = ap.parse_args()
    tc = TrainConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)})
    cfg = get_config(tc.arch or "granite-3-2b")
    if tc.reduced:
        cfg = cfg.reduced()
    hist = run_training(cfg, tc, device=args.device)
    print(json.dumps({k: v for k, v in hist.items() if isinstance(v, (int, float))}, indent=2))


if __name__ == "__main__":
    main()
