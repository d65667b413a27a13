"""One run of a training cell: the program's step, timed, traced and judged.

Set-up builds what ``repro_torch.launch.train.run_training`` builds for the
cell's traffic (the model, AdamW, the warm-up cosine schedule, the gossip
plan, the wire, ``init_dist_state`` and ``make_dist_train_step``) over
parameters the benchmark makes from the seed, then drives that step through
its first :data:`CHECK_STEPS` steps, each fed by the program's data
pipeline (``stacked_node_batches``; ``sample_batch`` on ranks), as the
window feeds it.  Those steps
are the ones the reference follows; they also warm up every shape.

The window then runs whole steps, batch included, each ending in a
synchronize, until ``seconds`` have passed.  With ``trace`` the window
closes each batch call with a synchronize of its own (the data span), and
:data:`PROFILED_STEPS` more steps run under ``torch.profiler``.

After the window: the peak memory is read, the program's state freed, and
the reference (:mod:`bench.reference.train`) works the first steps out
again from the seed; :mod:`bench.compare` judges the program's record.
"""
from __future__ import annotations

import gc
import heapq
import math
import pathlib
import time
from typing import Dict, List, Optional, get_args, get_type_hints

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, sample_batch, stacked_node_batches
from repro_torch.distributed.decentralized import (
    WIRE_ALGOS,
    init_dist_state,
    make_dist_train_step,
)
from repro_torch.distributed.gossip import make_gossip_plan
from repro_torch.distributed.wire import make_wire_format
from repro_torch.models.api import build_model
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.tree import leaf_items

from bench import cells, compare, families, weights, yardstick
from bench.cells import Cell
from bench.reference import train as reference

CHECK_STEPS = 3
PROFILED_STEPS = 2
ADAM_B1 = 0.9      # the first moment's decay of the program's AdamW
SPANS = ("bench.data", "bench.step")
GOSSIP_LABELS = ("wire", "dense")   # the transport's labels of the gossip exchange


def arch_config(cell: Cell) -> ArchConfig:
    """The program's configuration of the cell: the common fields, and the
    family's (``bench/families/<family>.py`` ``arch``), each nested dict as
    the spec class of its ``ArchConfig`` field."""
    c = cell.config
    hints = get_type_hints(ArchConfig)
    extra = {}
    for field, value in families.of(c).arch(c).items():
        if isinstance(value, dict):
            spec = next(t for t in get_args(hints[field]) if t is not type(None))
            value = spec(**{k: tuple(v) if isinstance(v, list) else v for k, v in value.items()})
        extra[field] = value
    return ArchConfig(name=cell.config_name, family=c["family"], n_layers=c["n_layers"],
                      d_model=c["d_model"], n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
                      d_ff=c["d_ff"], vocab=c["vocab"], rope_theta=c.get("rope_theta", 1e4),
                      **extra)


class Program:
    """The program's training step and state for one cell and seed: every
    node stacked on ``device``, or, with ``group`` (a
    :class:`~repro_torch.launch.mesh.NodeGroup`), this rank's node."""

    def __init__(self, cell: Cell, seed: int, device, group=None):
        tr = cell.traffic
        if tr["drop_rate"]:
            raise ValueError("the benchmark's reference runs reliable gossip: drop_rate 0")
        self.device = torch.device(device) if group is None else group.device
        self.group = group
        self.arch = arch_config(cell)
        model = build_model(self.arch)
        opt = make_optimizer(tr["optimizer"], weight_decay=tr["weight_decay"])
        plan = make_gossip_plan(tr["topology"], tr["n_nodes"])
        self.degree = len(plan.shift_list)
        wire = make_wire_format(tr["wire"]) if tr["algo"] in WIRE_ALGOS else None
        params0 = weights.make(cell.config, seed, self.device)
        self.state = init_dist_state(tr["algo"], params0, plan, opt, wire=wire, group=group)
        del params0
        self.step_fn = make_dist_train_step(
            model.loss, tr["algo"], opt, wire, plan,
            linear_warmup_cosine(tr["lr"], tr["warmup"], tr["total_steps"]), gamma=tr["gamma"],
            group=group)
        self.data = DataConfig(vocab=self.arch.vocab, seq_len=tr["seq_len"],
                               global_batch=tr["global_batch"], n_shards=tr["n_nodes"], seed=seed)
        self.t = 0

    @property
    def rank(self):
        return None if self.group is None else self.group.rank

    def batch(self) -> Dict[str, torch.Tensor]:
        """This step's batch as ``run_training`` draws it."""
        if self.group is None:
            return stacked_node_batches(self.data, self.t, self.arch, device=self.device)
        return {k: v.unsqueeze(0) for k, v in
                sample_batch(self.data, self.t, self.group.rank, self.arch,
                             device=self.device).items()}

    def step(self, batch) -> float:
        """One step on ``batch``; its loss, after the device (and, on ranks,
        every rank) finished."""
        self.state, met = self.step_fn(self.state, batch)
        loss = float(met["loss"])
        _sync(self.device)
        if self.group is not None:
            self.group.barrier()
        self.t += 1
        return loss

    def sent(self, labels=None) -> int:
        """Bytes this process handed its transport, of ``labels`` or all."""
        sent = self.step_fn.transport.stats.sent
        return sum(v for k, v in sent.items() if labels is None or k in labels)

    def leaves(self):
        return leaf_items(self.state.params)

    def total(self, values, op: str = "sum") -> list:
        """``values`` summed (or their maximum) over the ranks."""
        if self.group is None:
            return list(values)
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return t.tolist()

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop`` on every rank."""
        if self.group is None:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([1.0 if stop else 0.0], device=self.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_steps(prog: Program, cell: Cell, seed: int) -> dict:
    """Drive the first steps; the program's record of them: its batches (on
    ranks, this rank's), each step's loss over every node, and over every
    node per leaf the first gradient's norm and the parameters' change, and
    the gossip bytes (on ranks, the ranks' over the plan's degree: a rank
    sends its containers to each neighbour)."""
    rec = {"tokens": [], "labels": [], "losses": []}
    for _ in range(CHECK_STEPS):
        batch = prog.batch()
        rec["tokens"].append(batch["tokens"].clone())
        rec["labels"].append(batch["labels"].clone())
        rec["losses"].append(prog.step(batch))
        if "grad_norms" not in rec:
            # AdamW's first moment after one step is (1 - b1) * gradient
            items = leaf_items(prog.state.opt.m)
            squares = prog.total([float(m.square().sum()) for _, m in items])
            rec["grad_norms"] = {p: sq ** 0.5 / (1 - ADAM_B1)
                                 for (p, _), sq in zip(items, squares)}
    gossip = prog.total([prog.sent(GOSSIP_LABELS)])[0]
    rec["sent_bytes"] = int(gossip if prog.group is None else gossip / prog.degree)
    prog.step_fn.transport.stats.reset()
    start = leaf_items(weights.make(cell.config, seed, prog.device))
    squares = prog.total([float((x - x0).square().sum())
                          for (_, x), (_, x0) in zip(prog.leaves(), start)])
    rec["change_norms"] = {p: sq ** 0.5 for (p, _), sq in zip(prog.leaves(), squares)}
    del start
    return rec


def window(prog: Program, seconds: float, spans: bool) -> dict:
    """Whole steps until ``seconds`` have passed (on rank 0's clock); with
    ``spans`` the host seconds of each batch call, closed by a
    synchronize."""
    losses, data_s, step_s = [], [], []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        batch = prog.batch()
        if spans:
            _sync(prog.device)
            data_s.append(time.perf_counter() - ts)
        losses.append(prog.step(batch))
        step_s.append(time.perf_counter() - ts)
        if prog.agree(time.perf_counter() - t0 >= seconds):
            break
    return {"steps": len(losses), "window_s": time.perf_counter() - t0, "losses": losses,
            "data_s": data_s, "step_s": step_s, "sent_bytes": prog.sent()}


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def profile_steps(prog: Program, steps: int) -> dict:
    """``steps`` steps under ``torch.profiler`` (host and device activity),
    summarized by :func:`trace_summary` from the profiler's raw events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    losses = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function(SPANS[0]):
                batch = prog.batch()
            with record_function(SPANS[1]):
                losses.append(prog.step(batch))
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), e.name()))
        elif kind == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    return {"steps": steps, "losses": losses, **trace_summary(host, device)}


def trace_summary(host, device) -> dict:
    """From ``(start_ns, end_ns, name)`` host and device events: the host
    window of the benchmark's spans, the device's busy seconds in it (the
    union of its operations), kernel launches, the wire kernels' seconds,
    the ten device operations that took most time, and the device's idle
    gaps summed by what the host was doing at each gap's middle (its
    innermost operation, in which of the benchmark's spans)."""
    spans = sorted(h for h in host if h[2] in SPANS)
    lo, hi = spans[0][0], max(end for _, end, _ in spans)
    # the host's annotations (the benchmark's spans, NCCL's collectives) are
    # marked on the device's timeline too, under the same names: no work
    marked = {name for _, _, name in host}
    dev = sorted(d for d in device if d[1] > d[0] and d[2] not in marked)
    merged: List[List[int]] = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    by_op: Dict[str, int] = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0) + (e - s)
    edges = [lo] + [min(max(x, lo), hi) for iv in merged for x in iv] + [hi]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    ops = sorted(h for h in host if h[2] not in SPANS)
    idle: Dict[str, int] = {}
    for (g0, g1), what in zip(gaps, _host_during(ops, spans, [(a + b) // 2 for a, b in gaps])):
        idle[what] = idle.get(what, 0) + (g1 - g0)

    def top(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "busy_s": sum(min(e, hi) - max(s, lo) for s, e in merged if e > lo and s < hi) / 1e9,
        "window_s": (hi - lo) / 1e9,
        "launches": sum(1 for _, _, name in dev if _is_kernel(name)),
        "wire_s": sum(v for k, v in by_op.items()
                      if any(sym in k for sym in yardstick.WIRE_KERNEL_SYMBOLS)) / 1e9,
        "device_ops": top({name[:96]: v for name, v in by_op.items()}),
        "idle_gaps": top(idle),
    }


def _host_during(ops, spans, times) -> List[str]:
    """``<span>: <op>`` at each of the ascending ``times``: the host
    operation that started last among those running (``python`` when none
    runs), and the benchmark's span around it."""
    out, running, j = [], [], 0
    for t in times:
        while j < len(ops) and ops[j][0] <= t:
            heapq.heappush(running, (-ops[j][0], ops[j][1], ops[j][2]))
            j += 1
        while running and running[0][1] < t:
            heapq.heappop(running)
        span = next((name for s, e, name in spans if s <= t <= e), "outside")
        out.append(f"{span}: {running[0][2] if running else 'python'}")
    return out


def free(prog: Program) -> None:
    prog.state = prog.step_fn = None
    gc.collect()
    if prog.device.type == "cuda":
        torch.cuda.empty_cache()


def judge(cell: Cell, seed: int, got: dict, device, rank=None, total=list) -> tuple:
    """Work the first steps out again from the seed and judge ``got``; on
    ranks (``rank``, with ``total`` summing over them) each rank's batches,
    the rest over every node."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params0 = weights.make(cell.config, seed, device)
    want = reference.run(cell.config, cell.traffic, seed, params0, CHECK_STEPS, device,
                         node=rank)
    return compare.verdict(numbers(got, want, total), cell.limits)


def numbers(got: dict, want: dict, total=list) -> dict:
    """:func:`bench.compare.numbers`, the tokens that differ summed over the
    ranks with ``total``."""
    found = compare.numbers(got, want)
    found["token_mismatches"] = int(total([found["token_mismatches"]])[0])
    return found


def record(cell: Cell, win: dict, prof: Optional[dict], leaf_shapes) -> dict:
    """What the metric readers read."""
    tr = cell.traffic
    tokens = tr["global_batch"] * tr["seq_len"]
    return {
        "steps": win["steps"], "window_s": win["window_s"], "tokens_per_step": tokens,
        "nodes": tr["n_nodes"], "chips": cell.chips, "data_s": win["data_s"],
        "sent_bytes": win["sent_bytes"], "step_s": win["step_s"],
        "flops_per_step": yardstick.model_flops_per_token(cell.config, tr["seq_len"]) * tokens,
        "wire_bound_s": yardstick.bound_seconds(*yardstick.wire_kernel_work(leaf_shapes, tr)),
        "profile": prof, "peaks": yardstick.PEAKS,
    }


def result(root: pathlib.Path, cell: Cell, win: dict, prof: Optional[dict], shapes,
           setup_s: float, peak: int, verdict: tuple, device, count: int) -> dict:
    """The run's result object (see ``bench/run.py``): the cell's end-to-end
    metrics, or with a profile ``prof`` its per-layer ones, read from
    :func:`record`."""
    ok, checks = verdict
    losses = win["losses"] + (prof["losses"] if prof else [])
    failed = sum(1 for x in losses if not math.isfinite(x))
    rec = record(cell, win, prof, shapes)
    rec.update(setup_s=setup_s, peak_bytes=peak)
    metrics = cells.read_metrics(root, cell.end_to_end if prof is None else cell.per_layer, rec)
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": count, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok and failed == 0), "attempted": len(losses), "failed": failed,
           "metrics": metrics, "device": dev}
    if prof is not None:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["step_s"] = win["step_s"]
    out["checks"] = checks
    return out
