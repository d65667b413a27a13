"""Dryrun: every (arch x shape) built on the meta device under its
production plan, with the H100 roofline; and an executed smoke.

    python -m repro_torch.launch.dryrun --arch mistral-large-123b --shape train_4k \\
        --json records.jsonl
    python -m repro_torch.launch.dryrun --smoke [--device cpu]

The port of the JAX package's ``launch/dryrun.py``.  Where JAX lowers and
compiles the sharded step on a forced 256- or 512-device host mesh, the
port builds the step's state, batch, params and caches on
``torch.device("meta")`` (shapes and dtypes, no storage), runs the model's
loss and gradient (training) or prefill / decode step (serving) there under
the counters of :mod:`repro_torch.launch.analysis`, and sizes each device's
share from the placement rules (:mod:`repro_torch.distributed.sharding`)
over the logical layouts (:mod:`repro_torch.launch.mesh`).  Nothing is
allocated and no device is touched, so a record needs no card.  The wire
kernels are not run on the meta device (they would take the card's path):
their bytes are added from the kernels' byte counts (:func:`_wire_kernel_bytes`).

A record has the JAX record's keys wherever the quantity exists: the gossip,
wire, failure and controller fields, ``memory.argument_bytes`` (per device,
from the sharding arithmetic) and every ``Roofline.as_dict()`` key.  The
meta build's wall seconds stand under ``build_s`` (JAX: ``lower_s`` and
``compile_s``); ``temp_bytes``, ``alias_bytes``, ``xla_raw_flops`` and
``scan_factor`` are XLA's and ``None``.  ``analysis`` summarises the
containers one gossip round hands to the transport: their dtypes, and the
payloads the rank exchange's whitelist would refuse
(:func:`~repro_torch.analysis.step_checks.analysis_record`).

``--smoke`` builds the reduced config the same way and then executes 2
steps (``remat=True``, 2 nodes stacked on one device, the card unless
``--device cpu``), printing ``[SMOKE OK] {json}``.  Importing this module
has no side effect.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.decentralized import (
    REPLICA_ALGOS,
    WIRE_ALGOS,
    init_dist_state,
    make_dist_train_step,
)
from repro_torch.distributed.failures import make_drop_spec
from repro_torch.distributed.gossip import GOSSIP_TOPOLOGIES, as_schedule, make_gossip_plan
from repro_torch.distributed.plans import SERVE_PLANS, TRAIN_PLANS
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_items,
    cache_pspec,
    param_pspec,
    params_shardings,
    per_device_bytes,
    stack_depth,
)
from repro_torch.analysis.step_checks import analysis_record
from repro_torch.distributed.wire import (
    AdaptiveWire,
    leaf_path_str,
    make_wire_format,
    wire_spec,
)
from repro_torch.launch import analysis
from repro_torch.launch.mesh import derive_serve_mesh, derive_train_mesh, make_production_mesh
from repro_torch.launch.specs import (
    SHAPES,
    InputShape,
    decode_cache_specs,
    params_specs,
    prefill_input_specs,
    train_input_specs,
)
from repro_torch.models.api import build_model
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.tree import leaf_items, tree_leaves, tree_map


def _tree_size(tree) -> int:
    return sum(int(l.numel()) for l in tree_leaves(tree))


def _nonembed_params(cfg, p_sds) -> int:
    return sum(int(l.numel()) for p, l in leaf_items(p_sds)
               if "embed" not in p and "lm_head" not in p)


def _gossip_record(gossip, algo: str) -> Dict[str, Any]:
    """The gossip accounting fields.  ``gossip_payloads`` is the payload
    permutes the algorithm issues a step: DCD, ECD and CHOCO roll every delta
    once per union-shift aux tree (``replica_payloads``, the degree on flat
    plans); the others roll once per round shift (``degree``)."""
    payloads = gossip.replica_payloads if algo in REPLICA_ALGOS else gossip.degree
    return {"topology": gossip.name, "gossip_degree": gossip.degree,
            "gossip_rounds": getattr(gossip, "period", 1),
            "gossip_payloads": int(payloads)}


def _failure_record(codec, gossip, algo: str, p_sds, drop, straggler: float
                    ) -> Dict[str, Any]:
    """Netsim's failure figures: the expected delivered payloads under the
    drop rate, the comm-time tail and the epoch-time-vs-straggler curve of
    the low-precision decentralized strategy on the measured wire bits."""
    if drop is None and straggler == 0.0:
        return {}
    from repro_torch.netsim import (
        BEST_NETWORK, LinkModel, comm_time_tail, expected_payloads,
        straggler_curve, strategies_for,
    )
    rate = drop.rate if drop is not None else 0.0
    payloads = gossip.replica_payloads if algo in REPLICA_ALGOS else gossip.degree
    rec: Dict[str, Any] = {
        "drop_rate": rate,
        "drop_salt": drop.salt if drop is not None else 0,
        "expected_payloads": expected_payloads(float(payloads), rate),
    }
    if codec is not None:
        model_bytes = 4.0 * _tree_size(p_sds)
        strat = strategies_for(model_bytes, gossip.n, codec, plan=gossip,
                               drop_rate=rate)["decentralized_lp"]
        link = LinkModel.from_condition(BEST_NETWORK, straggler=straggler, drop_rate=rate)
        rec["comm_tail_s"] = comm_time_tail(strat, link, n_edges=gossip.degree)
        if straggler > 0.0:
            rec["straggler_curve"] = straggler_curve(
                strat, BEST_NETWORK, compute_s=0.0, iters_per_epoch=1,
                n_edges=gossip.degree,
                sigmas=(0.0, straggler / 2, straggler, 2 * straggler))
    return rec


def _wire_spec_per_leaf(codec, tree) -> Dict[str, str]:
    """Leaf path -> the canonical wire spec used for that leaf (under
    ``adaptive``, its routing decisions)."""
    if isinstance(codec, AdaptiveWire):
        return {path: wire_spec(w) for path, w in codec.leaf_wires(tree)}
    spec = wire_spec(codec)
    return {leaf_path_str(p): spec for p, _ in leaf_items(tree)}


def _controller_record(codec, gossip, algo: str, p_sds, drop, straggler: float,
                       total_steps: int = 1000) -> Dict[str, Any]:
    """What netsim's controller would pick for this run's link model."""
    if codec is None:
        return {}
    from repro_torch.netsim import BEST_NETWORK, LinkModel, plan_phases
    rate = drop.rate if drop is not None else 0.0
    link = LinkModel.from_condition(BEST_NETWORK, straggler=straggler, drop_rate=rate)
    pplan = plan_phases(4.0 * _tree_size(p_sds), gossip.n, link, total_steps=total_steps,
                        algo=algo)
    return {"controller": {"link": link.describe(), "total_steps": total_steps,
                           "phase_plan": pplan.describe(), "phases": pplan.records()}}


def _wire_record(codec, params) -> Dict[str, Any]:
    """The wire fields, from the containers the encoder builds on meta."""
    if codec is None:
        return {}
    payload_bytes = codec.wire_nbytes(params)
    return {"wire_payload_bytes": payload_bytes,
            "wire_bits_per_element": round(8.0 * payload_bytes / _tree_size(params), 4),
            "wire_format": codec.wire_format,
            "wire_spec_per_leaf": _wire_spec_per_leaf(codec, params)}


def _wire_kernel_bytes(codec, algo: str, params, aux_bytes: int, gossip) -> float:
    """Device-memory bytes of the wire kernels in one step, all nodes: each
    round a send (the f32 delta in, the payload out) and the receives, each
    the payload in and its accumulator in and out (``aux_bytes`` an element
    for replicas and estimates, 4 for params and DeepSqueeze's f32
    buffers).  The round's other elementwise work (mixing, the update) is
    not counted."""
    if codec is None:
        return 0.0
    n_elems = _tree_size(params)
    payload = float(codec.wire_nbytes(params))
    sched = as_schedule(gossip)
    rounds = 1 if sched.time_varying else sched.period
    union = len(sched.shift_union)
    shifts = sched.degree // max(len(sched.rounds), 1)
    send = 4.0 * n_elems + payload
    if algo in REPLICA_ALGOS:
        recv = (payload + 8.0 * n_elems) + union * (payload + 2.0 * aux_bytes * n_elems)
    elif algo == "deepsqueeze":
        recv = (2 + shifts) * (payload + 8.0 * n_elems)
    else:                                       # naive: dense decodes, self and shifts
        recv = (1 + shifts) * (payload + 4.0 * n_elems)
    return rounds * (send + recv)


def _state_bytes_per_device(state, mesh, n_routed) -> Tuple[int, int]:
    """(per-device bytes, whole bytes) of the state's tensors: params,
    optimizer moments and aux trees stacked over node (freshness vectors
    and other 1-D host vectors replicate)."""
    pairs = []
    trees = [state.params] + [t for t in (state.opt.m, state.opt.v) if t is not None] + \
        [t for t in state.aux.values()]
    for tree in trees:
        if isinstance(tree, torch.Tensor):          # a freshness vector: replicated
            pairs.append((tree, (None,) * tree.dim()))
            continue
        specs = dict(leaf_items(params_shardings(tree, mesh, node_axis=True,
                                                 n_routed=n_routed)))
        pairs += [(l, specs[p]) for p, l in leaf_items(tree)]
    return per_device_bytes(pairs, mesh), sum(l.numel() * l.element_size() for l, _ in pairs)


def _batch_bytes_per_device(batch, mesh, node_axis: bool) -> int:
    specs = dict(leaf_items(batch_shardings(batch, mesh, node_axis=node_axis)))
    return per_device_bytes([(l, specs[p]) for p, l in leaf_items(batch)], mesh)


def _loss_and_grad(model, remat: bool):
    """The per-node training work on meta: loss, then its gradient."""
    def run(params, batch):
        for l in tree_leaves(params):
            l.requires_grad_(True)
        loss, _ = model.loss(params, batch, remat=remat)
        loss.backward()
    return run


def depth_cut(cfg, k: int):
    """``(cfg with k repeats of its repeating unit, the full config's
    repeats)``: a layer of the main stack (after the dense first layers of
    a MoE), or a period of the hybrid (its tail kept); ``None`` for the
    encoder-decoder, counted whole."""
    if cfg.is_encdec:
        return None
    if cfg.hybrid_period:
        tail = cfg.n_layers % cfg.hybrid_period
        return (dataclasses.replace(cfg, n_layers=k * cfg.hybrid_period + tail),
                cfg.n_layers // cfg.hybrid_period)
    n_dense = len(cfg.moe.dense_layers) if cfg.moe and cfg.moe.dense_layers else 0
    return dataclasses.replace(cfg, n_layers=n_dense + k), cfg.n_layers - n_dense


def count_by_depth(cfg, count: Callable[[Any], Tuple[float, int]]) -> Tuple[float, int]:
    """``count(cfg)`` (FLOPs and bytes of a model built from ``cfg``), from
    the counts at 1 and 2 repeats of the repeating unit, so that the meta
    run dispatches a few layers' ops rather than ~100: every repeat adds the
    same work (as JAX's scan multiplies its body by the trip count), so
    ``c(R) = c(1) + (R - 1) * (c(2) - c(1))`` exactly."""
    cut = depth_cut(cfg, 1)
    if cut is None:
        return count(cfg)
    (f1, b1), (f2, b2) = count(cut[0]), count(depth_cut(cfg, 2)[0])
    r = cut[1] - 1
    return f1 + r * (f2 - f1), b1 + r * (b2 - b1)


def build_train_state(arch: str, shape_name: str, *, multi_pod: bool, algo: str = "dcd",
                      wire: str = "quant:8", topology: str = "ring", momentum: float = 0.0,
                      drop_rate: float = 0.0, drop_salt: int = 0) -> Dict[str, Any]:
    """The train dryrun's meta objects: config, plan, layouts, gossip plan,
    wire, drop spec, params, the node-stacked ``DistState`` (with the plan's
    ``aux_dtype``) and the batch."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    plan = TRAIN_PLANS[arch]
    n = plan.nodes_for(multi_pod)
    prod = make_production_mesh(multi_pod=multi_pod)
    gossip = make_gossip_plan(topology, n)
    codec = make_wire_format(wire) if algo in WIRE_ALGOS else None
    drop = make_drop_spec(drop_rate, salt=drop_salt)
    p_sds = params_specs(cfg)
    state = init_dist_state(algo, p_sds, gossip, sgd(momentum=momentum), drop=drop,
                            wire=codec, aux_dtype=plan.torch_aux_dtype)
    return dict(cfg=cfg, shape=shape, plan=plan, n=n, prod=prod,
                mesh=derive_train_mesh(prod, n, plan.tp), gossip=gossip, codec=codec,
                drop=drop, p_sds=p_sds, state=state,
                batch=train_input_specs(cfg, shape, n))


def dryrun_train(arch: str, shape_name: str, *, multi_pod: bool, algo: str = "dcd",
                 wire: str = "quant:8", topology: str = "ring", momentum: float = 0.0,
                 drop_rate: float = 0.0, drop_salt: int = 0, straggler: float = 0.0,
                 gamma: float = 0.5) -> Dict[str, Any]:
    """The train record of ``arch`` at ``shape_name`` under its plan
    (``gamma``, CHOCO's stepsize, changes no count)."""
    t0 = time.perf_counter()
    b = build_train_state(arch, shape_name, multi_pod=multi_pod, algo=algo, wire=wire,
                          topology=topology, momentum=momentum, drop_rate=drop_rate,
                          drop_salt=drop_salt)
    cfg, shape, plan, n, gossip, codec = (b[k] for k in ("cfg", "shape", "plan", "n",
                                                         "gossip", "codec"))
    state, mesh, p_sds = b["state"], b["mesh"], b["p_sds"]
    n_chips = b["prod"].size
    node_batch = {k: v[0] for k, v in b["batch"].items()}
    flops_node, bytes_node = count_by_depth(cfg, lambda c: analysis.count_fn(
        _loss_and_grad(build_model(c), plan.remat), params_specs(c), node_batch))
    aux_bytes = 2 if plan.aux_dtype == "bfloat16" else 4
    fields = shape_fields(b, algo, straggler)
    payloads = fields["gossip_payloads"]
    if codec is not None:
        payload_bytes = float(fields["wire_payload_bytes"])
    elif algo == "dpsgd":
        payload_bytes = 4.0 * _tree_size(state.params)       # the dense tree
    else:
        payload_bytes, payloads = 0.0, 0                     # cpsgd: below
    sched = as_schedule(gossip)
    coll_bytes, stats = analysis.gossip_collectives(
        payload_bytes, payloads, len(leaf_items(p_sds)), n_chips,
        tuple(sched.shift_union), n, n // 2 if multi_pod else None)
    if algo == "cpsgd":       # the node-mean all-reduce of the update
        total = 4.0 * _tree_size(state.params) / n_chips
        stats = analysis.CollectiveStats({"all-reduce": int(total)},
                                         {"all-reduce": len(leaf_items(p_sds))})
        coll_bytes = float(stats.total_bytes)
    hbm = n * bytes_node + _wire_kernel_bytes(codec, algo, state.params, aux_bytes, gossip)
    n_active = analysis.active_param_count(cfg, _nonembed_params(cfg, p_sds))
    roof = analysis.Roofline(
        flops_per_chip=n * flops_node / n_chips, hbm_bytes_per_chip=hbm / n_chips,
        collective_bytes_per_chip=coll_bytes, collectives=stats,
        model_flops_global=analysis.model_flops(cfg, shape, n_active), n_chips=n_chips)
    n_routed = cfg.moe.n_routed if cfg.moe else None
    state_dev, _ = _state_bytes_per_device(state, mesh, n_routed)
    arg_bytes = state_dev + _batch_bytes_per_device(b["batch"], mesh, node_axis=True)
    build_s = time.perf_counter() - t0
    return {
        "arch": arch, "shape": shape_name, "kind": "train", "algo": algo, "wire": wire,
        "multi_pod": multi_pod, "n_nodes": n, "n_chips": n_chips,
        "aux_dtype": plan.aux_dtype, "remat": plan.remat, **fields,
        "analysis": analysis_record(codec, state.params, payloads),
        "build_s": round(build_s, 3),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": state_dev,
                   "temp_bytes": None, "alias_bytes": None},
        **roof.as_dict(),
    }


def shape_fields(b: Dict[str, Any], algo: str, straggler: float = 0.0) -> Dict[str, Any]:
    """The train record's fields that follow from shapes and the plan
    alone, for the objects of :func:`build_train_state`: the gossip fields,
    ``params_total``, the wire fields, the failure and the controller
    records."""
    rec = {**_gossip_record(b["gossip"], algo), "params_total": _tree_size(b["p_sds"]),
           **_wire_record(b["codec"], b["state"].params)}
    rec.update(_failure_record(b["codec"], b["gossip"], algo, b["p_sds"], b["drop"],
                               straggler))
    rec.update(_controller_record(b["codec"], b["gossip"], algo, b["p_sds"], b["drop"],
                                  straggler))
    return rec


def _bf16_params(cfg) -> Any:
    """Serving weights: the parameter tree in bf16 on meta."""
    return tree_map(lambda l: torch.empty(l.shape, dtype=torch.bfloat16, device="meta"),
                    params_specs(cfg))


def dryrun_serve(arch: str, shape_name: str, *, multi_pod: bool) -> Dict[str, Any]:
    """The serve record: bf16 weights (sharded over dp too only when their
    mp shards would pass 8 GB a device), the prefill or one decode step."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    plan = SERVE_PLANS[arch]
    prod = make_production_mesh(multi_pod=multi_pod)
    mesh = derive_serve_mesh(prod, plan.mp)
    n_chips = prod.size
    p_sds = _bf16_params(cfg)
    param_bytes = sum(2 * l.numel() for l in tree_leaves(p_sds))
    dp_shard_weights = (param_bytes / plan.mp) > 8e9
    n_routed = cfg.moe.n_routed if cfg.moe else None
    args: List[Tuple[torch.Tensor, tuple]] = [
        (l, param_pspec(p, tuple(l.shape), mesh, node_axis=False, n_stack_axes=stack_depth(p),
                        n_routed=n_routed, use_fsdp=dp_shard_weights))
        for p, l in leaf_items(p_sds)]
    with torch.no_grad():
        if shape.kind == "prefill":
            batch = prefill_input_specs(cfg, shape)
            flops, nbytes = count_by_depth(cfg, lambda c: analysis.count_fn(
                build_model(c).prefill, _bf16_params(c), batch))
            specs = dict(leaf_items(batch_shardings(batch, mesh, node_axis=False)))
            args += [(l, specs[p]) for p, l in leaf_items(batch)]
            out_bytes = 0
        else:
            caches, tokens = decode_cache_specs(cfg, shape)
            cache_args = [(t, cache_pspec(p, tuple(t.shape), mesh, batch=shape.global_batch))
                          for p, t in cache_items(caches)]
            flops, nbytes = count_by_depth(cfg, lambda c: analysis.count_fn(
                build_model(c).decode_step, _bf16_params(c), decode_cache_specs(c, shape)[0],
                tokens))
            args += cache_args + [(tokens, batch_shardings(tokens, mesh, node_axis=False))]
            out_bytes = per_device_bytes(cache_args, mesh)
    n_active = analysis.active_param_count(cfg, _nonembed_params(cfg, p_sds))
    roof = analysis.Roofline(
        flops_per_chip=flops / n_chips, hbm_bytes_per_chip=nbytes / n_chips,
        collective_bytes_per_chip=0.0, collectives=analysis.CollectiveStats({}, {}),
        model_flops_global=analysis.model_flops(cfg, shape, n_active), n_chips=n_chips)
    return {
        "arch": arch, "shape": shape_name, "kind": shape.kind, "multi_pod": multi_pod,
        "mp": plan.mp, "n_chips": n_chips, "params_total": _tree_size(p_sds),
        "build_s": round(time.perf_counter() - t0, 3),
        "memory": {"argument_bytes": per_device_bytes(args, mesh), "output_bytes": out_bytes,
                   "temp_bytes": None, "alias_bytes": None},
        **roof.as_dict(),
    }


def dryrun(arch: str, shape_name: str, *, multi_pod: bool = False, algo: str = "dcd",
           wire: str = "quant:8", topology: str = "ring", drop_rate: float = 0.0,
           drop_salt: int = 0, straggler: float = 0.0, gamma: float = 0.5) -> Dict[str, Any]:
    if SHAPES[shape_name].kind == "train":
        return dryrun_train(arch, shape_name, multi_pod=multi_pod, algo=algo, wire=wire,
                            topology=topology, drop_rate=drop_rate, drop_salt=drop_salt,
                            straggler=straggler, gamma=gamma)
    return dryrun_serve(arch, shape_name, multi_pod=multi_pod)


def dryrun_smoke(arch: str = "granite-3-2b", *, algo: str = "dcd", wire: str = "quant:8",
                 topology: str = "ring", steps: int = 2, drop_rate: float = 0.0,
                 drop_salt: int = 0, straggler: float = 0.0, gamma: float = 0.5,
                 device="cuda") -> Dict[str, Any]:
    """The dryrun machinery end to end on the reduced config: the state
    built on meta, then ``steps`` executed steps (``remat=True``, 2 nodes
    stacked on ``device``, zero batches as JAX's smoke feeds)."""
    cfg = get_config(arch).reduced()
    n = 2
    model = build_model(cfg)
    opt = sgd()
    gossip = make_gossip_plan(topology, n)
    codec = make_wire_format(wire) if algo in WIRE_ALGOS else None
    drop = make_drop_spec(drop_rate, salt=drop_salt)
    shape = InputShape("tiny", "train", 64, 2 * n)
    t0 = time.perf_counter()
    p_sds = params_specs(cfg)
    state_sds = init_dist_state(algo, p_sds, gossip, opt, drop=drop, wire=codec)
    batch_sds = train_input_specs(cfg, shape, n)
    t1 = time.perf_counter()
    step = make_dist_train_step(lambda p, b: model.loss(p, b, remat=True), algo, opt, codec,
                                gossip, constant(1e-2), gamma=gamma, drop=drop)
    state = init_dist_state(algo, model.init(0, device=device), gossip, opt, drop=drop,
                            wire=codec)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in batch_sds.items()}
    for _ in range(steps):
        state, metrics = step(state, batch)
    gossip_rec = _gossip_record(gossip, algo)
    rec = {
        "arch": arch, "kind": "smoke", "algo": algo, "wire": wire, **gossip_rec,
        "n_devices": 1, "compile_s": round(t1 - t0, 3), "steps": steps,
        "loss": float(metrics["loss"]),
        "analysis": analysis_record(codec, state_sds.params, gossip_rec["gossip_payloads"]),
    }
    rec.update(_failure_record(codec, gossip, algo, p_sds, drop, straggler))
    rec.update(_controller_record(codec, gossip, algo, p_sds, drop, straggler))
    if codec is not None:
        wire_rec = _wire_record(codec, state_sds.params)
        rec.update({k: wire_rec[k] for k in ("wire_bits_per_element", "wire_format",
                                             "wire_spec_per_leaf")})
    print(f"[SMOKE OK] {json.dumps(rec)}", flush=True)
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, action="append")
    ap.add_argument("--shape", choices=list(SHAPES), action="append")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--algo", default="dcd",
                    choices=["cpsgd", "dpsgd", "naive", "dcd", "ecd", "choco", "deepsqueeze"])
    ap.add_argument("--gamma", type=float, default=0.5,
                    help="CHOCO consensus stepsize in (0, 1] (other algorithms ignore it)")
    ap.add_argument("--wire", default="quant:8",
                    help="gossip wire-format spec for make_wire_format, e.g. quant:8, "
                         "quant:4:block=1024, sparse:0.25:topk, fp16, "
                         "adaptive:4096:small=fp16:large=quant:4")
    ap.add_argument("--topology", default="ring", choices=list(GOSSIP_TOPOLOGIES))
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="per-edge per-round gossip drop probability (0 = reliable fabric)")
    ap.add_argument("--drop-salt", type=int, default=0,
                    help="stream salt for the deterministic PCG drop mask")
    ap.add_argument("--straggler", type=float, default=0.0,
                    help="lognormal sigma for per-edge straggler jitter in the netsim "
                         "figures (comm tail + epoch-vs-sigma curve)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config: build on meta, then execute 2 steps on --device")
    ap.add_argument("--device", default="cuda", help="the smoke's device (cuda or cpu)")
    ap.add_argument("--json", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.smoke:
        arch = (args.arch or ["granite-3-2b"])[0]
        rec = dryrun_smoke(arch, algo=args.algo, wire=args.wire, topology=args.topology,
                           drop_rate=args.drop_rate, drop_salt=args.drop_salt,
                           straggler=args.straggler, gamma=args.gamma, device=args.device)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return

    failures = []
    for arch in args.arch or list(ARCH_IDS):
        for shape in args.shape or list(SHAPES):
            key = f"{arch} x {shape} ({'2-pod 512' if args.multi_pod else '1-pod 256'})"
            try:
                rec = dryrun(arch, shape, multi_pod=args.multi_pod, algo=args.algo,
                             wire=args.wire, topology=args.topology,
                             drop_rate=args.drop_rate, drop_salt=args.drop_salt,
                             straggler=args.straggler, gamma=args.gamma)
                print(f"[OK] {key}: bottleneck={rec['bottleneck']} "
                      f"t=({rec['t_compute_s']:.2e},{rec['t_memory_s']:.2e},"
                      f"{rec['t_collective_s']:.2e})s "
                      f"args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB "
                      f"build={rec['build_s']}s", flush=True)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            except Exception as e:
                failures.append(key)
                print(f"[FAIL] {key}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-runs failed: {failures}")
    print("ALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
