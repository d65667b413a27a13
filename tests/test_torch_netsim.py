"""The port's netsim (cost model and controller) against the JAX package's.

Both are numpy code calling numpy with the same arguments, so every figure,
sample, trace and plan must be exactly equal (``==`` on floats, bit-equal
arrays), for the same wires, plans, drop rates and seeds.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.distributed.gossip import make_gossip_plan as jplan
from repro.distributed.wire import make_wire_format as jwire
from repro.netsim import controller as jc
from repro.netsim import cost_model as jm
from repro_torch.distributed.gossip import make_gossip_plan as tplan
from repro_torch.distributed.wire import make_wire_format as twire
from repro_torch.netsim import controller as tc
from repro_torch.netsim import cost_model as tm

WIRES = ["quant:8", "quant:4", "quant:3", "sign", "sparse:0.05:topk", "fp16", "identity",
         "lowrank:2", "adaptive:4096:small=fp16:large=quant:4"]
TOPOLOGIES = ["ring", "torus", "full_logn", "exp", "star", "full", "chain"]
NETS = [jm.BEST_NETWORK, jm.LOW_BW, jm.HIGH_LAT, jm.WORST]


def _as_dict(strats):
    return {k: dataclasses.asdict(v) for k, v in strats.items()}


def test_constants_and_conditions_equal():
    for name in ("BEST_NETWORK", "LOW_BW", "HIGH_LAT", "WORST"):
        j, t = getattr(jm, name), getattr(tm, name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t) and j.describe() == t.describe()
    assert (jm.RESNET20_BYTES, jm.PAPER_ITERS_PER_EPOCH, jm.PAPER_COMPUTE_S) == \
        (tm.RESNET20_BYTES, tm.PAPER_ITERS_PER_EPOCH, tm.PAPER_COMPUTE_S)
    assert jc.DEFAULT_TOPOLOGIES == tc.DEFAULT_TOPOLOGIES and jc.DEFAULT_WIRES == tc.DEFAULT_WIRES


@pytest.mark.parametrize("n", [2, 8, 16])
def test_strategies_and_expected_payloads_equal(n):
    for bits, degree, lp in [(8.03, 2, None), (4.03, 4, 3), (1.0, 3, 7)]:
        assert _as_dict(jm.strategies(1e6, n, bits, degree, lp)) == \
            _as_dict(tm.strategies(1e6, n, bits, degree, lp))
    for deg, r in [(2, 0.0), (4, 0.1), (3, 0.5)]:
        assert jm.expected_payloads(deg, r) == tm.expected_payloads(deg, r)


@pytest.mark.parametrize("wire", WIRES)
def test_strategies_for_equal_over_plans_algos_and_drops(wire):
    jw, tw = jwire(wire), twire(wire)
    assert jw.wire_bits_per_element() == tw.wire_bits_per_element()
    assert _as_dict(jm.strategies_for(3.3e7, 8, jw)) == _as_dict(tm.strategies_for(3.3e7, 8, tw))
    for topo in TOPOLOGIES:
        for algo in (None, "dcd", "naive", "dpsgd"):
            for drop in (0.0, 0.2):
                j = jm.strategies_for(3.3e7, 8, jw, plan=jplan(topo, 8), drop_rate=drop, algo=algo)
                t = tm.strategies_for(3.3e7, 8, tw, plan=tplan(topo, 8), drop_rate=drop, algo=algo)
                assert _as_dict(j) == _as_dict(t), (topo, algo, drop)


def test_times_tails_and_curves_equal():
    strat_j = jm.strategies_for(1.08e6, 8, jwire("quant:4"), plan=jplan("exp", 8))
    strat_t = tm.strategies_for(1.08e6, 8, twire("quant:4"), plan=tplan("exp", 8))
    for name in strat_j:
        sj, st = strat_j[name], strat_t[name]
        for net in NETS:
            tnet = tm.NetworkCondition(net.bandwidth_bps, net.latency_s)
            assert jm.comm_time(sj, net) == tm.comm_time(st, tnet)
            assert jm.iter_time(sj, net, 0.05) == tm.iter_time(st, tnet, 0.05)
            assert jm.epoch_time(sj, net, 0.05, 48) == tm.epoch_time(st, tnet, 0.05, 48)
            for sigma, drop in [(0.0, 0.0), (0.5, 0.1), (1.0, 0.0)]:
                lj = jm.LinkModel.from_condition(net, straggler=sigma, drop_rate=drop)
                lt = tm.LinkModel.from_condition(tnet, straggler=sigma, drop_rate=drop)
                assert lj.describe() == lt.describe()
                assert dataclasses.asdict(lj.condition()) == dataclasses.asdict(lt.condition())
                for seed in (0, 3):
                    a = jm.sample_comm_times(sj, lj, 4, n_samples=64, seed=seed)
                    b = tm.sample_comm_times(st, lt, 4, n_samples=64, seed=seed)
                    assert a.dtype == b.dtype and np.array_equal(a, b)
                    assert jm.comm_time_tail(sj, lj, 4, 64, seed) == \
                        tm.comm_time_tail(st, lt, 4, 64, seed)
            assert jm.straggler_curve(sj, net, 0.05, 48, 3, n_samples=32, seed=1) == \
                tm.straggler_curve(st, tnet, 0.05, 48, 3, n_samples=32, seed=1)


@pytest.mark.parametrize("topo", ["ring", "full_logn", "exp", "torus"])
@pytest.mark.parametrize("drop", [None, 0.3, "0.25:7"])
def test_failure_trace_equal(topo, drop):
    j = jm.failure_trace(jplan(topo, 8), drop, 5)
    t = tm.failure_trace(tplan(topo, 8), drop, 5)
    assert len(j) == len(t) == 5
    for mj, mt in zip(j, t):
        assert list(mj) == list(mt)
        for key in mj:
            assert mj[key].dtype == mt[key].dtype and np.array_equal(mj[key], mt[key]), key


@pytest.mark.parametrize("algo", ["choco", "dcd", "naive"])
def test_candidate_costs_and_plans_equal(algo):
    for wire in ("sign", "quant:4", "fp16", "sparse:0.05:topk"):
        assert jc.candidate_fidelity(wire) == tc.candidate_fidelity(wire)
    # each network with its own straggler tail and drop rate
    for net, (sigma, drop) in zip(NETS, [(0.0, 0.0), (0.5, 0.1), (0.0, 0.2), (1.0, 0.0)]):
        lj = jm.LinkModel.from_condition(net, straggler=sigma, drop_rate=drop)
        lt = tm.LinkModel(net.bandwidth_bps, net.latency_s, sigma, drop)
        for topo in ("ring", "exp", "full_logn"):
            assert jc.candidate_iter_time(2e8, 8, "quant:4", topo, lj, algo=algo) == \
                tc.candidate_iter_time(2e8, 8, "quant:4", topo, lt, algo=algo)
        kw = {"early_frac": 0.25, "slack": 3.0} if algo == "dcd" else {"slack": 1.0}
        for kwargs in ({}, kw):
            pj = jc.plan_phases(2e8, 8, lj, total_steps=400, algo=algo, **kwargs)
            pt = tc.plan_phases(2e8, 8, lt, total_steps=400, algo=algo, **kwargs)
            assert pj.describe() == pt.describe() and pj.records() == pt.records()


def test_measured_controller_equal(tmp_path):
    recs = [{"topology": "ring", "wire": "quant:4", "step_time_s": 0.31},
            {"topology": "exp", "wire": "quant:8", "comm_tail_s": {"mean": 0.2, "p50": 0.1,
                                                                    "p95": 0.4}},
            {"topology": "full_logn", "wire": "fp16", "comm_tail_s": 0.27},
            {"topology": "ring", "wire": "sign", "t_compute_s": 0.1, "t_memory_s": 0.05,
             "t_collective_s": None, "wire_bits_per_element": 1.03},
            {"topology": "exp", "wire": "sign"},
            {"kind": "serve", "step_time_s": 0.01}]
    path = tmp_path / "records.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    assert jc.load_dryrun_records(str(path)) == tc.load_dryrun_records(str(path)) == recs
    for rec in recs:
        assert jc.record_iter_time(rec) == tc.record_iter_time(rec)
        assert jc.record_iter_time(rec, 0.2) == tc.record_iter_time(rec, 0.2)
    for kw in ({}, {"early_frac": 0.8, "slack": 2.0}, {"slack": 1.0}, {"compute_s": 0.5}):
        pj = jc.plan_phases_measured(recs, total_steps=100, **kw)
        pt = tc.plan_phases_measured(recs, total_steps=100, **kw)
        assert pj.describe() == pt.describe()
    with pytest.raises(ValueError):
        tc.plan_phases_measured([recs[-1]], total_steps=10)


def test_planned_phases_parse_into_the_port_runtime_plan():
    """A plan from the port's controller round-trips through the grammar the
    training driver parses."""
    plan = tc.plan_phases(2e8, 8, tm.LinkModel(50e6, 5e-3, 0.5, 0.1), total_steps=100)
    assert tc.PhasePlan.parse(plan.describe()) == plan
    assert plan.phases[0].start == 0
