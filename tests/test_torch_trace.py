"""repro_torch.trace — the spans inside the training step, on the CPU.

Tracing off, a step records no span, and its state is bit-equal to the same
steps traced.  Traced, every span name appears a known number of times a
step, every parent is in its child's step, and self times add up inside
the ``step`` span.  Every call of a kernel wrapper (``build.count_call``)
runs inside ``gossip.encode`` (the send kernels), ``gossip.decode`` (the
receive kernels), ``data.batch`` (the data's Markov walk, once a batch) or
``optim.update`` (AdamW, once a leaf), for every algorithm that encodes.  The step analyzer
finds no host read with tracing on.  On ranks, ``run_training`` reports the
``transport.<label>`` spans' seconds only when tracing is on.  The model is
granite-3-2b's reduced config cut to one layer of width 64, on a ring of 4.
"""
import collections
import dataclasses
import functools
import time

import pytest
import torch

from repro_torch import trace
from repro_torch.analysis import step_checks as sc
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, stacked_node_batches
from repro_torch.distributed.decentralized import init_dist_state, make_dist_train_step
from repro_torch.distributed.gossip import make_gossip_plan
from repro_torch.kernels import build
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.train import TrainConfig, run_training
from repro_torch.models.api import build_model
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import constant
from repro_torch.tree import leaf_items, tree_leaves

TINY = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=1, d_model=64,
                           n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128, vocab=128)
N, STEPS = 4, 2
# (algo, wire): the three cases of the bit-equality and count tests first
CASES = [("dcd", "quant:4"), ("choco", "sign"), ("dpsgd", None)]
ENCODING = CASES[:2] + [("dcd", "quant:8"), ("ecd", "quant:4"), ("naive", "quant:4"),
                        ("deepsqueeze", "sign"), ("choco", "sparse:0.05:topk"),
                        ("dcd", "lowrank:2:warm")]
SEND = {"quantize_pack_2d", "quantize_2d", "sign_pack_2d", "sparse_select_pack_2d",
        "lowrank_project_2d"}
RECEIVE = set(sc.DECODE_KERNELS) | {"sparse_unpack_scatter_2d"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    trace.enable(False)


def _run(algo, wire, traced):
    """``STEPS`` steps of ``algo`` over ``wire``; the state and the spans."""
    model = build_model(TINY)
    opt = make_optimizer("adamw", weight_decay=0.01)
    plan = make_gossip_plan("ring", N)
    state = init_dist_state(algo, model.init(0, device="cpu"), plan, opt, wire=wire)
    step = make_dist_train_step(model.loss, algo, opt, wire, plan, constant(0.01))
    dc = DataConfig(vocab=TINY.vocab, seq_len=16, global_batch=2 * N, n_shards=N, seed=3)
    trace.collect()
    trace.enable(traced)
    try:
        for t in range(STEPS):
            state, _ = step(state, stacked_node_batches(dc, t, TINY, device="cpu"))
    finally:
        trace.enable(False)
    return state, trace.collect()


@functools.lru_cache(maxsize=None)
def _traced(algo, wire):
    return _run(algo, wire, True)


def _tensors(state):
    trees = {"params": state.params, "m": state.opt.m, "v": state.opt.v, **state.aux}
    return {(k, p): l for k, tree in trees.items() if tree is not None
            for p, l in (leaf_items(tree) if not isinstance(tree, torch.Tensor)
                         else [("", tree)])}


@pytest.mark.parametrize("algo,wire", CASES)
def test_off_records_nothing_and_on_changes_no_bit(algo, wire):
    plain, spans = _run(algo, wire, False)
    assert spans == []
    traced, spans = _traced(algo, wire)
    assert spans
    a, b = _tensors(plain), _tensors(traced)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("algo,wire", CASES)
def test_span_counts_parents_and_self_times(algo, wire):
    state, spans = _traced(algo, wire)
    leaves = len(leaf_items(state.params))
    assert {name for name, *_ in spans} <= set(trace.NAMES)
    label = "transport.wire" if wire else "transport.dense"
    want = {"step": 1, "data.batch": 1, "model.forward": 1, "model.backward": 1,
            "step.metrics": 1, "optim.update": leaves, "gossip.encode": leaves if wire else 0,
            label: leaves}
    for t in range(STEPS):
        got = collections.Counter(name for name, step, *_ in spans if step == t)
        assert {k: got[k] for k in want} == want, t
    children = collections.defaultdict(int)
    for name, step, parent, t0, t1 in spans:
        assert t1 >= t0
        if parent is not None:
            assert spans[parent][1] == step and spans[parent][3] <= t0 <= t1 <= spans[parent][4]
            children[parent] += t1 - t0
        else:
            assert name in ("step", "data.batch"), name
    for name, step, _, t0, t1 in spans:
        if name != "step":
            continue
        inside = [j for j, s in enumerate(spans) if s[1] == step and s[0] != "data.batch"]
        selfs = [spans[j][4] - spans[j][3] - children[j] for j in inside]
        assert min(selfs) >= 0 and sum(selfs) <= t1 - t0


@pytest.mark.parametrize("algo,wire", ENCODING)
def test_kernel_calls_run_inside_encode_and_decode(algo, wire, monkeypatch):
    calls = []
    count_call = build.count_call

    def counted(counter, launched=False):
        calls.append((counter.__name__, time.perf_counter_ns()))
        count_call(counter, launched)

    monkeypatch.setattr(build, "count_call", counted)
    state, spans = _run(algo, wire, True)
    assert calls
    assert sum(name == "markov_walk" for name, _ in calls) == STEPS
    assert sum(name == "adamw_update" for name, _ in calls) == \
        STEPS * len(tree_leaves(state.params))
    for name, t in calls:
        inner = max((s for s in spans if s[3] <= t <= s[4]), key=lambda s: s[3])
        home = ("data.batch" if name == "markov_walk" else
                "optim.update" if name == "adamw_update" else
                "gossip.encode" if name in SEND else "gossip.decode")
        assert inner[0] == home, name
        assert name in SEND | RECEIVE | {"markov_walk", "adamw_update"}, name


@pytest.mark.parametrize("algo,topology,wire", [("dcd", "ring", "quant:4"),
                                                ("choco", "ring", "sign"),
                                                ("dpsgd", "ring", None)])
def test_analyzer_finds_no_host_read_with_tracing_on(algo, topology, wire):
    trace.enable(True)
    rep = sc.analyze_case(algo, topology, wire, device="cpu")
    trace.enable(False)
    assert rep.ok, rep.violations
    assert rep.host_reads == 0
    assert {name for name, *_ in trace.collect()} >= {"step", "gossip.mix", "step.metrics"}


def _rank_runs(group, cfg, runs):
    out = []
    for traced, tc in runs:
        group.stats.reset()
        trace.enable(traced)
        hist = run_training(cfg, tc, group=group)
        trace.enable(False)
        out.append((hist["transport"], sorted({s[0] for s in hist.get("spans", [])})))
    return out


def test_rank_transport_seconds_come_from_spans_when_tracing_is_on():
    tc = TrainConfig(algo="dcd", wire="quant:4", n_nodes=2, seq_len=16, global_batch=4,
                     steps=2, log_every=1)
    per_rank = spawn_ranks(_rank_runs, 2, "gloo", TINY, [(True, tc), (False, tc)],
                           device="cpu", timeout_s=120)
    for (on, names), (off, none) in per_rank:
        assert set(on["seconds"]) == {"wire", "metric"} and min(on["seconds"].values()) > 0
        assert {f"transport.{k}" for k in on["seconds"]} <= set(names)
        assert "seconds" not in off and none == []
        assert on["sent"] == off["sent"]
