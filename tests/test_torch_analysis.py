"""repro_torch.analysis.step_checks — the port's step analyzer, against the
JAX package's ``analysis/jaxpr_checks.py`` (``tests/test_analysis.py``).

On the CPU, where every kernel wrapper runs its plain version and counts
the call: the decode-site formula equal to JAX's for every algorithm and
plan; the wire containers (``payload_dtype_shapes``) equal to JAX's
``jax.eval_shape`` of the same wire on the same trees; the payload
whitelist's violations equal to JAX's on the same operands (JAX's given as
synthetic HLO lines); the receive wrappers a wire's ``decode_axpy_``
reaches; one step of every case of the representative grid ``ok`` with
its decode calls equal to ``decode_sites x kernels_per_site``; a planted
float64 op and a planted host read reported; the hooks the analyzer reads
(``calls``, ``TransportStats.shapes``, ``step.transport``); the dryrun's
``analysis`` record, moved here, unchanged.  Only pure functions of the
JAX analyzer run (no JAX step is traced).
"""
import types

import jax.numpy as jnp
import pytest
import torch

from repro.analysis import jaxpr_checks as jc
from repro.distributed.gossip import GOSSIP_TOPOLOGIES as JTOPOLOGIES
from repro.distributed.gossip import make_gossip_plan as jmake_plan
from repro.distributed.wire import make_wire_format as jmake_wire
from repro.distributed.wire import wire_spec as jwire_spec
from repro_torch.analysis import lint
from repro_torch.analysis import step_checks as sc
from repro_torch.distributed.decentralized import ALGOS, REPLICA_ALGOS, make_dist_train_step
from repro_torch.distributed.gossip import as_schedule, make_gossip_plan
from repro_torch.distributed.transport import RankTransport, StackedTransport, TransportStats
from repro_torch.distributed.wire import leaf_seed, make_wire_format
from repro_torch.kernels import lowrank as lk
from repro_torch.kernels import quant as q
from repro_torch.launch import dryrun as tdr
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.tree import leaf_items
from test_analysis import REGISTRY_VARIANTS
from test_torch_families import one_torch_thread  # noqa: F401

N = 8
SHAPES = {"stacked": {"bias": (N, 32), "weight": (N, 1024)},
          "toy": {"bias": (N, 32), "weight": (N, 1024), "proj": (N, 32, 128)}}


def jtree(name):
    return {k: jnp.zeros(s) for k, s in SHAPES[name].items()}


def ttree(name):
    return {k: torch.zeros(s) for k, s in SHAPES[name].items()}


# ---------------------------------------------------------------------------
# decode sites and wire containers, equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", JTOPOLOGIES)
def test_decode_sites_equal_jax(topology):
    jsched, tsched = jmake_plan(topology, N), as_schedule(make_gossip_plan(topology, N))
    for algo in ALGOS:
        assert sc.decode_sites(algo, tsched) == jc.decode_sites(algo, jsched), algo
        # the eager step runs one round of a time-varying schedule: its
        # replica share is the schedule's replica payloads, beside one self
        # site a round it runs
        sites = sc.step_decode_sites(algo, tsched)
        if algo in REPLICA_ALGOS:
            assert sites == tsched.replica_payloads + (
                1 if tsched.time_varying else tsched.period)
        if not tsched.time_varying:
            assert sites == sc.decode_sites(algo, tsched)


def test_step_decode_sites_of_a_time_varying_schedule():
    exp = make_gossip_plan("exp", N)
    assert exp.time_varying and exp.period == 3
    for t in range(2 * exp.period):
        assert sc.step_decode_sites("dcd", exp, t) == 1 + len(exp.shift_union)
        rnd = exp.rounds[t % exp.period]
        assert sc.step_decode_sites("deepsqueeze", exp, t) == 2 + len(rnd.shifts)
    assert sum(sc.step_decode_sites("deepsqueeze", exp, t) for t in range(exp.period)) == \
        sc.decode_sites("deepsqueeze", exp)


@pytest.mark.parametrize("tree", sorted(SHAPES))
@pytest.mark.parametrize("w", REGISTRY_VARIANTS, ids=[jwire_spec(w) for w in REGISTRY_VARIANTS])
def test_payload_dtype_shapes_equal_jax(w, tree):
    port = make_wire_format(jwire_spec(w))
    assert sc.payload_dtype_shapes(port, ttree(tree)) == jc.payload_dtype_shapes(w, jtree(tree))


def test_short_dtype_names():
    assert [sc.short_dtype(d) for d in (torch.int32, torch.int8, torch.float16,
                                        torch.bfloat16, torch.float32, torch.float64)] == \
        ["u32", "s8", "f16", "bf16", "f32", "f64"]
    assert sc.short_dtype("float32") == "f32"
    assert sc.dense_leaf_shapes(ttree("toy")) == {(N, 32), (N, 1024), (N, 32, 128)}


# ---------------------------------------------------------------------------
# payload whitelist, on the same operands as JAX's
# ---------------------------------------------------------------------------

def hlo(tokens):
    """Synthetic collective-permute lines of JAX's HLO for ``(dtype, shape)``."""
    def t(d, s):
        return f"{d}[{','.join(str(x) for x in s)}]"
    return "".join(f"%collective-permute.{i} = {t(d, s)} collective-permute({t(d, s)} %p{i})\n"
                   for i, (d, s) in enumerate(tokens))


WHITELIST_CASES = {
    "dense_leak": ("fp16", [("f32", (N, 1024)), ("f16", (N, 1024)), ("f16", (N, 32))]),
    "dense_leak_beside_words": ("sign:mean:128", [("u32", (N, 8, 4)), ("f32", (N, 32))]),
    "container_missing": ("quant:4:128", [("f32", (N, 8))]),
    "s8_missing": ("quant:8:64", [("u32", (N, 16, 8)), ("f32", (N, 16, 1))]),
    "clean": ("fp16", [("f16", (N, 1024)), ("f16", (N, 32))]),
    "identity_ships_the_leaf": ("identity", [("f32", (N, 1024)), ("f32", (N, 32))]),
}


@pytest.mark.parametrize("case", sorted(WHITELIST_CASES))
def test_whitelist_gives_the_jax_violations(case):
    spec, tokens = WHITELIST_CASES[case]
    text = hlo(tokens)
    handed = [(o.dtype, o.shape) for o in jc.permute_operands(text)]
    want = jc.check_permute_payload_whitelist(text, jmake_wire(spec), jtree("stacked"))
    got = sc.check_permute_payload_whitelist(handed, make_wire_format(spec), ttree("stacked"))
    assert got == want
    assert bool(got) == (case not in ("clean", "identity_ships_the_leaf"))


def test_whitelist_with_nothing_handed():
    v = sc.check_permute_payload_whitelist([], make_wire_format("quant:4"), ttree("stacked"))
    assert len(v) == 1 and v[0].startswith("no collective-permute found")


# ---------------------------------------------------------------------------
# the receive wrappers and the per-site count
# ---------------------------------------------------------------------------

def test_decode_kernels_are_what_decode_axpy_reaches():
    """Every wrapper that a wire's decode_axpy_ calls, over every format,
    on and off the 128-lane gate, into float32 and bfloat16 accumulators."""
    assert set(sc.DECODE_KERNELS) <= set(q.call_counts())
    reached = set()
    specs = ["quant:4", "quant:8", "quant:3", "sign", "sparse:0.25", "lowrank:2", "fp16",
             "identity", "lowrank:2:warm", sc._ADAPTIVE_SPEC]
    for spec in specs:
        wire = make_wire_format(spec)
        for li, (path, leaf) in enumerate(leaf_items(ttree("toy"))):
            lw = wire.route(path, leaf.shape)
            x = torch.randn(leaf.shape, generator=torch.Generator().manual_seed(li))
            payload = lw.encode(x, leaf_seed(0, 2, li))
            for dtype in (torch.float32, torch.bfloat16):
                before = q.call_counts()
                lw.decode_axpy_(payload, torch.ones(leaf.shape, dtype=dtype), 0.5, 0.5)
                reached |= {k for k, v in q.call_counts().items() if v != before[k]}
    assert reached == set(sc.DECODE_KERNELS)


def test_kernels_per_site_measures_the_wire():
    tree = ttree("stacked")
    # packed 4-bit: K2 for the 1024 leaf; the 32-wide leaf's block is off
    # the lane gate, so its packed receive is the dense decode (K4b)
    assert sc.kernels_per_site("quant:4", tree) == 2
    assert sc.kernels_per_site("quant:8", tree) == 2        # K4a, any block
    assert sc.kernels_per_site("fp16", tree) == 0
    assert sc.kernels_per_site("sign", tree) == 1           # K5b; the 32 leaf in torch
    assert sc.kernels_per_site("quant:4", {"b": torch.zeros((N, 32))}) == 1
    mat = {"proj": torch.zeros((N, 32, 128)), "b": torch.zeros((N, 32))}
    assert sc.kernels_per_site("lowrank:2", mat) == 1
    assert sc.kernels_per_site("lowrank:2", tree) == 0
    before = {k: v.clone() for k, v in tree.items()}
    sc.kernels_per_site("quant:4", tree)
    assert all(torch.equal(tree[k], before[k]) for k in tree)


def test_expected_kernel_calls_composes():
    ring = make_gossip_plan("ring", N)
    tree = ttree("stacked")
    assert sc.expected_kernel_calls("dcd", ring, None, tree) == 0
    assert sc.expected_kernel_calls("dcd", ring, make_wire_format("quant:4:128"), tree) == 6
    assert sc.expected_kernel_calls("deepsqueeze", ring, make_wire_format("sign:mean:128"),
                                    tree) == 4


# ---------------------------------------------------------------------------
# one step of every grid case
# ---------------------------------------------------------------------------

def test_grid_is_the_jax_packages():
    assert sc.DEFAULT_GRID == jc.DEFAULT_GRID


@pytest.mark.parametrize("case", sc.DEFAULT_GRID,
                         ids=[f"{a}-{t}-{w}-{d}" for a, t, w, d in sc.DEFAULT_GRID])
def test_analyze_case_on_cpu(case):
    algo, topology, wire, drop = case
    rep = sc.analyze_case(*case, device="cpu")
    assert rep.ok, rep.violations
    assert rep.launches == 0                    # the CPU runs the plain versions
    tsched = make_gossip_plan(topology, N)
    if wire is None:
        assert rep.kernel_calls == rep.expected_kernels == 0
        assert rep.permute_dtypes == ("f32",)
    else:
        assert rep.kernel_calls == rep.expected_kernels > 0
        assert rep.expected_kernels == jc.decode_sites(algo, jmake_plan(topology, N)) * \
            sc.kernels_per_site(wire, ttree("toy"))
        assert sc.decode_sites(algo, tsched) == sc.step_decode_sites(algo, tsched)
        containers = jc.payload_dtype_shapes(jmake_wire(wire), jtree("toy"))
        assert rep.permute_dtypes == tuple(sorted({d for d, _ in containers}))
    if not drop:
        assert rep.host_reads == 0
    jrep = jc.CaseReport(algo, topology, wire, drop, rep.kernel_calls, rep.expected_kernels,
                         rep.permute_dtypes, rep.violations)
    assert rep.describe() == jrep.describe()


def _planted(extra):
    def loss(params, batch):
        value, metrics = sc._toy_loss(params, batch)
        return extra(value), metrics
    return loss, sc._toy_params(), sc._toy_batch(N)


def test_planted_f64_op_is_reported():
    rep = sc.analyze_case("dcd", "ring", "quant:4", device="cpu",
                          testbed=_planted(lambda v: v + (v.double() * 0).float()))
    assert not rep.ok
    assert any(v.startswith("f64 value inside the step") for v in rep.violations)


def test_planted_host_read_is_counted():
    rep = sc.analyze_case("dcd", "ring", "quant:4", device="cpu",
                          testbed=_planted(lambda v: v * (v.detach().item() * 0 + 1)))
    assert rep.host_reads == N      # one .item() a node's loss
    assert rep.ok                   # on the CPU a read is no device sync
    assert rep.kernel_calls == rep.expected_kernels > 0


def test_step_watch_counts_reads_of_the_steps_device_only():
    x = torch.ones(4)
    watch = sc.StepWatch("cpu")
    with watch:
        float(x.sum())
        bool(x.all())
        torch.nonzero(x)
        torch.equal(x, x)
        x.to(torch.float64)
    assert len(watch.host_reads) == 4
    assert sc.check_no_f64(watch) == ["f64 value inside the step: aten._to_copy.default"]
    card = sc.StepWatch("cuda")      # host tensors are no read of a step on the card
    with card:
        float(x.sum())
        torch.nonzero(x)
    assert card.host_reads == []


def test_lint_sweep_prints_a_line_a_case(monkeypatch, capsys):
    monkeypatch.setattr(sc, "DEFAULT_GRID", sc.DEFAULT_GRID[-2:])
    assert lint.main(["--sweep", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-3:-1] == ["analysis[ok] dcd@ring@quant:4@drop=0.2 kernels=9/9 "
                          "permutes=['f32', 'u32']",
                          "analysis[ok] dpsgd@ring@dense@drop=0.0 kernels=0/0 permutes=['f32']"]
    assert out[-1] == "step sweep: 2 case(s) on cpu, 0 failing"
    bad = sc.CaseReport("dcd", "ring", "quant:4", 0.0, 1, 9, ("u32",), ("x",))
    monkeypatch.setattr(sc, "run_sweep", lambda device: [bad])
    assert lint.main(["--sweep", "--device", "cpu"]) == 1


# ---------------------------------------------------------------------------
# the hooks the analyzer reads
# ---------------------------------------------------------------------------

def test_wrappers_count_plain_calls_and_no_launches():
    x = torch.randn((2, 128), generator=torch.Generator().manual_seed(0))
    calls, launches = q.call_counts(), q.launch_counts()
    q.quantize_pack_2d(x, 0, bits=4)
    q.unpack_dequant_axpy_2d(*q.quantize_pack_2d(x, 1, bits=4), x.to(torch.bfloat16),
                             bits=4, weight=1.0)
    lk.lowrank_project_2d(torch.empty((2, 4, 128), device="meta"),
                          torch.empty((2, 128, 2), device="meta"))
    lk.lowrank_axpy_2d(torch.zeros((4, 2)), torch.zeros((128, 2)), torch.zeros((4, 128)),
                       weight=1.0)
    got = {k: v - calls[k] for k, v in q.call_counts().items() if v != calls[k]}
    assert got == {"quantize_pack_2d": 2, "unpack_dequant_axpy_2d_bf16": 1,
                   "lowrank_axpy_2d": 1}
    assert q.launch_counts() == launches
    q.reset_call_counts()
    assert set(q.call_counts().values()) == {0}


def test_transport_records_what_it_was_handed():
    tp = StackedTransport(N)
    words = torch.zeros((N, 2, 4), dtype=torch.int32)
    got = tp.exchange({"codes": words, "scale": torch.zeros((N, 2, 1))}, (1, -1))
    assert torch.equal(got[1]["codes"], words)
    assert tp.stats.shapes == {"wire": {("int32", (N, 2, 4)), ("float32", (N, 2, 1))}}
    assert tp.stats.sent == {"wire": N * 2 * 4 * 4 + N * 2 * 4}
    tp.stats.reset()
    assert tp.stats.shapes == {} and tp.stats.sent == {}
    step = make_dist_train_step(sc._toy_loss, "dcd", sgd(), "quant:4", N, constant(0.05))
    assert isinstance(step.transport, StackedTransport) and step.transport.n == N
    group = types.SimpleNamespace(n=4, rank=1, device=torch.device("cpu"), backend="gloo",
                                  stats=TransportStats())
    assert RankTransport(group).stats is group.stats


# ---------------------------------------------------------------------------
# the dryrun's record, moved here
# ---------------------------------------------------------------------------

# the record of the toy tree at 3 payloads a step, as launch/dryrun.py
# built it before the move
RECORDS = {
    None: {"collective_permutes": 0, "permute_dtypes": [], "f64_free": True},
    "quant:4": {"collective_permutes": 9, "permute_dtypes": ["float32", "int32"],
                "f64_free": True, "permute_whitelist_violations": 0},
    "quant:8": {"collective_permutes": 9, "permute_dtypes": ["float32", "int8"],
                "f64_free": True, "permute_whitelist_violations": 0},
    "identity": {"collective_permutes": 9, "permute_dtypes": ["float32"], "f64_free": True,
                 "permute_whitelist_violations": 0},
    "fp16": {"collective_permutes": 9, "permute_dtypes": ["float16"], "f64_free": True,
             "permute_whitelist_violations": 3},
    "lowrank:2": {"collective_permutes": 9, "permute_dtypes": ["float16", "float32"],
                  "f64_free": True, "permute_whitelist_violations": 2},
    sc._ADAPTIVE_SPEC: {"collective_permutes": 9,
                        "permute_dtypes": ["float16", "float32", "int32"], "f64_free": True,
                        "permute_whitelist_violations": 1},
}


@pytest.mark.parametrize("spec", list(RECORDS), ids=str)
def test_analysis_record_is_the_dryruns(spec):
    assert tdr.analysis_record is sc.analysis_record
    codec = make_wire_format(spec) if spec else None
    assert sc.analysis_record(codec, ttree("toy"), 3) == RECORDS[spec]
