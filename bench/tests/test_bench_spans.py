"""bench/spans.py: device time, launches and idle gaps by the program's
spans, from synthetic profiler events; the readers of the metrics that
read spans; and a toy cell measured on the CPU with the spans off and on."""
from __future__ import annotations

import pytest

from bench import cells, harness, spans
from bench.tests.tiny import ROOT, toy_root

READS_SPANS = ("model.host_ms_per_step", "model.device_ms_per_step",
               "optim.device_ms_per_step", "gossip.host_ms_per_step",
               "gossip.device_ms_per_step", "step.metrics_ms_per_step",
               "data.launches_per_step")
MS = 1_000_000

# one step on the host: the benchmark's spans, the program's spans inside
# them, host ops (the last, the benchmark's synchronize after the step), and
# the runtime's launch calls (correlation id -> start)
BENCH = [(0, 10 * MS, "bench.data"), (10 * MS, 100 * MS, "bench.step")]
PROGRAM = [(1 * MS, 9 * MS, "data.batch"), (10 * MS, 92 * MS, "step"),
           (11 * MS, 30 * MS, "model.forward"), (30 * MS, 60 * MS, "model.backward"),
           (61 * MS, 70 * MS, "optim.update"), (71 * MS, 80 * MS, "gossip.encode"),
           (89 * MS + MS // 2, 91 * MS, "step.metrics")]
OPS = [(2 * MS, 8 * MS, "aten::bitwise_and"), (12 * MS, 29 * MS, "aten::mm"),
       (81 * MS, 89 * MS, "aten::add"), (92 * MS + MS // 2, 99 * MS + MS // 2,
                                         "cudaStreamSynchronize")]
# launch calls: id 7 before any program span, 1 in data.batch, 2 in
# model.forward, 3 on the autograd thread inside model.backward, 4 in
# optim.update, 5 and 9 in ``step`` only, 6 in gossip.encode, 8 in step.metrics
LAUNCHES = [(MS // 2, MS // 2 + 5, "cudaLaunchKernel", 7),
            (3 * MS, 3 * MS + 5, "cudaLaunchKernel", 1),
            (14 * MS, 14 * MS + 5, "cudaLaunchKernel", 2),
            (41 * MS, 41 * MS + 5, "cudaLaunchKernelExC", 3),
            (62 * MS, 62 * MS + 5, "cudaLaunchKernel", 4),
            (85 * MS, 85 * MS + 5, "cudaMemcpyAsync", 5),
            (72 * MS, 72 * MS + 5, "cudaLaunchKernel", 6),
            (90 * MS, 90 * MS + 5, "cudaLaunchKernel", 8),
            (91 * MS + MS // 2, 91 * MS + MS // 2 + 5, "cudaLaunchKernel", 9)]
# device work, the first starting with its launch, most others after it
# (queued behind earlier work), so an op's own start can lie in a later
# span than its launch's; the orphan has no launch call and goes by its
# own start
DEVICE = [(MS // 2, 3 * MS // 2, "early_kernel", 7), (4 * MS, 6 * MS, "hash_kernel", 1),
          (20 * MS, 35 * MS, "gemm", 2), (45 * MS, 65 * MS, "gemm_backward", 3),
          (66 * MS, 74 * MS, "adamw_kernel", 4),
          (86 * MS, 87 * MS, "Memcpy DtoD (Device -> Device)", 5),
          (74 * MS, 78 * MS, "quantize_pack_2d_kernel", 6),
          (88 * MS, 88 * MS + MS // 2, "orphan_kernel", 99),
          (93 * MS, 94 * MS, "sum_kernel", 8), (96 * MS, 98 * MS, "tail_kernel", 9)]
# the profiler marks the spans on the device timeline too: no work
ANNOTATIONS = [(11 * MS, 30 * MS, "model.forward", 0), (10 * MS, 99 * MS, "bench.step", 0)]


def _host(with_program=True):
    return BENCH + OPS + [h[:3] for h in LAUNCHES] + (PROGRAM if with_program else [])


def test_device_time_launches_and_idle_gaps_land_in_their_spans():
    launched = {c: s for s, _, _, c in LAUNCHES}
    got = spans.span_summary(_host(), DEVICE + ANNOTATIONS, launched)
    rows = {name: (round(sec * 1e3, 6), n) for name, (sec, n) in got["spans"].items()}
    assert rows == {spans.UNCOVERED: (1.0, 1), "data.batch": (2.0, 1),
                    "model.forward": (15.0, 1), "model.backward": (20.0, 1),
                    "optim.update": (8.0, 1), "gossip.encode": (4.0, 1), "step": (3.5, 2),
                    "step.metrics": (1.0, 1)}
    idle = {k: round(v * 1e3, 6) for k, v in got["idle_gaps"]}
    # busy 0.5-1.5, 4-6, 20-35, 45-65, 66-78, 86-87, 88-88.5, 93-94, 96-98 of
    # the window 0-100 ms; the adamw and tail kernels were queued before
    # the gaps they end
    assert idle == {"bench.data: python": 0.5, "data.batch: aten::bitwise_and": 2.5,
                    "model.forward: aten::mm": 14.0, "model.backward: python": 10.0,
                    "optim.update: queued": 1.0, "step: aten::add": 9.0,
                    "step.metrics: python": 4.5, "step: queued": 2.0,
                    "bench.step: cudaStreamSynchronize": 2.0}
    assert got["step_idle_named"] == pytest.approx(40.5 / 42.5)
    assert got["clock_skew_ms"] == 0


@pytest.mark.parametrize("offset_ms", [-3, 3])
def test_a_device_clock_offset_changes_nothing(offset_ms):
    launched = {c: s for s, _, _, c in LAUNCHES}
    want = spans.span_summary(_host(), DEVICE, launched)
    moved = [(s + offset_ms * MS, e + offset_ms * MS, n, c) for s, e, n, c in DEVICE]
    got = spans.span_summary(_host(), moved, launched)
    assert got.pop("clock_skew_ms") == offset_ms
    want.pop("clock_skew_ms")
    assert got == want


def test_the_old_summary_is_the_same_with_the_program_spans():
    device = [d[:3] for d in DEVICE]
    marks = [d[:3] for d in ANNOTATIONS]
    with_spans = harness.trace_summary(_host(), device + marks)
    without = harness.trace_summary(_host(False), device + marks[1:])
    for key in ("busy_s", "window_s", "launches", "wire_s", "device_ops"):
        assert with_spans[key] == without[key], key


def test_no_program_spans_no_summary():
    assert spans.span_summary(_host(False), DEVICE, {}) == {}


@pytest.mark.parametrize("name", READS_SPANS)
def test_readers_find_nothing_without_spans(name):
    read = cells.metric_reader(ROOT, name)
    assert read({"profile": None}) is None
    assert read({"profile": {"steps": 2, "busy_s": 1.0}, "spans": {}}) is None


def test_self_ms_takes_the_children_out():
    got = spans.self_ms([("step", 0, None, 0, 10 * MS), ("gossip.mix", 0, 0, 1 * MS, 4 * MS),
                         ("gossip.decode", 0, 1, 2 * MS, 3 * MS)], steps=2)
    assert got == {"step": 3.5, "gossip.mix": 1.0, "gossip.decode": 0.5}


def test_a_toy_cell_measured_with_the_spans_off_and_on(tmp_path):
    root = toy_root(tmp_path)
    out = spans.measure(root, "toy-dense.dcd-q4", 7, 0.3, device="cpu")
    assert [w["spans_on"] for w in out["windows"]] == [False, True, False, True]
    assert [w["spans_a_step"] > 0 for w in out["windows"]] == [False, True, False, True]
    assert set(out["self_host_ms"]) >= {"step", "model.forward", "gossip.encode", "data.batch"}
    on, off = out["metrics_on"], out["metrics_off"]
    assert on["model.host_ms_per_step"] > 0 and on["gossip.host_ms_per_step"] > 0
    assert all(off[name] is None for name in READS_SPANS)
    assert out["span_ns_off"] < out["span_ns_on"]
