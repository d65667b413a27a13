"""The plain reference against the program on the CPU at toy sizes, and
the comparison failing the float8 control and each planted fault."""
from __future__ import annotations

import time

import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataConfig, stacked_node_batches
from repro_torch.distributed.wire import make_wire_format
from repro_torch.models.ssm import ssd_recurrent_ref

from bench import cells, compare, faults, harness, ranks, run, weights
from bench.reference import data, model, train, wire
from bench.tests.tiny import CELLS, CONFIGS, RANK_CELLS, TOY_LIMITS, toy_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def sound_root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("bench"), TOY_LIMITS)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_reference_batches_equal_the_programs(seed):
    dc = DataConfig(vocab=300, seq_len=32, global_batch=8, n_shards=4, seed=seed)
    arch = ArchConfig(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab=300)
    for step in (0, 5):
        got = stacked_node_batches(dc, step, arch, device="cpu")
        want = data.node_batches(seed, step, vocab=300, seq_len=32, global_batch=8, nodes=4,
                                 device="cpu")
        assert torch.equal(got["tokens"], want["tokens"])
        assert torch.equal(got["labels"], want["labels"])


@pytest.mark.parametrize("spec", ["quant:4", "quant:8"])
@pytest.mark.parametrize("shape", [(4, 3, 1100), (4, 64)])
def test_reference_wire_decodes_what_the_program_decodes(spec, shape):
    z = torch.randn(shape, generator=torch.Generator().manual_seed(3)) * 1e-3
    seed = wire.leaf_seed(7, 2, 5)
    w = make_wire_format(spec)
    got = w.decode(w.encode(z, seed), z)
    assert torch.equal(got, wire.quantize_dequantize(z, seed, wire.parse(spec)))


def test_reference_ssd_scan_equals_the_sequential_recurrence():
    g = torch.Generator().manual_seed(1)
    b, s, h, p, n = 2, 20, 4, 8, 16
    x = torch.randn((b, s, h, p), generator=g)
    dt = torch.rand((b, s, h), generator=g) * 0.1
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    bm, cm = torch.randn((b, s, 1, n), generator=g), torch.randn((b, s, 1, n), generator=g)
    d_skip = torch.ones(h)
    want, _ = ssd_recurrent_ref(x, dt, a_log, bm, cm, d_skip)
    got = model.ssd_scan(x, dt, a_log, bm, cm, d_skip, chunk=8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", list(CELLS))
def test_program_meets_the_reference_for_the_first_steps(sound_root, cell):
    result = run.run(sound_root, cell, 2 ** 31 + 17, 0.2, trace=False, device="cpu",
                     started=time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["checks"]["token_mismatches"]["value"] == 0
    assert result["checks"]["sent_bytes_gap"]["value"] == 0


@pytest.mark.parametrize("cell", list(CELLS))
def test_float8_control_is_not_correct(root, cell):
    """The reference with float8 projections in the program's place fails
    the real cell's limits."""
    c = cells.find(root, cell)
    ok = []
    for seed in (1, 2, 3):
        params0 = weights.make(c.config, seed, "cpu")
        want = train.run(c.config, c.traffic, seed, params0, harness.CHECK_STEPS, "cpu")
        got = train.run(c.config, c.traffic, seed, params0, harness.CHECK_STEPS, "cpu", "fp8")
        ok.append(compare.verdict(compare.numbers(got, want), c.limits)[0])
    assert not any(ok)


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("cell", list(CELLS))
def test_each_fault_is_not_correct(root, cell, fault):
    """A run with the fault planted under the timed path comes out not
    correct under the real cell's limits."""
    with faults.FAULTS[fault]():
        result = run.run(root, cell, 2 ** 31 + 29, 0.2, trace=False, device="cpu",
                         started=time.perf_counter())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", list(RANK_CELLS))
def test_ranks_meet_the_reference(sound_root, cell):
    """One process a node over gloo: the reference's processes gather each
    other's parameters, the program's exchange only wire containers."""
    result = ranks.run(sound_root, cell, 2 ** 31 + 19, 0.2, False, time.perf_counter(),
                       device="cpu")
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4 and result["loaded"] == []


@pytest.mark.parametrize("cell", list(RANK_CELLS))
def test_each_fault_on_ranks_is_not_correct(sound_root, cell):
    """Under the toy limits a sound run on ranks meets, the control and each
    fault on ranks do not."""
    found = ranks.readings(sound_root, cell, [2 ** 31 + 23], 1, device="cpu")
    c = cells.find(sound_root, cell)
    verdicts = {kind: compare.verdict(nums, c.limits)[0] for kind, _, nums in found}
    assert verdicts.pop("sound")
    assert set(verdicts) == set(faults.FAULTS) | {"control"}
    assert not any(verdicts.values()), verdicts


def test_toy_configurations_are_the_real_families():
    assert {c["family"] for c in CONFIGS.values()} == {"dense", "ssm"}
