"""The benchmark's counts of operations and bytes against hand arithmetic,
and its reference wire's container bytes against the program's."""
from __future__ import annotations

import json
import math

import pytest
import torch

from repro_torch.distributed.wire import make_wire_format

from bench import cells, weights, yardstick
from bench.reference import wire
from bench.tests.tiny import CONFIGS, ROOT


def test_matmul_params_and_flops_of_toy_shapes():
    dense, ssm = CONFIGS["toy-dense"], CONFIGS["toy-ssm"]
    # per layer: q, k, v (64 x (4 + 2 + 2) x 16), o (64 x 64), SwiGLU (3 x 64 x 128);
    # LM head 64 x 512 (300 padded to 512)
    assert yardstick.matmul_params(dense) == 2 * (8192 + 4096 + 24576) + 32768
    assert yardstick.model_flops_per_token(dense, 32) == 6 * 106496 + 2 * 12 * 32 * 64
    # per layer: z, x (64 x 128 each), BC (64 x 32), dt (64 x 4), out (128 x 64)
    assert yardstick.matmul_params(ssm) == 2 * (64 * 292 + 8192) + 32768
    chunk = 2 * 8 * 16 * 4 + 2 * 8 * 4 * 32 + 4 * 4 * 32 * 16
    assert yardstick.model_flops_per_token(ssm, 32) == 6 * 86528 + 2 * 3 * chunk


@pytest.mark.parametrize("name", ["granite-3-2b-l1", "mamba2-370m-l12"])
def test_weights_hold_the_configurations_parameters(name):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    total = sum(math.prod(shape) for shape, _ in weights.layout(cfg).values())
    assert total == cfg["params_per_node"]


def test_wire_kernel_work_by_hand():
    shape = (2, 3, 100)     # 6 rows of one block: 104 (4-bit groups of 8), 100 (int8)
    q4 = 2400 + (312 + 24) + 3 * ((312 + 24) + 2 * 2400), 8 * 624 + 3 * 3 * 624
    q8 = 2400 + (600 + 24) + 3 * ((600 + 24) + 2400), 8 * 600 + 3 * (600 + 6)
    assert yardstick.wire_kernel_work([shape], {"algo": "dcd", "wire": "quant:4"}) == q4
    assert yardstick.wire_kernel_work([shape], {"algo": "dcd", "wire": "quant:8"}) == q8
    assert yardstick.wire_kernel_work([shape], {"algo": "dpsgd", "wire": None}) == (0, 0)


def test_bound_seconds_is_the_larger_term():
    assert yardstick.bound_seconds(3.35e12) == pytest.approx(1.0)
    assert yardstick.bound_seconds(0, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("spec", ["quant:4", "quant:8", "quant:3"])
@pytest.mark.parametrize("shape", [(8, 2048), (8, 1, 49408), (8, 4, 3, 100), (4, 7)])
def test_reference_container_bytes_equal_the_programs(spec, shape):
    program = make_wire_format(spec).wire_nbytes({"x": torch.empty(shape, device="meta")})
    assert wire.container_bytes(wire.parse(spec), shape) == program


def test_idle_share_divides_by_the_unprofiled_steps():
    """Busy seconds a profiled step over the window's mean step, not over the
    profiled steps' own (stretched) host window."""
    read = cells.metric_reader(ROOT, "device.idle_share")
    rec = {"profile": {"busy_s": 0.9, "steps": 2, "window_s": 2.1}, "step_s": [0.6, 0.8]}
    assert read(rec) == pytest.approx(100 * (1 - 0.45 / 0.7))
    assert read({"profile": None, "step_s": [0.6]}) is None
