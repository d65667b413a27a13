"""The model families as files (``bench/families/``) read what the code
before them read: ``golden.json`` holds, from the tree before the move, the
toy configurations' weights (a digest a leaf), the real configurations'
layouts (shapes, order and inits), each cell's operation and byte counts,
and the reference's first steps on the toy cells, bit for bit."""
from __future__ import annotations

import hashlib
import json
import pathlib
import types

import pytest
import torch

from repro_torch.configs.base import MLASpec, MoESpec

from bench import families, harness, weights, yardstick
from bench.reference import train
from bench.tests.tiny import CELLS, CONFIGS, ROOT, TRAFFIC

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden.json").read_text())
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
REFERENCE_SEED = 2 ** 31 + 17


def _config(name: str) -> dict:
    conf = {c["name"]: c for c in SPEC["configs"]}[name]
    return json.loads((ROOT / conf["file"]).read_text())


def _init(init) -> str:
    if isinstance(init, str):
        return init
    return init.__name__ if callable(init) else float(init).hex()


@pytest.mark.parametrize("key", sorted(GOLDEN["weights"]))
def test_weights_are_the_same_bits(key):
    name, seed = key.split("@")
    leaves = train.leaf_items(weights.make(CONFIGS[name], int(seed), "cpu"))
    got = {p: hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()[:32]
           for p, x in leaves}
    assert got == GOLDEN["weights"][key]


@pytest.mark.parametrize("name", sorted(GOLDEN["layouts"]))
def test_layouts_keep_shapes_order_and_inits(name):
    got = [[p, list(shape), _init(init)] for p, (shape, init) in
           weights.layout(_config(name)).items()]
    assert got == GOLDEN["layouts"][name]


@pytest.mark.parametrize("workload", sorted(GOLDEN["yardstick"]))
def test_operation_and_byte_counts_are_unchanged(workload):
    w = {c["name"]: c for c in SPEC["workloads"]}[workload]
    cfg = _config(w["config"])
    tr = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    lead = (1,) if "backend" in tr else (tr["n_nodes"],)
    shapes = [lead + tuple(shape) for _, (shape, _) in sorted(weights.layout(cfg).items())]
    nbytes, ops = yardstick.wire_kernel_work(shapes, tr)
    assert {"matmul_params": yardstick.matmul_params(cfg),
            "model_flops_per_token": yardstick.model_flops_per_token(cfg, tr["seq_len"]).hex(),
            "wire_kernel_work": [nbytes, ops],
            "wire_bound_s": float(yardstick.bound_seconds(nbytes, ops)).hex()} \
        == GOLDEN["yardstick"][workload]


@pytest.fixture
def one_thread():
    """The golden readings were taken on one thread: the CPU's matrix
    products sum in another order on more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("key", sorted(GOLDEN["reference"]))
def test_reference_first_steps_are_the_same_bits(key, one_thread):
    cell, precision = key.split("@")
    config, traffic, _ = CELLS[cell]
    cfg = CONFIGS[config]
    params0 = weights.make(cfg, REFERENCE_SEED, "cpu")
    rec = train.run(cfg, {**TRAFFIC, **traffic}, REFERENCE_SEED, params0, 3, "cpu", precision)
    assert {"losses": [float(x).hex() for x in rec["losses"]],
            "grad_norms": {p: float(v).hex() for p, v in rec["grad_norms"].items()},
            "change_norms": {p: float(v).hex() for p, v in rec["change_norms"].items()},
            "sent_bytes": rec["sent_bytes"]} == GOLDEN["reference"][key]


def test_every_configuration_names_a_family_file():
    for conf in SPEC["configs"]:
        assert families.get(_config(conf["name"])["family"]).__file__


def test_an_unknown_family_raises_naming_the_files():
    with pytest.raises(ValueError) as err:
        families.get("no-such-family")
    assert "no-such-family" in str(err.value)
    assert "'dense.py'" in str(err.value) and "'ssm.py'" in str(err.value)
    with pytest.raises(ValueError):
        weights.layout({**CONFIGS["toy-dense"], "family": "no-such-family"})


def test_arch_turns_each_nested_dict_into_its_spec(monkeypatch):
    """A family's ``arch`` gives plain values; the harness builds the
    program's spec class of each nested dict's field (a list as a tuple)."""
    mla = {"kv_lora": 512, "qk_nope": 128, "qk_rope": 64, "v_head": 128}
    moe = {"n_routed": 8, "n_shared": 2, "top_k": 6, "d_expert": 1408, "dense_layers": [0],
           "d_ff_dense": 10944}
    stub = types.SimpleNamespace(arch=lambda cfg: {"mla": mla, "moe": moe, "head_dim": 192})
    monkeypatch.setattr(families, "of", lambda cfg: stub)
    cell = types.SimpleNamespace(config_name="t", config={**CONFIGS["toy-dense"], "family": "moe"})
    arch = harness.arch_config(cell)
    assert arch.mla == MLASpec(**mla) and arch.head_dim == 192 and arch.ssm is None
    assert arch.moe == MoESpec(**{**moe, "dense_layers": (0,)})
