"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell, a configuration, a traffic mix and a metric added as files."""
from __future__ import annotations

import json
import re
import shutil
import time

import pytest

from bench import cells, run
from bench.tests.tiny import CONFIGS, ROOT, TOY_LIMITS, toy_root

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"] and SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [e["why"] for e in SPEC["configs"] + SPEC["workloads"]] + \
            [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_cells_configs_and_metric_files():
    confs = {c["name"]: c for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(confs)
    for c in confs.values():
        f = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/") and f["reduced"] == c["reduced"]
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        cell = cells.find(ROOT, w["name"])
        assert cell.chips in (1, 4) and cell.limits
        assert any(m["name"] != "setup_s" for m in cell.end_to_end) and cell.per_layer
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()


def test_files_added_in_a_copy_are_found(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added as
    files and entries only: the harness runs the cell and reports the metric."""
    root = toy_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench" / "metrics" / "toy.steps_in_window.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    spec["per_layer"].append({"name": "toy.steps_in_window", "unit": "steps",
                              "better": "higher", "source": "host_clock", "layer": "step",
                              "moves": "tokens_per_s", "workloads": ["toy-dense.dcd-q4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    traced = run.run(root, "toy-dense.dcd-q4", 11, 0.5, trace=True, device="cpu", started=t0)
    assert traced["metrics"]["toy.steps_in_window"]["value"] >= 1
    assert "breakdown" in traced and list(traced)[-1] == "checks"
    plain = run.run(root, "toy-dense.dcd-q4", 11, 0.5, trace=False, device="cpu", started=t0)
    assert set(plain["metrics"]) == {"tokens_per_s", "setup_s"}   # no card: no peak
    with pytest.raises(KeyError):
        cells.find(root, "toy-dense.no-such-mix")


def test_a_family_added_as_a_file_is_found(tmp_path):
    """A model family, a configuration of it and a cell, added as files and
    entries only: the family file, a copy of ``dense.py`` under another name,
    is read from the copy of the benchmark, and the cell judges as the toy
    dense cell it copies."""
    root = toy_root(tmp_path, TOY_LIMITS)
    shutil.copy(root / "bench" / "families" / "dense.py",
                root / "bench" / "families" / "dense_copy.py")
    cfg = {**CONFIGS["toy-dense"], "family": "dense_copy"}
    (root / "bench" / "configs" / "toy-copy.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-copy", "source": "a CPU test", "reduced": [],
                            "file": "bench/configs/toy-copy.json", "why": "a CPU test"})
    spec["workloads"].append({"name": "toy-copy.dcd-q4", "config": "toy-copy",
                              "traffic": "toy-dcd-q4", "chips": 1, "why": "a CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(root / "bench" / "limits" / "toy-dense.dcd-q4.json",
                root / "bench" / "limits" / "toy-copy.dcd-q4.json")
    got = [run.run(root, cell, 13, 0.2, trace=False, device="cpu", started=time.perf_counter())
           for cell in ("toy-copy.dcd-q4", "toy-dense.dcd-q4")]
    assert [r["correct"] for r in got] == [True, True]
    assert got[0]["checks"] == got[1]["checks"]
    assert cells.find(root, "toy-copy.dcd-q4").config["family"] == "dense_copy"
