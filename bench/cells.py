"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A workload names a configuration and a traffic mix; the configuration's
entry names its file, whose ``family`` is ``bench/families/<family>.py``;
the mix is ``bench/traffic/<traffic>.json``, the limits of its comparison
``bench/limits/<workload>.json``, and each per-layer metric is read by
``bench/metrics/<metric>.py``'s ``read``.  Adding a cell, a configuration,
a model family or a metric adds files and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``; ``KeyError`` when
    it names none."""
    spec = load_benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "bench"
    config = json.loads((root / conf["file"]).read_text())
    config["bench_root"] = str(root)     # where its family's file is found
    return Cell(
        name=workload,
        config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        limits=json.loads((bench / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
    )


def metric_reader(root: pathlib.Path, name: str) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(root: pathlib.Path, metrics: List[dict], record: dict) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read in ``record``."""
    out = {}
    for m in metrics:
        value = metric_reader(root, m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
