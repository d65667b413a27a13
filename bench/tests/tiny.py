"""A copy of the benchmark with toy cells added as files, for CPU tests.

The toy configurations keep the families of the real ones at widths a CPU
test can hold (a ring of 4 nodes, 8 sequences of 32 tokens); each toy cell
takes the limits of the real cell of its algorithm and family.
"""
from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[2]

CONFIGS = {
    "toy-dense": {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
                  "n_kv_heads": 2, "d_ff": 128, "vocab": 300, "rope_theta": 10000.0},
    "toy-ssm": {"family": "ssm", "n_layers": 2, "d_model": 64, "n_heads": 0, "n_kv_heads": 0,
                "d_ff": 0, "vocab": 300,
                "ssm": {"d_inner": 128, "d_state": 16, "n_heads": 4, "n_groups": 1, "chunk": 8}},
}
# toy cell -> (configuration, traffic, the real cell whose limits it takes)
CELLS = {
    "toy-dense.dcd-q4": ("toy-dense", {"algo": "dcd", "wire": "quant:4"},
                         "granite-3-2b-l1.dcd-q4.ring8"),
    "toy-ssm.dcd-q8": ("toy-ssm", {"algo": "dcd", "wire": "quant:8"},
                       "mamba2-370m-l12.dcd-q8.ring8.s1024"),
    "toy-dense.dpsgd": ("toy-dense", {"algo": "dpsgd", "wire": None},
                        "granite-3-2b-l1.dpsgd.ring8"),
}
# toy cells on ranks (gloo on the CPU, one process a node)
RANK_CELLS = {
    "toy-dense.dcd-q4-ranks": ("toy-dense", {"algo": "dcd", "wire": "quant:4",
                                             "backend": "nccl"},
                               "granite-3-2b-l1.dcd-q4.ring8"),
}
# the toy cells' own limits for a sound run: at these widths the program's
# bf16 reads loss gaps up to 5e-5 and norm gaps up to 3e-3 against the
# float32 reference (the real cells' limits are set from readings at their
# own sizes on the card)
TOY_LIMITS = {"token_mismatches": 0, "sent_bytes_gap": 0, "loss_gap": 1e-3,
              "grad_norm_gap": 2e-2, "change_norm_gap": 2e-2}
TRAFFIC = {"topology": "ring", "n_nodes": 4, "seq_len": 32, "global_batch": 8,
           "optimizer": "adamw", "weight_decay": 0.01, "lr": 0.003, "warmup": 20,
           "total_steps": 300, "drop_rate": 0.0, "gamma": 0.5}


def toy_root(dst: pathlib.Path, limits: dict = None) -> pathlib.Path:
    """``dst`` holding ``BENCHMARK.json`` and ``bench/`` with the toy cells
    added as files and entries; ``limits`` replaces every toy cell's."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    for name, cfg in CONFIGS.items():
        (dst / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "a CPU test", "reduced": [],
                                "file": f"bench/configs/{name}.json", "why": "a CPU test"})
    for cell, (config, traffic, real) in {**CELLS, **RANK_CELLS}.items():
        mix = cell.split(".", 1)[1]
        (dst / "bench" / "traffic" / f"toy-{mix}.json").write_text(
            json.dumps({**TRAFFIC, **traffic}))
        spec["workloads"].append({"name": cell, "config": config, "traffic": f"toy-{mix}",
                                  "chips": 4 if cell in RANK_CELLS else 1, "why": "a CPU test"})
        real_limits = ROOT / "bench" / "limits" / f"{real}.json"
        lim = limits or json.loads(real_limits.read_text()) if real_limits.is_file() else limits
        (dst / "bench" / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst
