"""The benchmark's command end to end: without a card it refuses to run; on
the card (``cuda`` marker) a short run of the first cell prints a correct
result line."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench.tests.tiny import ROOT

CELL = "granite-3-2b-l1.dcd-q4.ring8"


def _run(*args):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a GPU")


def test_without_a_card_no_result_and_a_failing_exit(no_card):
    out = _run("--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


def test_unknown_workload_is_refused():
    out = _run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    out = _run("--workload", CELL, "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {"tokens_per_s", "peak_mem_gib", "setup_s"}
