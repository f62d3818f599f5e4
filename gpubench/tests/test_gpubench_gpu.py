"""On the card: each cell runs as the benchmark's command and is correct,
and its control, at the cell's own size, is not. Skips without a card.

    python -m pytest -m gpu gpubench/tests/test_gpubench_gpu.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, *extra):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "2", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(card, cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    r = _run(cell, "--control")
    assert not r["correct"], r["checks"]
