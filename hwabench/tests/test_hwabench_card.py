"""Each cell run on the card, as the benchmark's command runs it, for a
short window: the result line's keys and ``correct``. Marked ``cuda``;
the card is looked for inside a fixture, never at import."""
import json
import os
import subprocess
import sys

import pytest

from hwabench.harness import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKLOADS = [w["name"] for w in Bench(ROOT).manifest["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "hwabench/run.py", "--workload", workload,
         "--seed", "3141592653", "--seconds", "12", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert all(v["value"] <= 105 for k, v in line["metrics"].items()
                   if v["unit"] == "%")
