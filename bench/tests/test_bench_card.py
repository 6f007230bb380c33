"""On the card: one short run of each cell through the command itself,
correct and with every metric the cell reports."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    e2e = {m["name"] for m in SPEC["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == e2e
    assert list(line)[-1] == "checks"
