"""What the harness runs loads no JAX and no JAX package, and the command
refuses to run without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_PROBE = r"""
import sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {src!r})
from bench import harness
from bench.tests import tiny
out = harness.run("qwen3.decode_b4_3k", 5, 0.5, False, device="cpu",
                  overrides=tiny.overrides("qwen3-1.7b", "closed"))
import bench.control, bench.sweep
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    # a tiny run on a machine busy with other tests: one thread
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_a_run_loads_no_jax_and_no_jax_package():
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]
                         .replace("'", '"')))
    assert "repro_torch" in top and "bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT))
    from bench import harness
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serving", "jaxtyping", "bench"]) == []
    assert harness.forbidden_modules(
        ["repro.models", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_the_command_fails_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be reached")
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen3.decode_b4_3k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
