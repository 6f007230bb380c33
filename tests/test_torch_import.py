"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor any module of the JAX package ``repro``, no source file
imports them — nor do ``chip_smoke.py`` and the card-only kernel tests,
which run where there is no JAX — and entry points refuse to drift onto
the CPU when no CUDA device is there and the caller did not ask for the
CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
# files outside the package that run on the card's machine, which has no JAX
CARD_SCRIPTS = (ROOT / "chip_smoke.py",
                ROOT / "tests" / "test_torch_kernels_cuda.py")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k.startswith("jaxlib.") or k == "repro"
             or k.startswith("repro."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _banned(module: str) -> bool:
    return any(module == p or module.startswith(p + ".")
               for p in ("jax", "jaxlib", "repro"))


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 25, res.stdout


_PROBE_ONE = """
import sys
import repro_torch.serving.overload, repro_torch.serving.trace
from repro_torch.serving.overload import LoadHarness, PressureMonitor
from repro_torch.serving.trace import gen_trace
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_overload_and_trace_copies_load_no_jax_and_no_repro():
    """The framework-free copies of the reference's overload harness and
    trace generator stand alone."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    res = subprocess.run([sys.executable, "-c", _PROBE_ONE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax_or_repro():
    offenders = []
    paths = [*PORT.rglob("*.py"), *CARD_SCRIPTS]
    # the in-model decode path and the port's quickstart are scanned too
    for rel in ("core/abstracts.py", "core/sparse_attention.py",
                "models/attention.py", "launch/quickstart.py"):
        assert PORT / rel in paths, rel
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                offenders += [(path.name, a.name) for a in node.names
                              if _banned(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level == 0 and _banned(node.module):
                    offenders.append((path.name, node.module))
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value.startswith(("repro.", "jax")):
                # importlib.import_module(f"repro.configs...") style strings
                offenders.append((path.name, node.value))
    assert not offenders, offenders


def test_entry_points_raise_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    from repro_torch.serving.offload import TieredKVStore
    cfg = get_config("longchat-7b-32k", smoke=True)
    cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, chunk_size=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(cfg, seed=0)
    params = lm.init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedLeoAMEngine(cfg, params, EngineCfg(max_len=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TieredKVStore(1, 4, 16, 2, 8, use_pool=True)
