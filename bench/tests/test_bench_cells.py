"""Every cell of BENCHMARK.json loads into a runnable cell from the files
its names point to, and the file keeps to the benchmark's contract."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from bench import generator, harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
PENDING = sorted((ROOT / "bench" / "pending").glob("*.json"))
SPECS = [None] + PENDING
CELLS = [(w["name"], None) for w in SPEC["workloads"]] + \
    [(f.stem, f) for f in PENDING]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / SPEC["command"][1]).is_file()


@pytest.mark.parametrize("spec_file", SPECS)
def test_names_units_and_bounds(spec_file):
    spec = harness.load_spec(spec_file)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in spec["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("spec_file", SPECS)
def test_configs_are_files_under_paths(spec_file):
    for c in harness.load_spec(spec_file)["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("bench/")
        model = json.loads(f.read_text())
        assert model["source"] == c["source"]
        assert model["reduced"] == c["reduced"]
        assert all(k in model for k in c["reduced"])


@pytest.mark.parametrize("cell,spec_file", CELLS)
def test_cell_loads_and_runs_from_its_files(cell, spec_file):
    ctx = harness.load_cell(cell, spec_file)
    assert ctx["chips"] == 1
    arch = harness.build_arch(ctx["model"])
    m = ctx["model"]
    assert arch.n_layers == m["num_hidden_layers"]
    assert arch.d_model == m["hidden_size"]
    assert arch.vocab_size == m["vocab_size"]
    assert arch.norm_eps == m["rms_norm_eps"]
    if arch.mla is not None:
        assert arch.mla.kv_lora_rank == m["kv_lora_rank"]
        assert arch.moe.n_experts == m["n_routed_experts"]
        assert arch.moe.top_k == m["num_experts_per_tok"]
    else:
        assert arch.n_kv_heads == m["num_key_value_heads"]
        assert arch.d_ff == m["intermediate_size"]
    names = {x["name"] for x in ctx["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and ctx["per_layer"]
    for x in ctx["end_to_end"] + ctx["per_layer"]:
        assert callable(harness.load_metric(x["name"]))
    mix = ctx["mix"]
    plan = (generator.closed_sessions(mix, 1, arch.vocab_size,
                                      m["port"]["engine"]["max_len"])
            if mix["kind"] == "closed"
            else generator.open_arrivals(mix, 1, arch.vocab_size))
    assert plan and all(len(p.prompt) + p.max_new
                        < m["port"]["engine"]["max_len"] for p in plan)
    assert ctx["checks"]
    for lim in ctx["checks"].values():
        assert lim["lower"] <= lim["limit"] < lim["upper"]
        assert lim["upper"] >= 3 * lim["lower"]
