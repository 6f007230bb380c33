"""The reference held against the port at tiny sizes of both
configurations, through the batcher and the engine (the same harness
code as a run on the card, with the plain kernels); the check's control
and faults planted under the timed path must come out not correct."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from bench import control, harness  # noqa: E402
from bench.tests import tiny  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.offload import TieredKVStore  # noqa: E402

PENDING = ROOT / "bench" / "pending"
CASES = [("qwen3.decode_b4_3k", "qwen3-1.7b", "closed", None),
         ("deepseek.admit_rag", "deepseek-v2-lite-16b", "open",
          PENDING / "deepseek.admit_rag.json")]
SEED = 2 ** 31 + 101
# the window of a tiny run: a closed loop's sessions decode to their end
# inside it (the run ends when they do), so what is judged does not hang
# on how fast a busy test machine runs; an open loop judges the requests
# due in its window, a fixed set of the schedule
WINDOW = {"closed": 120.0, "open": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    # a tiny run gains nothing from threads, and on a machine whose cores
    # other test processes hold, threads that wait on each other make a
    # run of seconds take minutes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gap_checks(cell, spec):
    """The gap numbers the cell compares, with their limits."""
    return {k: v["limit"] for k, v in harness.load_cell(cell, spec)["checks"]
            .items() if k.endswith("_gap")}


def _token(mp):
    # a served token altered where it is produced
    inner = engine_mod.BatchedLeoAMEngine.decode_round

    def altered(self, tokens):
        out = inner(self, tokens)
        return {sid: (t + 1) % self.cfg.vocab_size for sid, t in out.items()}
    mp.setattr(engine_mod.BatchedLeoAMEngine, "decode_round", altered)


def _stale_state(mp):
    # a round that leaves the sequences' K/V state unchanged: the new
    # token's row is never appended
    mp.setattr(TieredKVStore, "append_tokens_batch",
               lambda self, *a, **k: None)


def _no_sink(mp):
    # the evaluation drops the sink chunk from every selection
    inner = engine_mod.BatchedLeoAMEngine._select_chunks_batched

    def no_sink(self, *a, **k):
        sels, stats = inner(self, *a, **k)
        return {sid: [c for c in s if c != 0] or s
                for sid, s in sels.items()}, stats
    mp.setattr(engine_mod.BatchedLeoAMEngine, "_select_chunks_batched",
               no_sink)


def _b1_zero(mp):
    # kernel B1 returns no bounds: the evaluation ranks every chunk alike
    def zeros(q, kmax, kmin, **kw):
        z = torch.zeros(kmax.shape[0], kmax.shape[2], kmax.shape[1],
                        device=q.device)
        return z, z
    mp.setattr(engine_mod, "chunk_bounds_gqa_matmul", zeros)


FAULTS = {"token": _token, "stale_state": _stale_state, "no_sink": _no_sink,
          "b1_zero": _b1_zero}


@pytest.mark.parametrize("cell,config,kind,spec", CASES)
def test_reference_follows_the_port_exactly(cell, config, kind, spec):
    # float32 on both sides and exact rows in transit: a served token is
    # the reference's best but where rounding breaks a near tie, which
    # costs a hundredth of a row's spread at most; the reference's top
    # chunks are the program's but where rounding reorders near ties
    ov = tiny.overrides(config, kind)
    ov["port"]["engine"]["real_codec"] = False
    out = harness.run(cell, SEED, WINDOW[kind], False, device="cpu",
                      overrides=ov, keep=True, spec_file=spec)
    res = out["result"]
    assert res["served_compared"] >= 16
    for k in _gap_checks(cell, spec):
        assert res["checks"][k]["value"] <= 1e-2
    assert out["numbers"]["selection_miss_share"] <= 0.02
    assert res["correct"] and res["failed"] == 0


@pytest.mark.parametrize("cell,config,kind,spec", CASES)
def test_the_cell_as_configured_is_correct(cell, config, kind, spec):
    res = harness.run(cell, SEED + 1, WINDOW[kind], False, device="cpu",
                      overrides=tiny.overrides(config, kind),
                      spec_file=spec)["result"]
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("fault", ["token", "stale_state", "no_sink",
                                   "b1_zero"])
@pytest.mark.parametrize("cell,config,kind,spec", CASES[:1])
def test_a_broken_timed_path_is_not_correct(cell, config, kind, spec, fault,
                                            monkeypatch):
    FAULTS[fault](monkeypatch)
    res = harness.run(cell, SEED + 2, WINDOW[kind], False, device="cpu",
                      overrides=tiny.overrides(config, kind),
                      spec_file=spec)["result"]
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", ["token", "stale_state", "no_sink"])
@pytest.mark.parametrize("cell,config,kind,spec", CASES[1:])
def test_a_broken_timed_path_is_not_correct_pending(cell, config, kind, spec,
                                                    fault, monkeypatch):
    # the pending cell compares no evaluation number yet (its limit waits
    # for readings on the card), so B1's fault is not among its cases
    FAULTS[fault](monkeypatch)
    res = harness.run(cell, SEED + 2, WINDOW[kind], False, device="cpu",
                      overrides=tiny.overrides(config, kind),
                      spec_file=spec)["result"]
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell,config,kind,spec", CASES)
def test_the_float8_control_is_not_correct(cell, config, kind, spec):
    r = control.readings(cell, SEED + 3, WINDOW[kind], device="cpu",
                         overrides=tiny.overrides(config, kind),
                         spec_file=spec)
    assert r["correct"] and not r["control_correct"]
    assert any(r["control"][k] > lim
               for k, lim in _gap_checks(cell, spec).items())
