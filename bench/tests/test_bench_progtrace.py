"""The program's spans as the benchmark reads them: ``bench.progtrace`` on
synthetic kineto events and around a tiny CPU run; the engine's public
round record against the ``Recorder``'s selections and int4 holdings on
both tiny cells; the round part readers from a tiny CPU run."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from bench import harness, progtrace  # noqa: E402
from bench.tests import tiny  # noqa: E402

PENDING = ROOT / "bench" / "pending"
CASES = [("qwen3.decode_b4_3k", "qwen3-1.7b", "closed", None),
         ("deepseek.admit_rag", "deepseek-v2-lite-16b", "open",
          PENDING / "deepseek.admit_rag.json")]
SEED = 2 ** 31 + 201
WINDOW = {"closed": 120.0, "open": 1.0}
READERS = ("round_dense_ms.decode", "round_logits_ms.decode",
           "round_select_ms.decode", "round_wait_ms.decode",
           "round_append_ms.decode")
DECODE, WORKER = 1, 2

# device: four kernels, then one after the round; the host range
# ``leoam.round`` mirrored on the device timeline is no device work
DEV = [("k1", 0, 0, 10), ("k2", 0, 20, 30), ("k3", 0, 50, 60),
       ("k4", 0, 100, 110), ("k5", 0, 200, 210),
       ("leoam.round", 0, 5, 90)]
HOST = [("leoam.step", DECODE, 0, 150), ("leoam.round", DECODE, 2, 90),
        ("leoam.evaluate", DECODE, 12, 45),
        ("leoam.eval_select", DECODE, 13, 35),
        # a worker's span that opens later than the decode thread's
        # innermost one around the gap (10, 20)
        ("leoam.prefetch", WORKER, 14, 48),
        ("cudaLaunchKernel", DECODE, 3, 4),
        ("cuLaunchKernelEx", DECODE, 4, 5),
        ("cudaMemcpyAsync", DECODE, 6, 7),
        ("cudaMemsetAsync", DECODE, 8, 9),
        ("cudaStreamSynchronize", DECODE, 9, 10),
        ("cudaLaunchKernel", WORKER, 7, 8),
        ("cudaLaunchKernel", DECODE, 95, 96),
        # a round the trace's end cut: it ends after every start
        ("leoam.round", DECODE, 160, 400),
        ("cudaLaunchKernel", DECODE, 170, 171)]


def test_a_gap_goes_to_the_innermost_span_of_the_decode_thread():
    out = progtrace.analyze(DEV, HOST)
    gaps = dict(out["idle_gaps"])
    assert gaps == pytest.approx({
        "leoam.eval_select": 10e-9,        # (10, 20)
        "leoam.evaluate": 20e-9,           # (30, 50): midpoint 40
        "leoam.round": 40e-9,              # (60, 100): midpoint 80
        progtrace.OUTSIDE: 90e-9})         # (110, 200): midpoint 155
    assert out["idle_s"] == pytest.approx(160e-9)
    assert [n for n, _ in out["idle_gaps"]][0] == progtrace.OUTSIDE


def test_launches_are_counted_inside_complete_rounds_only():
    # the round's launches and queued copies and fills on its own thread;
    # not a sync, not a worker's launch, not one between rounds, and not
    # the cut round's
    assert progtrace.analyze(DEV, HOST)["round_launches"] == [4]


def test_a_program_without_spans_reads_no_round():
    host = [e for e in HOST if not e[0].startswith("leoam.")]
    out = progtrace.analyze([e for e in DEV if e[0] != "leoam.round"], host)
    assert out["round_launches"] == []
    assert [n for n, _ in out["idle_gaps"]] == [progtrace.OUTSIDE]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,config,kind,spec", CASES)
def test_round_record_equals_the_recorder(cell, config, kind, spec,
                                          monkeypatch):
    """The engine's ``on_round`` record, set before the first admission,
    against what the ``Recorder`` reads by wrapping the engine's private
    calls: the same selections and int4 row counts for every request and
    position."""
    seen = {}

    class Spy(harness.Recorder):
        def __init__(self, eng, batcher, spans):
            super().__init__(eng, batcher, spans)
            seen["rec"] = self
            sels, int4 = seen["sels"], seen["int4"] = {}, {}

            def on_round(r):
                rid = {sid: req.rid
                       for (req, sid, _) in batcher.active.values()}
                for sid in r.order:
                    L = r.lengths[sid]
                    sels.setdefault(rid[sid], {})[L] = r.selections[sid]
                    if r.int4.get(sid):
                        int4.setdefault(rid[sid], {})[L] = r.int4[sid]
            eng.on_round = on_round

    monkeypatch.setattr(harness, "Recorder", Spy)
    res = harness.run(cell, SEED, WINDOW[kind], True, device="cpu",
                      overrides=tiny.overrides(config, kind),
                      spec_file=spec)["result"]
    assert res["correct"], res["checks"]
    rec = seen["rec"]
    assert seen["sels"] == {rid: dict(v) for rid, v in rec.sels.items()}
    assert seen["int4"] == {rid: dict(v) for rid, v in rec.int4.items()}
    assert sum(len(v) for v in seen["int4"].values()) > 0
    if spec is None:
        # the round part readers read the tiny run's profiles
        got = res["metrics"]
        assert all(got[n]["value"] >= 0.0 for n in READERS)
        assert got["round_dense_ms.decode"]["value"] > 0.0


def test_traced_run_reads_no_session_off_the_card():
    """Off a CUDA device the harness traces nothing: the line is the
    harness's own, with ``program`` None, and the profiler's stop is the
    harness's again afterwards."""
    stop = progtrace.devtrace.stop
    res = progtrace.traced_run(
        "qwen3.decode_b4_3k", SEED + 1, WINDOW["closed"], device="cpu",
        overrides=tiny.overrides("qwen3-1.7b", "closed"))
    assert res["program"] is None
    assert res["correct"], res["checks"]
    assert "round_dense_ms.decode" in res["metrics"]
    assert progtrace.devtrace.stop is stop
