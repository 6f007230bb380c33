"""The engine's round parts, its profiler spans and its public round record
(``on_round``), on the qwen3 smoke config at float32 (chunk 8, ``max_len``
128, int4 transit payloads on the wire):

- the record changes nothing: with the hook set and unset the tokens, the
  ``TrafficLog`` and the store's bytes are identical;
- each round's record: its order and lengths, a selection for every
  sequence and layer, int4 row counts that the pool holds, and the
  round's ``round_profiles`` entry;
- with no profiler session a round, an admission and the workers open no
  ``record_function``;
- under a CPU profiler (every thread) each ``leoam.*`` span appears,
  nested as ``serving/spans.py`` lists;
- the round's parts: each >= 0, the disjoint ones within ``total_s``,
  evaluate's four within 1 % of ``eval_s``;
- the store lock's wait clock times only a contended acquire.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import spans
from repro_torch.serving.engine import (ROUND_KEYS, ROUND_PARTS,
                                        BatchedLeoAMEngine, EngineCfg,
                                        RoundRecord)
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SchedulerCfg)

MAX_LEN, LENS, ROUNDS = 128, (97, 110), 6


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-1.7b", smoke=True)
    cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, importance_rate=0.3))
    params = lm.init(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(11)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in LENS]
    return cfg, params, prompts


def _engine(setup, **kw):
    cfg, params, _ = setup
    ecfg = dict(max_len=MAX_LEN, real_codec=True)
    ecfg.update(kw)
    return BatchedLeoAMEngine(cfg, params, EngineCfg(**ecfg),
                              max_seqs=len(LENS), device="cpu")


def _serve(setup, hook, **kw):
    eng = _engine(setup, **kw)
    records = []
    if hook:
        eng.on_round = records.append
    toks = {}
    for p in setup[2]:
        sid, tok = eng.add_sequence(p)
        toks[sid] = tok
    out = {sid: [t] for sid, t in toks.items()}
    for _ in range(ROUNDS):
        toks = eng.decode_round(toks)
        for sid, t in toks.items():
            out[sid].append(t)
    st = eng.store
    st.ingest_fence_all()
    st.requant_fence()
    res = dict(streams=out, bytes=dict(st.log.bytes), ops=dict(st.log.ops),
               disk=np.array(st._disk),
               pools=[p.kv.clone() for p in st.pools if p is not None],
               int4=[p.int4 for p in st.pools if p is not None],
               records=records,
               profiles=list(eng.round_profiles))
    st.close()
    return res


_RUNS = {}


def _run(setup, hook, **kw):
    key = (hook, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _serve(setup, hook, **kw)
    return _RUNS[key]


def test_round_record_changes_nothing(setup):
    on, off = _run(setup, True), _run(setup, False)
    assert on["streams"] == off["streams"]
    assert on["bytes"] == off["bytes"] and on["ops"] == off["ops"]
    np.testing.assert_array_equal(on["disk"], off["disk"])
    for a, b in zip(on["pools"], off["pools"]):
        assert torch.equal(a, b)
    # unset, the pools keep no int4 record
    assert all(r is None for r in off["int4"])
    assert not off["records"]


def test_round_record_holds_the_round(setup):
    res = _run(setup, True)
    recs, profiles = res["records"], res["profiles"]
    assert len(recs) == ROUNDS
    n_layers = setup[0].n_layers
    held = 0
    for r, (rec, prof) in enumerate(zip(recs, profiles)):
        assert isinstance(rec, RoundRecord)
        assert rec.order == sorted(rec.order) and len(rec.order) == 2
        assert rec.profile is prof
        for i, sid in enumerate(rec.order):
            L = rec.lengths[sid]
            assert L == LENS[i] + r
            nv = -(-L // 8)
            assert sorted(rec.selections[sid]) == list(range(n_layers))
            for li, sel in rec.selections[sid].items():
                assert sel == sorted(set(sel)) and 0 <= min(sel) \
                    and max(sel) < nv
            for li, h4 in rec.int4.get(sid, {}).items():
                assert set(h4) <= set(rec.selections[sid][li])
                for c, rows in h4.items():
                    # a chunk holds the rows it had at its codec upload
                    assert 1 <= rows <= min(8, L - c * 8)
                    held += 1
    assert held > 0


def test_no_profiler_opens_no_range(setup, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not spans.active()
    # an admission, the scheduler's step, the round (the prefetch and the
    # write-behind ingest run on the workers) and a chunked admission
    eng = _engine(setup)
    b = ContinuousBatcher(engine=eng, cfg=SchedulerCfg(max_active=2))
    b.submit(Request(rid=0, prompt=setup[2][0], max_new=4))
    b.run()
    assert b.finished[0].error is None and len(b.finished[0].out) == 4
    adm = eng.begin_admission(setup[2][1])
    sid, tok = adm.drain()
    eng.decode_round({sid: tok})
    eng.store.ingest_fence_all()
    eng.store.close()


# the innermost enclosing span each span opens in (None: a worker's
# outermost)
NESTING = {
    "leoam.step": None, "leoam.round": "leoam.step",
    "leoam.dense": "leoam.round", "leoam.evaluate": "leoam.round",
    "leoam.eval_wait": "leoam.evaluate", "leoam.eval_read": "leoam.evaluate",
    "leoam.eval_bounds": "leoam.evaluate",
    "leoam.eval_select": "leoam.evaluate",
    "leoam.fetch": "leoam.round", "leoam.gather": "leoam.fetch",
    "leoam.upload": "leoam.fetch", "leoam.append": "leoam.round",
    "leoam.append_copy": "leoam.append", "leoam.append_store": "leoam.append",
    "leoam.logits": "leoam.round", "leoam.admit": "leoam.step",
    "leoam.prefill": "leoam.admit", "leoam.ingest": "leoam.admit",
    "leoam.ingest_cast": "leoam.ingest", "leoam.prefetch": None,
    "leoam.ingest_cold": None, "leoam.crc": "leoam.ingest_cold",
    "leoam.write": "leoam.ingest_cold"}


def _parents(events):
    """{span: {innermost enclosing leoam span on its thread}}."""
    out = {}
    for name, tid, a, b in events:
        best = None
        for n2, t2, a2, b2 in events:
            if t2 == tid and (a2, b2) != (a, b) and a2 <= a and b <= b2 \
                    and (best is None or a2 >= best[1]):
                best = (n2, a2)
        out.setdefault(name, set()).add(best and best[0])
    return out


def test_spans_nest_under_a_cpu_profiler(setup):
    # a hot set of every chunk predicts the disk tier's chunks in the
    # first round, so the prefetch worker runs
    eng = _engine(setup, hot_frac=1.0)
    b = ContinuousBatcher(engine=eng, cfg=SchedulerCfg(max_active=2))
    for i, p in enumerate(setup[2]):
        b.submit(Request(rid=i, prompt=p, max_new=4))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(
            activities=acts, experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        assert spans.active()
        b.run()
        eng.store.ingest_fence_all()
    assert not spans.active()
    eng.store.close()
    events = [(e.name(), e.start_thread_id(), e.start_ns(),
               e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("leoam.")]
    parents = _parents(events)
    assert set(parents) == set(NESTING)
    for name, want in NESTING.items():
        assert parents[name] == {want}, (name, parents[name])


@pytest.mark.parametrize("pooled", [True, False])
def test_round_parts_add_up(setup, pooled):
    res = _run(setup, False, pooled=pooled)
    for p in res["profiles"]:
        assert sorted(p) == sorted(ROUND_KEYS)
        assert all(v >= 0.0 for v in p.values())
        assert sum(p[k] for k in ROUND_PARTS) <= p["total_s"]
        split = p["eval_wait_s"] + p["eval_read_s"] + p["eval_bounds_s"] \
            + p["eval_select_s"]
        assert abs(split - p["eval_s"]) <= 0.01 * p["eval_s"]
        assert p["dense_s"] > 0 and p["logits_s"] > 0
        assert p["append_copy_s"] > 0 and p["append_store_s"] > 0
        assert 0 <= p["spec_misses"] <= setup[0].n_layers
        assert p["spec_misses"] == int(p["spec_misses"])


def test_lock_wait_times_only_a_contended_acquire():
    lock = spans.WaitTimedLock(threading.RLock())
    with lock:
        with lock:                   # reentrant: the first try succeeds
            pass
    assert lock.wait_s == 0.0
    held, go = threading.Event(), threading.Event()

    def hold():
        with lock:
            held.set()
            go.wait(10)
            time.sleep(0.05)
    t = threading.Thread(target=hold, name="other")
    t.start()
    assert held.wait(10)
    go.set()
    with lock:
        pass
    t.join(10)
    assert not t.is_alive()
    assert lock.wait_s >= 0.04
    # a serving worker's wait is not the decode thread's
    before = lock.wait_s
    held.clear()
    go.clear()
    t = threading.Thread(target=hold, name="other")
    t.start()
    assert held.wait(10)
    go.set()
    w = threading.Thread(target=lambda: lock.acquire() and lock.release(),
                         name="leoam-test")
    w.start()
    w.join(10)
    t.join(10)
    assert not w.is_alive() and not t.is_alive()
    assert lock.wait_s == before
