"""Chaos tests of the port's engine: seeded fault injection against
``BatchedLeoAMEngine`` and ``ContinuousBatcher`` on the CPU.  Ported from
``tests/test_chaos_engine.py`` (all but
``test_failed_seq_releases_prefix_refcounts``, which waits for the prefix
cache, ROADMAP A8); the port's engines run with ``debug_sync=False`` (the
sync sanitizer is A13).

- a seeded :class:`FaultPlan` (disk I/O errors, latency, sidecar
  bit-flips, worker exceptions) may degrade or fail single sequences, but
  every request that finishes clean is token-identical to the fault-free
  run, and nothing leaks: engine slots, ingest futures, pool slots,
  request accounting;
- each containment path once: replica loss recomputed from the prompt
  (token-identical), an ingest failure contained to its sequence, release
  after a failed ingest, ``pq_read`` errors and bitflips, a deadline and a
  bounded queue.

The last test runs one fixed chaos seed through both packages' engines
(same weights via ``params_from_jax``): terminal states, fault counters,
fired events, TrafficLogs and token streams must be equal.
"""

import dataclasses
from collections import defaultdict
from concurrent.futures import Future

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serving.engine import BatchedLeoAMEngine as JEngine
from repro.serving.engine import EngineCfg as JCfg
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerCfg as JSched
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.offload import DISK
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SchedulerCfg)

_SETUP = {}


def _cfg(get):
    cfg = get("longchat-7b-32k", smoke=True)
    return dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=16,
                                       importance_rate=0.4, early_rate=0.6,
                                       min_seq_for_sparse=32))


def _setup():
    if not _SETUP:
        cfg = _cfg(get_config)
        params = jlm.init(cfg, jax.random.PRNGKey(1))
        _SETUP.update(
            jcfg=cfg, jparams=params, cfg=_cfg(t_get_config),
            params=params_from_jax(jax.tree.map(np.asarray, params), "cpu"))
        rng = np.random.RandomState(7)
        _SETUP["prompts"] = [rng.randint(2, cfg.vocab_size, n)
                             for n in (48, 57, 64)]
    return _SETUP["cfg"], _SETUP["params"], _SETUP["prompts"]


def _engine(cfg, params, *, plan=None, **ecfg_kw):
    return BatchedLeoAMEngine(
        cfg, params,
        EngineCfg(max_len=128, selection="tree", disk_sidecar=True,
                  fault_plan=plan, io_backoff_s=0.0, **ecfg_kw),
        max_seqs=2, device="cpu")


def _drive(plan=None, *, max_new=3, scfg_kw=None, req_kw=None,
           ecfg_kw=None):
    """Run 3 requests through the batcher; returns (finished + rejected
    requests, batcher, engine) with the store still open for the leak
    checks."""
    cfg, params, prompts = _setup()
    eng = _engine(cfg, params, plan=plan, **(ecfg_kw or {}))
    kw = dict(max_active=2, chunk=16, overlap_admission=True)
    kw.update(scfg_kw or {})
    b = ContinuousBatcher(cfg=SchedulerCfg(**kw), engine=eng)
    for i, p in enumerate(prompts):
        b.submit(Request(i, p, max_new=max_new, **((req_kw or {}).get(i, {}))))
    finished = b.run()
    return list(finished) + list(b.rejected), b, eng


def _assert_no_leaks(b, eng):
    assert sorted(eng._free) == list(range(eng.max_seqs))
    assert not eng.seqs
    assert all(not futs for futs in eng.store._ingest_futs.values())
    ps = eng.store.pool_stats()
    if ps.get("slots"):
        assert ps["free_slots"] == ps["slots"], ps
    stats = b.stats()
    assert stats["requests_cancelled"] == float(b._requests_cancelled)
    assert stats["requests_rejected"] == float(b._requests_rejected)


_REF = {}


def _reference():
    if "out" not in _REF:
        reqs, b, eng = _drive(None)
        assert all(r.error is None and not r.degraded for r in reqs)
        _assert_no_leaks(b, eng)
        eng.store.close()
        _REF["out"] = {r.rid: list(r.out) for r in reqs}
    return _REF["out"]


# ---------------------------------------------------------------------------
# the chaos property
# ---------------------------------------------------------------------------

@pytest.mark.chaos
@settings(max_examples=5, deadline=None)
@given(hst.integers(min_value=0, max_value=31))
def test_chaos_fault_containment(seed):
    """Seeded fault schedules: every request reaches a terminal state,
    clean non-degraded requests are token-identical to the fault-free run,
    and nothing leaks."""
    ref = _reference()
    plan = FaultPlan.from_seed(seed, rate=0.04, horizon=300,
                               latency_s=1e-3)
    reqs, b, eng = _drive(plan)
    try:
        assert {r.rid for r in reqs} == set(ref)
        # a bitflip's victim row (event key[0]) is AFFECTED: a flip on an
        # append-dirtied replica chunk is served unverified by design (the
        # requant sweep revalidates it later), so only unaffected
        # sequences owe token identity
        hit_rows = {ev.key[0] for ev in plan.fired_events()
                    if ev.kind == "bitflip" and ev.key is not None}
        for r in reqs:
            assert r.t_done is not None
            if r.error is None and not r.degraded and r.sid not in hit_rows:
                assert list(r.out) == ref[r.rid], \
                    (seed, r.rid, plan.fired_events())
        _assert_no_leaks(b, eng)
        fs = eng.fault_stats()
        value_faults = [e for e in plan.fired_events()
                        if e.kind in ("io_error", "exception")]
        if value_faults:
            assert (fs["io_retries"] + fs["checksum_failures"]
                    + fs["seqs_failed"] + eng.ingest_errors) > 0, \
                (seed, value_faults, fs)
    finally:
        eng.store.close()


# ---------------------------------------------------------------------------
# deterministic containment instances
# ---------------------------------------------------------------------------

def _corrupt_chunk(eng, sid, c):
    """Change a replica value of ``sid``'s chunk ``c`` in every layer and
    drop its hot copies, so the next fetch reads the replica."""
    st = eng.store
    for li in range(len(eng.attn_layers)):
        st._disk[sid, li, c, 0].reshape(-1)[0] += np.float16(1.0)
        st._sidecar_valid[sid, li, c] = False
        st._host_k.pop((sid, li, c), None)
        st._host_v.pop((sid, li, c), None)
        st.tier[sid, li, c] = DISK
        pool = st.pools[li] if st.use_pool else None
        if pool is not None:
            slot = pool.slot_of.pop((sid, c), None)
            if slot is not None:
                pool.free.append(slot)


@pytest.mark.chaos
def test_replica_loss_recovers_token_identical():
    """A corrupted prompt-span replica mid-stream takes the checksum ->
    ChunkLostError -> recompute-from-prompt path; every sequence's stream
    (the recovered one's too) stays token-identical."""
    cfg, params, prompts = _setup()
    # dense selection so the corrupted chunk is fetched every round
    cfg = dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, min_seq_for_sparse=256))

    def run(corrupt):
        eng = _engine(cfg, params)
        toks = {}
        for p in prompts[:2]:
            sid, tok = eng.add_sequence(p)
            toks[sid] = tok
        out = {sid: [] for sid in toks}
        for rnd in range(4):
            if rnd == 1 and corrupt:
                _corrupt_chunk(eng, 0, 0)
            toks = eng.decode_round(toks)
            for sid, t in toks.items():
                out[sid].append(t)
        fs = eng.fault_stats()
        eng.store.close()
        return out, fs

    want, fs0 = run(corrupt=False)
    got, fs1 = run(corrupt=True)
    assert got == want
    assert fs0["chunks_recomputed"] == 0 and fs0["seqs_failed"] == 0
    assert fs1["chunks_recomputed"] >= 1, fs1
    assert fs1["seqs_failed"] == 0 and fs1["disk_lost"] == 0


@pytest.mark.chaos
def test_ingest_failure_contained_to_one_seq():
    """A failed cold-ingest future is ONE sequence's terminal state at
    its fence; the other live sequence's stream is untouched."""
    cfg, params, prompts = _setup()

    def run(poison):
        eng = _engine(cfg, params)
        sids = []
        toks = {}
        for p in prompts[:2]:
            sid, tok = eng.add_sequence(p)
            sids.append(sid)
            toks[sid] = tok
        out = {sid: [] for sid in sids}
        for rnd in range(3):
            if rnd == 1 and poison:
                f = Future()
                f.set_exception(RuntimeError("worker died mid-ingest"))
                with eng.store._futs_lock:
                    eng.store._ingest_futs[sids[0]].append(f)
            toks = eng.decode_round(toks)
            for sid, t in toks.items():
                out[sid].append(t)
        state = (dict(eng.failed), eng.seqs_failed, sorted(eng._free))
        for sid in list(toks):
            eng.release(sid)
        eng.store.close()
        return out, state

    want, _ = run(poison=False)
    got, (failed, n_failed, free_mid) = run(poison=True)
    sid0, sid1 = sorted(want)
    assert got[sid1] == want[sid1]            # survivor: token-identical
    assert got[sid0] == want[sid0][:1]        # failed after round 1
    assert sid0 in failed and "worker died" in failed[sid0]
    assert n_failed == 1
    assert sid0 in free_mid                   # slot recycled at once


@pytest.mark.chaos
def test_release_survives_failed_ingest():
    """release() drains, counts and recycles a slot whose write-behind
    ingest failed."""
    cfg, params, prompts = _setup()
    eng = _engine(cfg, params)
    sid, _ = eng.add_sequence(prompts[0])
    f = Future()
    f.set_exception(RuntimeError("disk died"))
    with eng.store._futs_lock:
        eng.store._ingest_futs[sid].append(f)
    eng.release(sid)                          # must not raise
    assert eng.ingest_errors == 1
    assert sid in eng._free and sid not in eng.seqs
    sid2, _ = eng.add_sequence(prompts[1])    # the slot is reusable
    eng.release(sid2)
    eng.store.close()


def _ledger_balanced(eng):
    """Shared traffic log == Σ live seq_logs + Σ retired_logs, key by key
    (degradation paths keep billing exact)."""
    want = defaultdict(float)
    for lg in list(eng.store.seq_logs.values()) + list(eng.store.retired_logs):
        for key, v in lg.bytes.items():
            want[key] += v
    got = eng.store.log.bytes
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key]), key


@pytest.mark.chaos
def test_pq_read_io_errors_degrade_bitwise_to_minmax():
    """Persistent ``pq_read`` io_errors exhaust the retry budget every
    round; ADC selection degrades to the min/max bounds, so the PQ
    engine's streams are token-identical to the min/max engine's.
    Degradations are billed ``abstract``, the ledger balances and no slot
    leaks."""
    ref = _reference()
    plan = FaultPlan(schedule={"pq_read": {i: "io_error"
                                           for i in range(4000)}})
    reqs, b, eng = _drive(plan, ecfg_kw={"pq_abstracts": True})
    try:
        assert {r.rid for r in reqs} == set(ref)
        for r in reqs:
            assert r.error is None and not r.degraded, (r.rid, r.error)
            assert list(r.out) == ref[r.rid], r.rid
        fs = eng.fault_stats()
        assert fs["pq_fallbacks"] > 0, fs
        assert eng.store.log.total(kind="pq_codes_read") == 0.0
        _ledger_balanced(eng)
        _assert_no_leaks(b, eng)
    finally:
        eng.store.close()


@pytest.mark.chaos
def test_pq_read_bitflips_quarantined_no_leaks():
    """``pq_read`` bitflips corrupt stored code bytes; the CRC layer
    quarantines each victim chunk (min/max serves it) without failing or
    degrading any request, and without leaking slots, futures or ledger
    bytes."""
    plan = FaultPlan(schedule={"pq_read": {i: "bitflip"
                                           for i in range(0, 40, 2)}})
    reqs, b, eng = _drive(plan, ecfg_kw={"pq_abstracts": True})
    try:
        for r in reqs:
            assert r.t_done is not None
            assert r.error is None and not r.degraded, (r.rid, r.error)
        fired = [e for e in plan.fired_events() if e.kind == "bitflip"]
        assert fired
        fs = eng.fault_stats()
        assert fs["checksum_failures"] > 0, fs
        assert fs["pq_fallbacks"] > 0, fs
        _ledger_balanced(eng)
        _assert_no_leaks(b, eng)
    finally:
        eng.store.close()


@pytest.mark.chaos
def test_deadline_cancels_queued_request():
    req_kw = {2: {"deadline_s": 1e-4}}
    reqs, b, eng = _drive(None, scfg_kw={"max_active": 1}, req_kw=req_kw)
    try:
        by_rid = {r.rid: r for r in reqs}
        assert "deadline" in (by_rid[2].error or "")
        assert by_rid[0].error is None and by_rid[1].error is None
        assert b._requests_cancelled == 1
        _assert_no_leaks(b, eng)
    finally:
        eng.store.close()


@pytest.mark.chaos
def test_bounded_queue_rejects_structured():
    cfg, params, prompts = _setup()
    eng = _engine(cfg, params)
    b = ContinuousBatcher(
        cfg=SchedulerCfg(max_active=1, chunk=16, max_queue=1), engine=eng)
    oks = [b.submit(Request(i, p, max_new=2))
           for i, p in enumerate(prompts)]
    try:
        assert oks == [True, False, False]
        assert len(b.rejected) == 2 and b._requests_rejected == 2
        assert all("max_queue" in (r.error or "") for r in b.rejected)
        done = b.run()
        assert [r.rid for r in done] == [0] and done[0].error is None
        _assert_no_leaks(b, eng)
    finally:
        eng.store.close()


# ---------------------------------------------------------------------------
# one chaos seed through both packages
# ---------------------------------------------------------------------------

PARITY_SEED, RATE = 9, 0.3


def _chaos_run(port):
    """Seed PARITY_SEED's plan (denser than the property's, so that
    retries, quarantines, recomputes and worker faults all fire) through
    one package's batcher: synchronous admission and no prefetch, so each
    fault site sees its calls in the same order in both packages."""
    _setup()
    s = _SETUP
    if port:
        plan = FaultPlan.from_seed(PARITY_SEED, rate=RATE, horizon=300)
        eng = BatchedLeoAMEngine(
            s["cfg"], s["params"],
            EngineCfg(max_len=128, selection="tree", disk_sidecar=True,
                      pipeline=False, fault_plan=plan, io_backoff_s=0.0),
            max_seqs=2, device="cpu")
        b = ContinuousBatcher(cfg=SchedulerCfg(max_active=2, chunk=16),
                              engine=eng)
        mk = Request
    else:
        plan = JFaultPlan.from_seed(PARITY_SEED, rate=RATE, horizon=300)
        eng = JEngine(s["jcfg"], s["jparams"],
                      JCfg(max_len=128, selection="tree", disk_sidecar=True,
                           pipeline=False, fault_plan=plan,
                           io_backoff_s=0.0),
                      max_seqs=2)
        b = JBatcher(cfg=JSched(max_active=2, chunk=16), engine=eng)
        mk = JRequest
    for i, p in enumerate(s["prompts"]):
        b.submit(mk(i, p, max_new=4))
    reqs = sorted(list(b.run()) + list(b.rejected), key=lambda r: r.rid)
    st = eng.store
    res = dict(
        states=[(r.rid, r.error is None, r.degraded, r.t_done is not None)
                for r in reqs],
        out={r.rid: list(r.out) for r in reqs},
        faults=eng.fault_stats(), failed=sorted(eng.failed),
        events=[(e.site, e.index, e.kind, e.key)
                for e in plan.fired_events()],
        calls=plan.calls(), bytes=dict(st.log.bytes), ops=dict(st.log.ops),
        free=sorted(eng._free))
    st.close()
    return res


@pytest.mark.chaos
def test_chaos_seed_matches_reference():
    t, j = _chaos_run(True), _chaos_run(False)
    assert t["faults"]["io_retries"] > 0 and t["faults"]["seqs_failed"] > 0
    assert any(ok for _, ok, _, _ in t["states"])
    assert t["events"] == j["events"] and t["calls"] == j["calls"]
    assert t["states"] == j["states"]
    assert t["out"] == j["out"]
    assert t["failed"] == j["failed"] and t["free"] == j["free"]
    assert {k: j["faults"][k] for k in t["faults"]} == t["faults"]
    assert t["bytes"] == j["bytes"] and t["ops"] == j["ops"]


@pytest.mark.chaos
def test_replica_loss_recovery_matches_reference():
    """The recompute-from-prompt path in both packages: the same replica
    corruption after round 1 (prompt-span chunk 0 of sequence 0 in every
    layer, and, in a later round, a chunk that holds decode appends of
    sequence 1) gives equal streams, counters, failed sequences and
    TrafficLogs — the recomputed chunks are billed ``kv_recompute`` and
    the second loss fails sequence 1 alone."""
    _setup()
    s = _SETUP
    res = {}
    for port in (True, False):
        cfg = s["cfg"] if port else s["jcfg"]
        cfg = dataclasses.replace(
            cfg, leoam=dataclasses.replace(cfg.leoam,
                                           min_seq_for_sparse=256))
        if port:
            eng = BatchedLeoAMEngine(
                cfg, s["params"], EngineCfg(max_len=128, disk_sidecar=True,
                                            pipeline=False),
                max_seqs=2, device="cpu")
        else:
            eng = JEngine(cfg, s["jparams"],
                          JCfg(max_len=128, disk_sidecar=True, pipeline=False),
                          max_seqs=2)
        toks = {}
        for p in s["prompts"][:2]:
            sid, tok = eng.add_sequence(p)
            toks[sid] = tok
        out = {sid: [] for sid in toks}
        for rnd in range(5):
            if rnd == 1:
                _corrupt_chunk(eng, 0, 0)
            if rnd == 3:
                # sequence 1 (57 prompt tokens) appends into chunk 3
                st = eng.store
                for li in range(len(eng.attn_layers)):
                    st._crc_state[1, li, 3] = 1    # claim a clean CRC
                _corrupt_chunk(eng, 1, 3)
            toks = eng.decode_round(toks)
            for sid, t in toks.items():
                out[sid].append(t)
        st = eng.store
        res[port] = dict(out=out, faults=eng.fault_stats(),
                         failed=sorted(eng.failed), bytes=dict(st.log.bytes),
                         ops=dict(st.log.ops),
                         disk=np.array(st._disk[0]).astype(np.float32))
        st.close()
    t, j = res[True], res[False]
    assert t["faults"]["chunks_recomputed"] >= 1
    assert t["failed"] == [1] and t["faults"]["seqs_failed"] == 1
    assert t["out"] == j["out"] and t["failed"] == j["failed"]
    assert {k: j["faults"][k] for k in t["faults"]} == t["faults"]
    assert t["bytes"] == j["bytes"] and t["ops"] == j["ops"]
    # the restored replica rows came out of each framework's own chunked
    # prefill: within one fp16 ulp plus the 1e-5 prefill tolerance
    ulp = np.spacing(np.abs(j["disk"]).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(t["disk"] - j["disk"]) <= ulp + 1e-5)
