"""The port's fault domain at the store boundary, against
``repro.serving.offload``.  Ported from ``tests/test_faults.py`` (every
test, run on the port's store with ``device="cpu"``):

- ``FaultPlan`` determinism and per-site kind pools (the port's copy of
  ``serving/faults.py``);
- CRC rejection of a corrupt replica (``ChunkLostError``) and sidecar (the
  lossless fp16 fallback, the sequence marked degraded);
- ``restore_chunk``, bounded retry (one transient error is
  value-identical, persistent errors exhaust into the degrade paths),
  crash consistency on reopen, the exception-safe ingest fence, worker
  faults at the fence and the pooled fetch's partial-failure scrub.

Then the same fault script runs on a ``repro`` store and a port store fed
the same K/V and the same explicit ``FaultPlan``: transient errors,
exhausted retries, sidecar, replica and PQ-code bitflips, a worker
exception and a failed write, the recoveries through ``restore_chunk``,
and a swap-out/swap-in.  Fault counters, fired events, TrafficLogs, disk
memmaps and every value handed back must be equal.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.serving.faults import ChunkLostError as JChunkLostError
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.faults import IngestError as JIngestError
from repro.serving.offload import TieredKVStore as JStore
from repro_torch.serving.faults import (FAULT_KINDS, FAULT_SITES,
                                        ChunkLostError, DiskIOExhausted,
                                        FaultPlan, IngestError,
                                        TransientDiskError, WorkerFault,
                                        _SITE_KINDS)
from repro_torch.serving.offload import DISK, HOST, TieredKVStore

L, NC, CH, HKV, HD = 2, 4, 8, 2, 4     # layers, chunks, chunk, Hkv, hd


def _mk(root=None, reopen=False, faults=None, **kw):
    kw.setdefault("io_backoff_s", 0.0)
    return TieredKVStore(L, NC, CH, HKV, HD, n_seqs=2, disk_sidecar=True,
                         transit_codec="int8", root=root, reopen=reopen,
                         faults=faults, device="cpu", **kw)


def _kv(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(NC * CH, HKV, HD).astype(np.float16),
            rng.randn(NC * CH, HKV, HD).astype(np.float16))


def _ingest_all(st, k, v, seq=0, **kw):
    for li in range(L):
        st.ingest(li, k, v, {c: DISK for c in range(NC)}, seq=seq, **kw)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def test_fault_plan_from_seed_deterministic():
    a = FaultPlan.from_seed(7, rate=0.2)
    b = FaultPlan.from_seed(7, rate=0.2)
    assert a.schedule == b.schedule
    # the port's copy draws the reference's schedule for the same seed
    assert a.schedule == JFaultPlan.from_seed(7, rate=0.2).schedule
    assert len({str(FaultPlan.from_seed(s, rate=0.2).schedule)
                for s in range(8)}) > 1


def test_fault_plan_site_kind_pools():
    for seed in range(20):
        plan = FaultPlan.from_seed(seed, rate=0.5, horizon=50)
        for site, hits in plan.schedule.items():
            for kind in hits.values():
                assert kind in _SITE_KINDS[site]


def test_fault_plan_check_consumes_indices():
    plan = FaultPlan(schedule={"disk_read": {1: "io_error"}})
    assert plan.check("disk_read") is None
    assert plan.check("disk_read", key="k") == "io_error"
    assert plan.check("disk_read") is None
    assert plan.calls()["disk_read"] == 3
    [ev] = plan.fired_events()
    assert (ev.site, ev.index, ev.kind, ev.key) == ("disk_read", 1,
                                                    "io_error", "k")


def test_fault_plan_rejects_unknown_names():
    with pytest.raises(ValueError):
        FaultPlan(schedule={"nope": {0: "io_error"}})
    with pytest.raises(ValueError):
        FaultPlan(schedule={"disk_read": {0: "nope"}})
    assert set(_SITE_KINDS) == set(FAULT_SITES)
    assert all(k in FAULT_KINDS for ks in _SITE_KINDS.values() for k in ks)


# ---------------------------------------------------------------------------
# checksum rejection + recovery
# ---------------------------------------------------------------------------

def test_clean_fetch_counts_nothing():
    st = _mk()
    k, v = _kv()
    _ingest_all(st, k, v)
    ks, _ = st.fetch_chunks(0, [0, 1], seq=0)
    assert ks.shape == (2, CH, HKV, HD)
    fs = st.fault_stats()
    assert fs["io_retries"] == fs["checksum_failures"] == 0
    assert fs["chunks_recomputed"] == fs["disk_lost"] == 0
    st.close()


def test_replica_corruption_raises_chunk_lost():
    st = _mk()
    k, v = _kv()
    _ingest_all(st, k, v)
    st._disk[0, 1, 2, 0].reshape(-1)[3] += np.float16(1.0)
    st._sidecar_valid[0, 1, 2] = False      # force the replica path
    with pytest.raises(ChunkLostError) as ei:
        st.fetch_chunks(1, [2], seq=0)
    assert ei.value.layer == 1 and ei.value.keys == [(0, 0, 2)]
    assert st.disk_lost_keys() == {(0, 1, 2)}
    assert st.fault_stats()["checksum_failures"] == 1
    # re-detection of an already-lost chunk must not double count
    with pytest.raises(ChunkLostError):
        st.fetch_chunks(1, [2], seq=0)
    assert st.fault_stats()["checksum_failures"] == 1
    st.close()


def test_restore_chunk_roundtrip():
    st = _mk()
    k, v = _kv()
    _ingest_all(st, k, v)
    st._disk[0, 1, 2, 0].reshape(-1)[3] += np.float16(1.0)
    st._sidecar_valid[0, 1, 2] = False
    with pytest.raises(ChunkLostError):
        st.fetch_chunks(1, [2], seq=0)
    kc, vc = k[2 * CH:3 * CH], v[2 * CH:3 * CH]
    st.restore_chunk(1, 0, 2, kc, vc)
    ks, vs = st.fetch_chunks(1, [2], seq=0)
    assert np.array_equal(ks[0], kc) and np.array_equal(vs[0], vc)
    fs = st.fault_stats()
    assert fs["chunks_recomputed"] == 1 and fs["disk_lost"] == 0
    # recovery traffic is billed under its own kind
    assert st.log.total(src=HOST, kind="kv_recompute") == st.chunk_bytes
    st.close()


def test_sidecar_bitflip_falls_back_lossless():
    plan = FaultPlan(schedule={"sidecar_read": {0: "bitflip"}})
    st = _mk(faults=plan)
    k, v = _kv()
    _ingest_all(st, k, v, seq=1)
    ks, _ = st.fetch_chunks(0, [0], seq=1)
    # the fallback serves the fp16 replica: lossless, not the codec
    assert np.array_equal(ks[0], k[:CH])
    assert 1 in st.degraded_seqs
    assert st.fault_stats()["checksum_failures"] == 1
    assert st.log.total(src=DISK, kind="kv_fallback") > 0
    [ev] = plan.fired_events()
    assert ev.site == "sidecar_read" and ev.key is not None
    st.close()


# ---------------------------------------------------------------------------
# bounded retry
# ---------------------------------------------------------------------------

def test_transient_error_retries_value_identical():
    ref = _mk()
    k, v = _kv()
    _ingest_all(ref, k, v)
    ref._sidecar_valid[:] = False
    want, _ = ref.fetch_chunks(0, [1], seq=0)
    ref.close()

    plan = FaultPlan(schedule={"disk_read": {0: "io_error"}})
    st = _mk(faults=plan)
    _ingest_all(st, k, v)
    st._sidecar_valid[:] = False
    got, _ = st.fetch_chunks(0, [1], seq=0)
    assert np.array_equal(got, want)
    fs = st.fault_stats()
    assert fs["io_retries"] == 1 and fs["checksum_failures"] == 0
    st.close()


def test_persistent_errors_exhaust_to_chunk_lost():
    plan = FaultPlan(schedule={"disk_read": {i: "io_error"
                                             for i in range(10)}})
    st = _mk(faults=plan, io_retries=3)
    k, v = _kv()
    _ingest_all(st, k, v)
    st._sidecar_valid[:] = False
    with pytest.raises(ChunkLostError):
        st.fetch_chunks(0, [1], seq=0)
    assert st.fault_stats()["io_retries"] == 4     # io_retries + 1 attempts
    st.close()


def test_retry_wrapper_raises_exhausted():
    st = _mk(io_retries=2)
    calls = []

    def always_fails():
        calls.append(1)
        raise TransientDiskError("blip")

    with pytest.raises(DiskIOExhausted):
        st._with_retries(always_fails)
    assert len(calls) == 3
    st.close()


# ---------------------------------------------------------------------------
# crash consistency
# ---------------------------------------------------------------------------

def test_reopen_rejects_torn_chunk():
    st = _mk()
    k, v = _kv()
    _ingest_all(st, k, v)
    root = st._root
    # a kill between the hot placement and the cold CRC landing: the
    # replica bytes may be anything, the CRC state never left "none"
    st._crc_state[0, 0, 3] = 0
    st._crc.flush()
    st._disk.flush()

    st2 = _mk(root=root, reopen=True)
    st2._sidecar_valid[:] = False
    ks, _ = st2.fetch_chunks(0, [0, 1, 2], seq=0)   # intact chunks serve
    assert np.array_equal(ks[0], k[:CH])
    with pytest.raises(ChunkLostError):
        st2.fetch_chunks(0, [3], seq=0)
    assert (0, 0, 3) in st2.disk_lost_keys()
    st2.close()


def test_clear_seq_resets_fault_state():
    st = _mk()
    k, v = _kv()
    _ingest_all(st, k, v)
    st._disk[0, 0, 1, 0].reshape(-1)[0] += np.float16(1.0)
    st._sidecar_valid[0, 0, 1] = False
    with pytest.raises(ChunkLostError):
        st.fetch_chunks(0, [1], seq=0)
    st.degraded_seqs.add(0)
    st.clear_seq(0)
    fs = st.fault_stats()
    assert fs["disk_lost"] == 0 and fs["degraded_seqs"] == 0
    # the row restarts with no stale CRC claims about reused storage
    assert int(st._crc_state[0].max()) == 0
    st.close()


# ---------------------------------------------------------------------------
# exception-safe fence + worker faults
# ---------------------------------------------------------------------------

def test_ingest_fence_drains_all_futures_then_raises():
    # the fence awaits ALL of a sequence's write-behind futures, then
    # surfaces one typed IngestError
    plan = FaultPlan(schedule={"disk_write": {i: "io_error"
                                              for i in range(64)}})
    st = _mk(faults=plan, io_retries=1)
    k, v = _kv()
    with ThreadPoolExecutor(2) as ex:
        _ingest_all(st, k, v, executor=ex)
        with pytest.raises(IngestError) as ei:
            st.ingest_fence(0)
        assert ei.value.seq == 0
        assert isinstance(ei.value.cause, DiskIOExhausted)
        assert not st._ingest_futs.get(0)    # drained, not abandoned
        st.ingest_fence(0)                   # second fence: clean no-op
    st.close()


def test_worker_fault_surfaces_at_fence():
    plan = FaultPlan(schedule={"worker": {0: "exception"}})
    st = _mk(faults=plan)
    k, v = _kv()
    with ThreadPoolExecutor(1) as ex:
        _ingest_all(st, k, v, executor=ex)
        with pytest.raises(IngestError) as ei:
            st.ingest_fence_all()
        assert isinstance(ei.value.cause, WorkerFault)
    st.close()


# ---------------------------------------------------------------------------
# pooled-fetch partial-failure scrub
# ---------------------------------------------------------------------------

def test_pooled_fetch_scrubs_partial_failure():
    # an exception between slot allocation and the slab update must not
    # leak the freshly allocated slots: they go back, their chunks to HOST
    st = _mk(use_pool=True, pool_slots=NC)
    k, v = _kv()
    _ingest_all(st, k, v)
    st.ingest_fence_all()
    pool = st.pools[0]
    real = st._plane_stack
    boom = {"armed": True}

    def exploding(kc, vc):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("dispatch failed mid-upload")
        return real(kc, vc)

    st._plane_stack = exploding
    with pytest.raises(RuntimeError):
        st.fetch_chunks_pooled(0, {0: [0, 1]})
    # conservation: every slot is either free or scatter-backed resident
    assert len(pool.free) + len(pool.slot_of) == pool.n_slots
    assert not pool.slot_of
    assert all(st.tier[0, 0, c] == HOST for c in (0, 1))
    # the retry serves the correct bytes from the intact host/disk copies
    # (sidecar path: int8 round-trip, so compare against the host copy)
    st._plane_stack = real
    slots, nsel, _ = st.fetch_chunks_pooled(0, {0: [0, 1]})
    got = pool.kv[int(slots[0, 0]), 0].numpy()
    assert np.array_equal(got, st._host_k[(0, 0, 0)].astype(st.dtype))
    assert np.allclose(got.astype(np.float32), k[:CH].astype(np.float32),
                       atol=0.05)
    st.close()


# ---------------------------------------------------------------------------
# the same fault script on both packages' stores
# ---------------------------------------------------------------------------

# one explicit schedule per site: a transient blip, silent corruption and a
# run of errors that exhausts the retry budget (io_retries 2: 3 attempts)
SCHEDULE = {
    "disk_read": {0: "io_error", 1: "bitflip", 7: "io_error", 8: "io_error",
                  9: "io_error", 12: "bitflip", 15: "latency"},
    "sidecar_read": {1: "io_error", 2: "bitflip", 3: "io_error",
                     4: "io_error", 5: "io_error"},
    "pq_read": {0: "io_error", 2: "bitflip", 4: "io_error", 5: "io_error",
                6: "io_error"},
    "disk_write": {1: "io_error", 5: "io_error", 6: "io_error",
                   7: "io_error"},
    "worker": {6: "exception"},
}
MEMMAPS = ("_disk", "_disk_q", "_disk_scale", "_crc", "_crc_state", "_q_crc",
           "_pq_codes", "_pq_crc")


def _fault_script(st, kvs, chunk_lost, ingest_error):
    """Two sequences ingested write-behind (one layer's write fails past
    its retries on the second admission of seq 1), then six rounds of
    abstract reads, promotions, staging and appends with a swap-out and a
    swap-in in the middle; every ChunkLostError is recovered through
    ``restore_chunk`` off the sequence's own K/V and the fetch retried.
    Returns every value the store hands back and every fault it raised."""
    out = []
    lengths = {0: 20, 1: 22}

    def fetch(layer, sels):
        for _ in range(4):
            try:
                if st.use_pool:
                    slots, nsel, fs = st.fetch_chunks_pooled(layer, sels,
                                                             pad_to=4)
                    return [slots, nsel, (fs.hits, fs.uploads,
                                          fs.disk_reads, fs.disk_bytes)]
                kg, vg, nsel = st.fetch_chunks_batch(layer, sels, pad_to=4)
                return [kg, vg, nsel]
            except chunk_lost as e:
                out.append(("lost", e.layer, e.keys))
                for seq, _p, c in e.keys:
                    k, v = kvs[seq][e.layer]
                    st.restore_chunk(e.layer, seq, c,
                                     k[c * CH:(c + 1) * CH],
                                     v[c * CH:(c + 1) * CH])
        raise AssertionError("fetch did not recover")

    with ThreadPoolExecutor(1) as ex:
        for admission in range(2):
            for seq in (0, 1):
                for layer in range(L):
                    k, v = kvs[seq][layer]
                    st.ingest(layer, k, v,
                              {c: (HOST if c == 0 else DISK)
                               for c in range(NC)}, seq=seq, executor=ex)
                try:
                    st.ingest_fence(seq)
                    out.append(("fenced", seq))
                except ingest_error as e:
                    out.append(("ingest failed", seq, type(e.cause).__name__))
        for rnd in range(6):
            if rnd == 2:
                out.append(st.swap_out_seq(1))
            if rnd == 4:
                out.append(st.swap_in_seq(1))
            live = [0] if rnd in (2, 3) else [0, 1]
            for layer in range(L):
                nv = {s: -(-lengths[s] // CH) for s in live}
                sels = {s: sorted({(rnd + layer + s) % nv[s], nv[s] - 1})
                        for s in live}
                if rnd == 1:
                    out.append(st.stage_host(layer, sels))
                if st.pq:
                    km, kn, codes, valid, cb, billed = \
                        st.read_abstracts_pq_batch(
                            layer, {s: list(range(nv[s])) for s in live})
                    out += [km, kn, codes, valid, dict(billed)]
                else:
                    km, kn, billed = st.read_abstracts_batch(
                        layer, {s: list(range(nv[s])) for s in live})
                    out += [km, kn, dict(billed)]
                out += fetch(layer, sels)
                rng = np.random.RandomState(100 * rnd + layer)
                st.append_tokens_batch(
                    layer, np.array([lengths[s] for s in live]),
                    rng.randn(len(live), HKV, HD).astype(np.float32),
                    rng.randn(len(live), HKV, HD).astype(np.float32),
                    seqs=live)
            for s in live:
                lengths[s] += 1
            out.append(st.requant_sweep(ex))
            st.requant_fence()
    out += [st.host_bytes(), st.disk_lost_keys(), st.seq_swapouts,
            st.seq_swapins]
    return out


def _same(out_j, out_t):
    assert len(out_j) == len(out_t)
    for a, b in zip(out_j, out_t):
        if isinstance(a, np.ndarray) or hasattr(a, "shape"):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        else:
            assert a == b


@pytest.mark.parametrize("pooled,sidecar,pq", [(True, False, False),
                                               (False, True, False),
                                               (True, True, True)])
def test_fault_script_matches_reference(tmp_path, pooled, sidecar, pq):
    """Same K/V, same explicit FaultPlan: the port's store raises the
    same faults, recovers them the same way, and ends with the same
    counters, events, logs, disk bytes and returned values as ``repro``'s."""
    rng = np.random.RandomState(3)
    kvs = {s: [(rng.randn(NC * CH, HKV, HD).astype(np.float16),
                rng.randn(NC * CH, HKV, HD).astype(np.float16))
               for _ in range(L)] for s in (0, 1)}
    kw = dict(n_seqs=2, transit_codec="int4", disk_sidecar=sidecar,
              use_pool=pooled, io_retries=2, io_backoff_s=0.0,
              abstract_kind="pq" if pq else "minmax")
    if pq:
        kw.update(pq_m=2, pq_centroids=8)
    jplan, tplan = JFaultPlan(schedule=SCHEDULE), FaultPlan(schedule=SCHEDULE)
    (tmp_path / "jax").mkdir()
    js = JStore(L, NC, CH, HKV, HD, root=str(tmp_path / "jax"), faults=jplan,
                **kw)
    ts = TieredKVStore(L, NC, CH, HKV, HD, root=str(tmp_path / "torch"),
                       faults=tplan, device="cpu", **kw)
    try:
        out_j = _fault_script(js, kvs, JChunkLostError, JIngestError)
        out_t = _fault_script(ts, kvs, ChunkLostError, IngestError)
        _same(out_j, out_t)
        ev = lambda p: [(e.site, e.index, e.kind, e.key)
                        for e in p.fired_events()]
        assert ev(jplan) == ev(tplan)
        assert jplan.calls() == tplan.calls()
        fired = {(e.site, e.kind) for e in tplan.fired_events()}
        assert {("disk_read", "io_error"), ("disk_read", "bitflip"),
                ("disk_write", "io_error"), ("worker", "exception")} <= fired
        if sidecar:
            assert {("sidecar_read", "io_error"),
                    ("sidecar_read", "bitflip")} <= fired
        if pq:
            assert {("pq_read", "io_error"), ("pq_read", "bitflip")} <= fired
        for name in MEMMAPS:
            a, b = getattr(js, name), getattr(ts, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.array_equal(np.asarray(a), np.asarray(b)), name
        assert sorted(os.listdir(js._root)) == sorted(os.listdir(ts._root))
        assert np.array_equal(js.tier, ts.tier)
        assert np.array_equal(js._sidecar_valid, ts._sidecar_valid)
        if pooled:
            for layer in range(L):
                assert np.array_equal(np.asarray(js.pools[layer].kv),
                                      ts.pools[layer].kv.numpy())
                assert js.pools[layer].slot_of == ts.pools[layer].slot_of
        assert dict(js.log.bytes) == dict(ts.log.bytes)
        assert dict(js.log.ops) == dict(ts.log.ops)
        for s in (0, 1):
            assert dict(js.seq_logs[s].ops) == dict(ts.seq_logs[s].ops)
        assert js.fault_stats() == ts.fault_stats()
        assert js.degraded_seqs == ts.degraded_seqs
        fs = ts.fault_stats()
        assert fs["io_retries"] > 0 and fs["checksum_failures"] > 0
        assert fs["chunks_recomputed"] > 0
        if pq:
            assert fs["pq_fallbacks"] > 0
        assert ts.log.ops[(HOST, DISK, "kv_recompute")] == \
            fs["chunks_recomputed"]
        assert ts.seq_swapouts == ts.seq_swapins == 1
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("site", ["disk_read", "sidecar_read", "pq_read"])
def test_flip_bit_matches_reference(tmp_path, site):
    """A scheduled bitflip corrupts the same stored bit in both packages:
    bit 10 of the replica's first fp16 word, 0x40 of the sidecar's first
    payload byte, 0x01 of the first PQ code byte."""
    k, v = _kv(1)
    kw = dict(n_seqs=2, transit_codec="int8", disk_sidecar=True,
              abstract_kind="pq", pq_m=2, pq_centroids=8)
    (tmp_path / "jax").mkdir()
    plans = (JFaultPlan(schedule={site: {0: "bitflip"}}),
             FaultPlan(schedule={site: {0: "bitflip"}}))
    stores = (JStore(L, NC, CH, HKV, HD, root=str(tmp_path / "jax"),
                     faults=plans[0], **kw),
              TieredKVStore(L, NC, CH, HKV, HD, root=str(tmp_path / "torch"),
                            faults=plans[1], device="cpu", **kw))
    before = {}
    for st in stores:
        _ingest_all(st, k, v, seq=1)
        before[st] = {n: np.array(getattr(st, n)) for n in MEMMAPS}
        st._fault_point(site, [(1, 1, 2), (1, 1, 3)])
    for name in MEMMAPS:
        a, b = (np.asarray(getattr(st, name)) for st in stores)
        assert np.array_equal(a, b), name
    changed = [n for n in MEMMAPS
               if not np.array_equal(before[stores[1]][n],
                                     np.asarray(getattr(stores[1], n)))]
    assert changed == [{"disk_read": "_disk", "sidecar_read": "_disk_q",
                        "pq_read": "_pq_codes"}[site]]
    assert plans[1].fired_events()[0].key == (1, 1, 2)
    for st in stores:
        st.close()
