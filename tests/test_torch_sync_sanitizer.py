"""The port's runtime sync sanitizer (``repro_torch.serving.sanitizer``,
wired into the store and the engine by ``debug_sync=True``): wrong-thread
detection, the concurrent-mutation (epoch) guard, lock-order cycle
tracking, the store's tracked locks (``_lock``, ``_pq_lock``,
``_futs_lock``), and the schedule-fuzz stress run of the full debug_sync
engine on the CPU.  Ported from ``tests/test_sync_sanitizer.py``; the
stress run holds the port's debug_sync streams to its own non-debug
streams and to ``repro``'s (same weights via ``params_from_jax``)."""

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.serving import sanitizer
from repro_torch.serving.offload import TieredKVStore as _Store
from repro_torch.serving.sanitizer import (LockOrderTracker, SyncViolation,
                                           TrackedLock, decode_thread_only)


def TieredKVStore(*a, **kw):
    return _Store(*a, device="cpu", **kw)


# ----------------------------------------------------------------------
# wrong-thread detection
# ----------------------------------------------------------------------
def test_wrong_thread_store_mutation_trips_sanitizer():
    """A decode-thread-only store method submitted to a leoam-* executor
    raises instead of racing the decode thread."""
    st_ = TieredKVStore(1, 4, 16, 2, 8, n_seqs=1, transit_codec=None,
                        debug_sync=True)
    try:
        assert sanitizer.active()
        st_.clear_seq(0)                      # decode thread: fine
        ex = ThreadPoolExecutor(1, thread_name_prefix="leoam-test")
        with pytest.raises(SyncViolation, match="decode-thread-only"):
            ex.submit(st_.clear_seq, 0).result()
        ex.shutdown()
    finally:
        st_.close()


def test_registered_worker_thread_double_trips_sanitizer():
    """register_worker_thread() makes an anonymous test-double thread a
    worker for the sanitizer even without the leoam- name."""

    class Pool:
        @decode_thread_only
        def scatter(self, slots):
            return slots

    pool = Pool()
    sanitizer.enable()
    errs = []
    try:
        def run():
            sanitizer.register_worker_thread()
            try:
                pool.scatter([0])
            except SyncViolation as e:
                errs.append(e)

        t = threading.Thread(target=run)
        t.start()
        t.join()
    finally:
        sanitizer.disable()
    assert len(errs) == 1 and "scatter" in str(errs[0])


def test_sanitizer_off_is_free():
    """With the sanitizer disabled the decorator is pass-through even on a
    worker-named thread."""

    class Pool:
        @decode_thread_only
        def scatter(self, slots):
            return list(slots)

    pool = Pool()
    assert not sanitizer.active()
    ex = ThreadPoolExecutor(1, thread_name_prefix="leoam-test")
    assert ex.submit(pool.scatter, (1, 2)).result() == [1, 2]
    ex.shutdown()


# ----------------------------------------------------------------------
# concurrent-mutation (epoch) guard
# ----------------------------------------------------------------------
def test_epoch_guard_rejects_interleaved_mutators():
    """Two non-worker threads interleaving inside one decode-thread-only
    mutator of the same object is a hard error, not silent corruption."""

    class Slab:
        def __init__(self):
            self.inside = threading.Event()
            self.release = threading.Event()

        @decode_thread_only
        def fold(self):
            self.inside.set()
            self.release.wait(5.0)

    slab = Slab()
    sanitizer.enable()
    try:
        t = threading.Thread(target=slab.fold, name="imposter-decode")
        t.start()
        assert slab.inside.wait(5.0)
        with pytest.raises(SyncViolation, match="concurrent mutation"):
            slab.fold()
        slab.release.set()
        t.join()
        slab.fold()                           # guard resets after exit
    finally:
        sanitizer.disable()


def test_epoch_guard_allows_reentrancy():
    class Slab:
        @decode_thread_only
        def outer(self):
            return self.inner() + 1

        @decode_thread_only
        def inner(self):
            return 1

    sanitizer.enable()
    try:
        assert Slab().outer() == 2
    finally:
        sanitizer.disable()


# ----------------------------------------------------------------------
# lock-order tracker
# ----------------------------------------------------------------------
def test_lock_order_cycle_raises():
    tr = LockOrderTracker()
    la = TrackedLock(threading.Lock(), "A", tr)
    lb = TrackedLock(threading.Lock(), "B", tr)
    with la:
        with lb:
            assert sanitizer.held_locks() == ("A", "B")
    assert sanitizer.held_locks() == ()
    with lb:
        with pytest.raises(SyncViolation, match="lock-order cycle"):
            la.acquire()
    assert tr.edges()["A"] == {"B"}
    assert "A" not in tr.edges().get("B", set())   # cycle edge NOT recorded


def test_lock_order_consistent_nesting_is_fine():
    tr = LockOrderTracker()
    la = TrackedLock(threading.RLock(), "A", tr)
    lb = TrackedLock(threading.RLock(), "B", tr)
    for _ in range(3):
        with la:
            with lb:
                pass
    assert tr.edges() == {"A": {"B"}}


def test_debug_store_wraps_locks_and_runs_clean():
    """The debug_sync store wraps both of its locks in TrackedLock, and the
    ingest -> fence -> fetch path runs without a violation (the store never
    nests _lock inside _futs_lock or vice versa — the invariant locklint
    checks statically)."""
    st_ = TieredKVStore(1, 4, 16, 2, 8, n_seqs=1, transit_codec="int4",
                        debug_sync=True)
    try:
        assert isinstance(st_._lock, TrackedLock)
        assert st_._lock.name == "TieredKVStore._lock"
        assert isinstance(st_._futs_lock, TrackedLock)
        assert isinstance(st_._pq_lock, TrackedLock)
        rng = np.random.RandomState(0)
        k = rng.randn(32, 2, 8).astype(np.float16)
        v = rng.randn(32, 2, 8).astype(np.float16)
        st_.ingest(0, k, v, seq=0)
        st_.ingest_fence(0)
        kf, _ = st_.fetch_chunks(0, [0, 1])
        np.testing.assert_allclose(
            kf.reshape(32, 2, 8).astype(np.float32),
            k.astype(np.float32), atol=0.25)
        edges = sanitizer.lock_order_edges()
        assert not any("TieredKVStore._futs_lock" in e
                       for e in edges.get("TieredKVStore._lock", ()))
    finally:
        st_.close()


# ----------------------------------------------------------------------
# schedule-fuzz stress test: full engine under debug_sync
# ----------------------------------------------------------------------
_SETUP = {}


def _cfg(get):
    cfg = get("longchat-7b-32k", smoke=True)
    return dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=16,
                                       importance_rate=0.4, early_rate=0.6,
                                       min_seq_for_sparse=32))


def _setup():
    if not _SETUP:
        import jax
        from repro.configs import get_config
        from repro.models import lm
        from repro_torch.configs import get_config as t_get_config
        from repro_torch.models.params import params_from_jax
        params = lm.init(_cfg(get_config), jax.random.PRNGKey(1))
        _SETUP["jcfg"], _SETUP["jparams"] = _cfg(get_config), params
        _SETUP["cfg"] = _cfg(t_get_config)
        _SETUP["params"] = params_from_jax(jax.tree.map(np.asarray, params),
                                           "cpu")
        rng = np.random.RandomState(7)
        _SETUP["prompts"] = [rng.randint(2, _SETUP["cfg"].vocab_size, n)
                             for n in (48, 57, 64)]
    return _SETUP["cfg"], _SETUP["params"], _SETUP["prompts"]


def _drive(order, *, debug_sync, jitter_rng=None, max_new=3, port=True):
    cfg, params, prompts = _setup()
    # write-behind ingest is the port's only ingest (the reference's
    # overlap_ingest=True default)
    ecfg = dict(max_len=128, selection="tree", disk_sidecar=True,
                debug_sync=debug_sync)
    if port:
        from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
        from repro_torch.serving.scheduler import (ContinuousBatcher,
                                                   Request, SchedulerCfg)
        eng = BatchedLeoAMEngine(cfg, params, EngineCfg(**ecfg), max_seqs=2,
                                 device="cpu")
    else:
        from repro.serving.engine import BatchedLeoAMEngine, EngineCfg
        from repro.serving.scheduler import (ContinuousBatcher, Request,
                                             SchedulerCfg)
        eng = BatchedLeoAMEngine(_SETUP["jcfg"], _SETUP["jparams"],
                                 EngineCfg(**ecfg), max_seqs=2)
    b = ContinuousBatcher(
        cfg=SchedulerCfg(max_active=2, chunk=16, overlap_admission=True),
        engine=eng)
    for i in order:
        b.submit(Request(i, prompts[i], max_new=max_new))
        if jitter_rng is not None:
            # perturb the worker/decode interleaving between submissions
            time.sleep(float(jitter_rng.rand()) * 2e-3)
    out = {r.rid: r.out for r in b.run()}
    eng.store.close()
    return out


_REF = {}


@pytest.mark.stress
@settings(max_examples=3, deadline=None)
@given(st.integers(min_value=0, max_value=9))
def test_schedule_fuzz_debug_sync_token_identical(seed):
    """Randomized admission order + worker-timing jitter under the live
    sanitizer: no SyncViolation fires and the token streams match the
    non-debug engine exactly (and the reference's) — the instrumentation
    observes, never perturbs."""
    rng = np.random.RandomState(seed)
    order = list(rng.permutation(3))
    key = tuple(order)
    if key not in _REF:
        _REF[key] = _drive(order, debug_sync=False)
        assert _REF[key] == _drive(order, debug_sync=False, port=False)
    was_active = sanitizer.active()
    got = _drive(order, debug_sync=True, jitter_rng=rng)
    assert sanitizer.active() == was_active   # close() released the refcount
    ref = _REF[key]
    assert set(got) == set(ref)
    for rid in ref:
        assert got[rid] == ref[rid], (rid, got[rid], ref[rid])
