"""The rest of the port's tier store against ``repro.serving.offload``: the
packed disk sidecar (int4 and int8, on, off and lossless) with its requant
repack, the legacy device tier (``use_pool=False``, ``device_budget``),
``reopen=True`` and ``checksums=False``.

The same script runs on a ``repro`` store and a port store (``device=
"cpu"``), fed the same numpy K/V; the disk files, valid bits, tier tables,
host and legacy-device copies, returned arrays, TrafficLogs (shared and
per sequence), repack counts, degraded sequences and fault counters must
be EQUAL.  The engine's ``disk_sidecar=True`` (sweep on and off),
``pooled=False`` and ``LeoAMEngine`` runs give identical token streams and
TrafficLogs to ``repro``'s on the smoke longchat config, directly and
through the ContinuousBatcher.  The reference's own tests of these modes
are ported as cases here and run on the port's store."""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import compression as jcomp
from repro.models import lm as jlm
from repro.serving.engine import BatchedLeoAMEngine as JEngine
from repro.serving.engine import EngineCfg as JCfg
from repro.serving.engine import LeoAMEngine as JSingle
from repro.serving.faults import ChunkLostError as JChunkLostError
from repro.serving.offload import TieredKVStore as JStore
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerCfg as JSched
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import compression
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import BatchedLeoAMEngine as TEngine
from repro_torch.serving.engine import EngineCfg as TCfg
from repro_torch.serving.engine import LeoAMEngine as TSingle
from repro_torch.serving.faults import ChunkLostError
from repro_torch.serving.offload import DEVICE, DISK, HOST
from repro_torch.serving.offload import TieredKVStore as TStore
from repro_torch.serving.scheduler import ContinuousBatcher as TBatcher
from repro_torch.serving.scheduler import Request as TRequest
from repro_torch.serving.scheduler import SchedulerCfg as TSched

L, NC, C, HKV, HD, NSEQ = 2, 8, 4, 2, 8, 2
MEMMAPS = ("_disk", "_disk_q", "_disk_scale", "_crc", "_crc_state", "_q_crc")


def _pair(tmp_path, **kw):
    """A ``repro`` store and a port store built from the same keywords."""
    (tmp_path / "jax").mkdir(exist_ok=True)
    js = JStore(L, NC, C, HKV, HD, n_seqs=NSEQ, root=str(tmp_path / "jax"),
                **kw)
    ts = TStore(L, NC, C, HKV, HD, n_seqs=NSEQ, root=str(tmp_path / "torch"),
                device="cpu", **kw)
    return js, ts


def _placement(shift):
    tiers = (DEVICE, DEVICE, HOST, HOST, HOST, DISK, DISK, DISK)
    return {c: tiers[(c + shift) % NC] for c in range(NC)}


def _fetch(store, layer, sels, theta, pad_to=5):
    """One layer's promotion on the store's path; the values it returns."""
    if store.use_pool:
        slots, nsel, st = store.fetch_chunks_pooled(layer, sels, pad_to=pad_to,
                                                    theta=theta)
        return [slots, nsel, (st.hits, st.uploads, st.compressed,
                              st.disk_reads, st.upload_bytes, st.disk_bytes)]
    kg, vg, nsel = store.fetch_chunks_batch(layer, sels, pad_to=pad_to)
    return [kg, vg, nsel]


def _script(store, seed, executor=None, thetas=(0.5, 0.0)):
    """Two sequences of 27 and 19 tokens over mixed DEVICE/HOST/DISK
    placements; five decode-like rounds (abstract read, promotion, append,
    sweep), speculative staging in one, demotions to HOST and DISK in
    another (the appended tail chunk then reads the fp16 replica); two
    quiet sweeps repack it and a last promotion reads it packed again.
    Returns every value the store hands back."""
    rng = np.random.RandomState(seed)
    out = []
    lengths = {0: 27, 1: 19}
    for seq, S in lengths.items():
        for layer in range(L):
            k = rng.randn(NC * C, HKV, HD).astype(np.float32)
            v = rng.randn(NC * C, HKV, HD).astype(np.float32)
            k[S:] = 0
            v[S:] = 0
            store.ingest(layer, k, v, _placement(seq + layer), seq=seq,
                         executor=executor)
    for seq in lengths:
        store.ingest_fence(seq)
    for rnd in range(5):
        nv = {s: -(-n // C) for s, n in lengths.items()}
        for layer in range(L):
            sels = {s: sorted(set(rng.choice(nv[s], 2, replace=False)
                                  .tolist()) | {nv[s] - 1})
                    for s in lengths}
            if rnd == 2:
                out.append(store.stage_host(layer, sels))
            km, kn, billed = store.read_abstracts_batch(
                layer, {s: list(range(nv[s])) for s in lengths})
            out += [km, kn, dict(billed)]
            out += _fetch(store, layer, sels, thetas[rnd % 2])
            store.append_tokens_batch(
                layer, np.array([lengths[0], lengths[1]]),
                rng.randn(NSEQ, HKV, HD).astype(np.float32),
                rng.randn(NSEQ, HKV, HD).astype(np.float32), seqs=[0, 1])
            if rnd == 3:
                store.demote(layer, [0, nv[0] - 1], to=DISK, seq=0)
                store.demote(layer, [1], to=HOST, seq=1)
            if not store.use_pool:
                out += list(store.fetch_chunks(layer, [nv[1] - 1, 2], seq=1))
                out += list(store.read_abstracts(layer, [0, 5, 7], seq=1))
        out.append(store.requant_sweep(executor))
        store.requant_fence()          # repacks land before the next round
        lengths = {s: n + 1 for s, n in lengths.items()}
    # the tail chunks went quiet: two sweeps repack them, then a promotion
    # off disk reads them packed again
    out += [store.requant_sweep(), store.requant_sweep()]
    for layer in range(L):
        store.demote(layer, [-(-27 // C) - 1, -(-28 // C) - 1], to=DISK, seq=0)
        out += _fetch(store, layer, {0: [5, 6, 7], 1: [4, 5]}, thetas[0])
    out += [store.tier_view(0, 1), store.host_bytes(), store.device_bytes()]
    return out


def _same_values(out_j, out_t):
    assert len(out_j) == len(out_t)
    for a, b in zip(out_j, out_t):
        if isinstance(a, np.ndarray) or hasattr(a, "shape"):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        else:
            assert a == b


def _same_store(js, ts):
    """Every piece of state the two stores must share."""
    for name in MEMMAPS:
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert sorted(os.listdir(js._root)) == sorted(os.listdir(ts._root))
    assert np.array_equal(js._sidecar_valid, ts._sidecar_valid)
    assert np.array_equal(js.tier, ts.tier)
    assert np.array_equal(js.access, ts.access)
    assert np.array_equal(js._abs_km, ts._abs_km)
    assert np.array_equal(js._abs_kn, ts._abs_kn)
    for a, b in ((js._host_k, ts._host_k), (js._host_v, ts._host_v),
                 (js._dev_k, ts._dev_k), (js._dev_v, ts._dev_v)):
        assert list(a) == list(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert list(js._lru) == list(ts._lru)
    assert js.use_pool == ts.use_pool
    if js.use_pool:
        for layer in range(L):
            assert np.array_equal(np.asarray(js.pools[layer].kv),
                                  ts.pools[layer].kv.numpy())
            assert list(js.pools[layer].slot_of.items()) == \
                list(ts.pools[layer].slot_of.items())
        assert js.pool_stats() == ts.pool_stats()
    assert dict(js.log.bytes) == dict(ts.log.bytes)
    assert dict(js.log.ops) == dict(ts.log.ops)
    for s in range(NSEQ):
        assert dict(js.seq_logs[s].bytes) == dict(ts.seq_logs[s].bytes)
        assert dict(js.seq_logs[s].ops) == dict(ts.seq_logs[s].ops)
    assert js.sidecar_repacks == ts.sidecar_repacks
    assert js.degraded_seqs == ts.degraded_seqs
    fj, ft = js.fault_stats(), ts.fault_stats()
    assert {k: fj[k] for k in ft} == ft
    assert js.tier_bytes() == ts.tier_bytes()


# (codec, sidecar, pooled, real_codec, write-behind)
SCRIPTS = [(codec, side, pooled, False, False)
           for codec in ("int4", "int8") for side in ("off", "on", "lossless")
           for pooled in (True, False)] + [
    ("int4", "on", True, True, False), ("int8", "on", True, True, True),
    ("int4", "lossless", True, True, True), ("int4", "on", False, True, True),
    ("int4", "off", True, True, True), ("int8", "on", False, False, True)]


@pytest.mark.parametrize("codec,side,pooled,real_codec,write_behind", SCRIPTS)
def test_store_script_matches_reference(tmp_path, codec, side, pooled,
                                        real_codec, write_behind):
    kw = dict(transit_codec=codec, use_pool=pooled, real_codec=real_codec,
              disk_sidecar=side != "off", sidecar_lossless=side == "lossless")
    kw.update(dict(pool_slots=7) if pooled else dict(device_budget=5))
    js, ts = _pair(tmp_path, **kw)
    ex = ThreadPoolExecutor(max_workers=1) if write_behind else None
    try:
        _same_values(_script(js, 7, ex), _script(ts, 7, ex))
        _same_store(js, ts)
        if side == "on":
            assert ts.sidecar_repacks > 0
            assert ts.log.total(kind="sidecar_repack") == pytest.approx(
                ts.sidecar_repacks * ts._packed_bytes())
        # retire a sequence: the logs move, the slot scrubs identically
        js.clear_seq(0)
        ts.clear_seq(0)
        _same_store(js, ts)
        assert [dict(g.bytes) for g in js.retired_logs] == \
            [dict(g.bytes) for g in ts.retired_logs]
    finally:
        js.close()
        ts.close()
        if ex is not None:
            ex.shutdown()


@pytest.mark.parametrize("pooled", [True, False])
def test_store_without_checksums_matches_reference(tmp_path, pooled):
    """``checksums=False`` creates no CRC files and verifies nothing; the
    rest of the script is unchanged."""
    kw = dict(transit_codec="int4", use_pool=pooled, disk_sidecar=True,
              checksums=False)
    js, ts = _pair(tmp_path, **kw)
    _same_values(_script(js, 3), _script(ts, 3))
    _same_store(js, ts)
    assert not [f for f in os.listdir(ts._root) if "crc" in f]
    js.close()
    ts.close()


@pytest.mark.parametrize("pooled", [True, False])
def test_corrupt_sidecar_falls_back_to_the_replica(tmp_path, pooled):
    """A flipped sidecar byte fails its CRC at promotion: the chunk is
    quarantined (valid bit cleared, counted), read off the fp16 replica
    and billed ``kv_fallback``, and its sequence is marked degraded — the
    same in both stores."""
    kw = dict(transit_codec="int4", use_pool=pooled, disk_sidecar=True)
    js, ts = _pair(tmp_path, **kw)
    rng = np.random.RandomState(5)
    k = rng.randn(NC * C, HKV, HD).astype(np.float16)
    out = {}
    for st in (js, ts):
        for layer in range(L):
            st.ingest(layer, k, k, {c: DISK for c in range(NC)}, seq=1)
        buf = st._disk_q[1, 1, 3].reshape(-1)
        buf[0] = np.int8(int(buf[0]) ^ 0x40)
        out[st] = [v for layer in range(L)
                   for v in _fetch(st, layer, {1: [2, 3, 4]}, 1.0)]
        if not pooled:
            out[st] += list(st.fetch_chunks(0, [5], seq=1))
    _same_values(out[js], out[ts])
    _same_store(js, ts)
    assert ts.degraded_seqs == {1} and not ts._sidecar_valid[1, 1, 3]
    assert ts.fault_stats()["checksum_failures"] == 1
    assert ts.log.ops[(DISK, HOST, "kv_fallback")] == 1
    assert ts.log.bytes[(DISK, HOST, "kv_fallback")] == ts.chunk_bytes
    np.testing.assert_array_equal(ts._host_k[(1, 1, 3)], k[12:16])
    js.close()
    ts.close()


def _torn_store(tmp_path, pooled, **kw):
    """Both stores ingested with the sidecar on, chunk 3 of seq 0 torn
    (its replica CRC never landed), flushed, then reopened."""
    kw = dict(transit_codec="int8", use_pool=pooled, disk_sidecar=True, **kw)
    js, ts = _pair(tmp_path, **kw)
    rng = np.random.RandomState(0)
    k = rng.randn(NC * C, HKV, HD).astype(np.float16)
    v = rng.randn(NC * C, HKV, HD).astype(np.float16)
    for st in (js, ts):
        for layer in range(L):
            st.ingest(layer, k, v, {c: DISK for c in range(NC)}, seq=0)
        st._crc_state[0, 0, 3] = 0
        for name in MEMMAPS:
            if getattr(st, name) is not None:
                getattr(st, name).flush()
    re = (JStore(L, NC, C, HKV, HD, n_seqs=NSEQ, root=js._root, reopen=True,
                 **kw),
          TStore(L, NC, C, HKV, HD, n_seqs=NSEQ, root=ts._root, reopen=True,
                 device="cpu", **kw))
    js.close()
    ts.close()
    return re, k


@pytest.mark.parametrize("pooled", [True, False])
def test_reopen_rejects_torn_chunk(tmp_path, pooled):
    """The reference's crash-consistency test on both stores: a reopened
    store starts every chunk on DISK with no valid sidecar, serves the
    intact chunks off the fp16 replica and rejects the torn one as
    disk-lost."""
    (js, ts), k = _torn_store(tmp_path, pooled)
    assert (ts.tier == DISK).all() and not ts._sidecar_valid.any()
    out = {}
    for st, lost in ((js, JChunkLostError), (ts, ChunkLostError)):
        if pooled:
            out[st] = _fetch(st, 0, {0: [0, 1, 2]}, 1.0)
        else:
            ks, _ = st.fetch_chunks(0, [0, 1, 2], seq=0)
            assert np.array_equal(ks[0], k[:C])
            out[st] = [ks]
        with pytest.raises(lost):
            if pooled:
                _fetch(st, 0, {0: [3]}, 1.0)
            else:
                st.fetch_chunks(0, [3], seq=0)
        assert (0, 0, 3) in st.disk_lost_keys()
    _same_values(out[js], out[ts])
    _same_store(js, ts)
    js.close()
    ts.close()


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_reopened_store_refills_the_pool(tmp_path, theta):
    """Every surviving chunk of a reopened pooled store promotes into the
    pool with the same slab, slots and billing as in ``repro``."""
    (js, ts), _ = _torn_store(tmp_path, True, real_codec=True, pool_slots=16)
    for st in (js, ts):
        st._crc_state[0, 0, 3] = 1        # not torn here: re-mark it valid
    out = {st: [v for layer in range(L)
                for v in _fetch(st, layer, {0: list(range(NC))}, theta, NC)]
           for st in (js, ts)}
    _same_values(out[js], out[ts])
    _same_store(js, ts)
    js.close()
    ts.close()


# ---------------------------------------------------------------------------
# The reference's tests of these modes, on the port's store
# ---------------------------------------------------------------------------


def test_store_abstract_vs_full_traffic(rng):
    st = TStore(n_layers=1, n_chunks=8, chunk=16, kv_heads=2, head_dim=8,
                transit_codec=None, use_pool=False, device="cpu")
    k = rng.randn(128, 2, 8).astype(np.float16)
    v = rng.randn(128, 2, 8).astype(np.float16)
    st.ingest(0, k, v, {c: DISK for c in range(8)})
    st.read_abstracts(0, list(range(8)))
    ab = st.log.total(src=DISK, kind="abstract")
    assert ab == 8 * st.abstract_bytes
    st.fetch_chunks(0, [0, 3])
    moved = st.log.total(src=DISK, kind="kv")
    assert moved == 2 * st.chunk_bytes
    assert (ab + moved) / (8 * st.chunk_bytes) < 0.45
    st.close()


def test_store_disk_replica_free_demotion(rng):
    st = TStore(1, 4, 8, 2, 8, transit_codec=None, use_pool=False,
                device="cpu")
    k = rng.randn(32, 2, 8).astype(np.float16)
    st.ingest(0, k, k, {c: HOST for c in range(4)})
    before = st.log.total(kind="kv")
    st.demote(0, [1, 2], to=DISK)
    assert st.log.total(kind="kv") == before       # no write I/O
    kf, vf = st.fetch_chunks(0, [1])
    np.testing.assert_allclose(kf[0], k[8:16], atol=1e-3)
    st.close()


def test_store_append_updates_abstract(rng):
    st = TStore(1, 4, 8, 2, 4, transit_codec=None, use_pool=False,
                device="cpu")
    k = rng.randn(16, 2, 4).astype(np.float16)
    st.ingest(0, k, k, {c: HOST for c in range(4)})
    newk = np.full((2, 4), 9.0, np.float16)
    st.append_token(0, 16, newk, newk)
    km, kn = st.read_abstracts(0, [2])
    assert np.all(km[0] >= 9.0 - 1e-3)
    st.close()


@pytest.mark.parametrize("codec", ["int4", "int8"])
def test_sidecar_promotion_bytes_and_values(rng, codec):
    """Replica writes AND disk→host promotions of the packed sidecar bill
    exactly chunk_bytes × codec_ratio(codec, chunk); the promoted values
    are the reference's, within the symmetric-quantization bound of fp16.
    The fp16 replica stays the lossless fallback behind the flag."""
    k = rng.randn(64, 2, 8).astype(np.float16)
    v = rng.randn(64, 2, 8).astype(np.float16)
    st = TStore(1, 4, 16, 2, 8, n_seqs=1, transit_codec=codec,
                use_pool=True, real_codec=True, disk_sidecar=True,
                device="cpu")
    ref = JStore(1, 4, 16, 2, 8, n_seqs=1, transit_codec=codec,
                 use_pool=True, real_codec=True, disk_sidecar=True)
    packed = st.chunk_bytes * compression.codec_ratio(codec, group=st.chunk)
    assert 2 * compression.packed_chunk_bytes(codec, 16, 16) == packed
    for s in (st, ref):
        s.ingest(0, k, v, {c: DISK for c in range(4)})
    assert st.log.total(kind="kv_replica") == pytest.approx(4 * packed)
    _, _, fst = st.fetch_chunks_pooled(0, {0: [0, 1, 2, 3]}, theta=0.0)
    ref.fetch_chunks_pooled(0, {0: [0, 1, 2, 3]}, theta=0.0)
    assert fst.disk_reads == 4
    assert fst.disk_bytes == pytest.approx(4 * packed)
    assert st.log.bytes[(DISK, HOST, "kv")] == pytest.approx(4 * packed)
    _, scale_k = compression.quantize_chunks(k.reshape(4, 16, 2, 8), codec)
    got = np.stack([st._host_k[(0, 0, c)] for c in range(4)])
    assert np.array_equal(got, np.stack([ref._host_k[(0, 0, c)]
                                         for c in range(4)]))
    err = np.abs(got.astype(np.float32)
                 - k.reshape(4, 16, 2, 8).astype(np.float32))
    assert np.all(err <= scale_k.reshape(4, 1, 2, 8) / 2 + 2e-3)
    st.close()
    ref.close()
    # lossless fallback flag: reads bypass the sidecar, bill full fp16
    st = TStore(1, 4, 16, 2, 8, n_seqs=1, transit_codec=codec, use_pool=True,
                disk_sidecar=True, sidecar_lossless=True, device="cpu")
    st.ingest(0, k, v, {c: DISK for c in range(4)})
    _, _, fst = st.fetch_chunks_pooled(0, {0: [0, 1]})
    assert fst.disk_bytes == pytest.approx(2 * float(st.chunk_bytes))
    np.testing.assert_array_equal(
        np.stack([st._host_k[(0, 0, c)] for c in range(2)]).reshape(
            32, 2, 8), k[:32])
    st.close()


def test_sidecar_append_invalidates_chunk(rng):
    """A decode append stales the chunk's per-chunk scales: the sidecar is
    invalidated and the next promotion reads the lossless fp16 replica
    (full bytes, exact values — including the appended row)."""
    k = rng.randn(64, 2, 8).astype(np.float16)
    st = TStore(1, 8, 16, 2, 8, n_seqs=1, transit_codec="int4",
                use_pool=True, disk_sidecar=True, device="cpu")
    st.ingest(0, k, k, {c: DISK for c in range(4)})
    assert bool(st._sidecar_valid[0, 0, 3])
    newk = rng.randn(2, 8).astype(np.float16)
    st.append_token(0, 63, newk, newk)         # last row of chunk 3
    assert not st._sidecar_valid[0, 0, 3]
    assert bool(st._sidecar_valid[0, 0, 2])    # untouched chunks keep it
    _, _, fst = st.fetch_chunks_pooled(0, {0: [3]})
    assert fst.disk_bytes == pytest.approx(float(st.chunk_bytes))
    np.testing.assert_array_equal(st._host_k[(0, 0, 3)][15], newk)
    st.close()


def test_requant_sweep_repacks_quiet_chunks(rng):
    """An append-dirtied chunk is repacked after one FULL quiet round:
    reads bill packed bytes again, values (incl. the appended row) sit
    within the quantization bound, and repacks are billed.  The live tail
    chunk (appended every round) is never repacked."""
    k = rng.randn(64, 2, 8).astype(np.float16)
    st = TStore(1, 8, 16, 2, 8, n_seqs=1, transit_codec="int4",
                use_pool=True, disk_sidecar=True, device="cpu")
    st.ingest(0, k, k, {c: DISK for c in range(4)})
    newk = rng.randn(2, 8).astype(np.float16)
    st.append_token(0, 63, newk, newk)          # dirties chunk 3
    assert not st._sidecar_valid[0, 0, 3]
    assert st.requant_sweep() == 0              # round r: just appended
    assert st.requant_sweep() == 1              # round r+1: quiet -> repack
    assert bool(st._sidecar_valid[0, 0, 3])
    assert st.sidecar_repacks == 1
    packed = st.chunk_bytes * compression.codec_ratio("int4", group=16)
    assert st.log.total(kind="sidecar_repack") == pytest.approx(packed)
    assert st.log.total(kind="sidecar_repack_read") == st.chunk_bytes
    st.demote(0, [3], to=DISK)
    _, _, fst = st.fetch_chunks_pooled(0, {0: [3]})
    assert fst.disk_bytes == pytest.approx(packed)
    got = st._host_k[(0, 0, 3)][15].astype(np.float32)
    chunk3 = np.array(st._disk[0, 0, 3, 0])
    _, scale = compression.quantize_chunks(chunk3[None], "int4")
    bound = scale[0].reshape(2, 8) / 2 + 2e-3
    assert np.all(np.abs(got - newk.astype(np.float32)) <= bound)
    for pos in (64, 65, 66):
        st.append_token(0, pos, newk, newk)
        st.requant_sweep()
    assert not st._sidecar_valid[0, 0, 4]
    st.close()


def test_repack_that_raced_an_append_is_aborted(rng):
    """The version check: an append between a sweep's snapshot and its
    write leaves the chunk's sidecar invalid and nothing repacked."""
    k = rng.randn(64, 2, 8).astype(np.float16)
    st = TStore(1, 8, 16, 2, 8, n_seqs=1, transit_codec="int4",
                use_pool=True, disk_sidecar=True, device="cpu")
    st.ingest(0, k, k, {c: DISK for c in range(4)})
    newk = rng.randn(2, 8).astype(np.float16)
    st.append_token(0, 63, newk, newk)
    st.requant_sweep()
    quantize = compression.quantize_chunks

    def racing(*a, **kw):
        st.append_token(0, 62, newk, newk)      # lands mid-repack
        return quantize(*a, **kw)

    compression.quantize_chunks = racing
    try:
        assert st.requant_sweep() == 1
    finally:
        compression.quantize_chunks = quantize
    assert st.sidecar_repacks == 0 and not st._sidecar_valid[0, 0, 3]
    assert st.log.total(kind="sidecar_repack") == 0
    st.close()


def test_dequantize_chunks_bitwise_equal_to_reference():
    rng = np.random.RandomState(0)
    for codec in ("int4", "int8"):
        k = rng.randn(5, 16, 2, 8).astype(np.float16) * 3
        k[1] = 0                                 # an all-zero chunk
        data, scale = compression.quantize_chunks(k, codec)
        for dt in (np.float16, np.float32):
            a = jcomp.dequantize_chunks(data, scale, codec, 2, 8, dtype=dt)
            b = compression.dequantize_chunks(data, scale, codec, 2, 8,
                                              dtype=dt)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        x = rng.randn(2, 128, 16).astype(np.float32)
        assert compression.quantization_rmse(x, codec, 64) == \
            jcomp.quantization_rmse(x, codec, 64)
        got = compression.dequantize(compression.quantize(x, codec, 64), 64)
        want = jcomp.dequantize(jcomp.quantize(jax.numpy.asarray(x), codec,
                                               64), 64, jax.numpy.float32)
        assert got.tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# Engines: sidecar, legacy path, single-sequence wrapper, batcher
# ---------------------------------------------------------------------------

LENS, N_NEW, THETA = (94, 64, 57), 6, 0.5


def _cfg(get):
    cfg = get("longchat-7b-32k", smoke=True)
    return dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=16,
                                       importance_rate=0.4, early_rate=0.6,
                                       min_seq_for_sparse=32))


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = _cfg(get_config), _cfg(t_get_config)
    params = jlm.init(cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    prompts = [np.random.RandomState(0).randint(2, cfg.vocab_size, n)
               for n in LENS]
    return cfg, tcfg, params, tparams, prompts


def _engine(port: bool, setup, budget=None, **kw):
    cfg, tcfg, params, tparams, _ = setup
    if port:
        eng = TEngine(tcfg, tparams, TCfg(max_len=128, selection="tree", **kw),
                      max_seqs=len(LENS), device_chunk_budget=budget,
                      device="cpu")
    else:
        eng = JEngine(cfg, params, JCfg(max_len=128, selection="tree", **kw),
                      max_seqs=len(LENS), device_chunk_budget=budget)
    eng._theta = lambda li: THETA      # θ comes from wall clock: pin it
    return eng


def _run(port, setup, prompts=None, budget=None, **kw):
    eng = _engine(port, setup, budget, **kw)
    toks, streams = {}, {}
    for p in prompts or setup[4]:
        sid, tok = eng.add_sequence(p)
        toks[sid], streams[sid] = tok, [tok]
    for _ in range(N_NEW - 1):
        toks = eng.decode_round(toks)
        for sid, tok in toks.items():
            streams[sid].append(tok)
    st = eng.store
    st.requant_fence()
    out = {"streams": [streams[s] for s in sorted(streams)],
           "bytes": dict(st.log.bytes), "ops": dict(st.log.ops),
           "seq_bytes": {s: dict(g.bytes) for s, g in st.seq_logs.items()},
           "repacks": st.sidecar_repacks, "degraded": set(st.degraded_seqs),
           "sidecar_valid": st._sidecar_valid.copy(), "tier": st.tier.copy(),
           "pool_stats": st.pool_stats(), "lru": list(st._lru),
           "budget": st.device_budget, "chunk_bytes": st.chunk_bytes,
           "crc": st._crc is not None}
    st.close()
    return out


def _same_run(out_j, out_t):
    assert out_j.keys() == out_t.keys()
    for key in out_j:
        if isinstance(out_j[key], np.ndarray):
            assert np.array_equal(out_j[key], out_t[key]), key
        else:
            assert out_j[key] == out_t[key], key


@pytest.mark.parametrize("sweep,checksums", [(True, True), (False, True),
                                             (True, False)])
def test_sidecar_engine_matches_reference(setup, sweep, checksums):
    """``disk_sidecar=True`` with the real codec: the 94-token prompt's
    chunks 4-5 sit on disk (packed reads) and its appends cross a chunk
    boundary, so with the sweep on the quiet chunk is repacked;
    ``EngineCfg(checksums=False)`` reaches the store."""
    kw = dict(disk_sidecar=True, real_codec=True, sidecar_requant=sweep,
              checksums=checksums)
    out_j, out_t = _run(False, setup, **kw), _run(True, setup, **kw)
    _same_run(out_j, out_t)
    assert out_t["crc"] == checksums
    # some disk->host promotions moved packed bytes, and every replica
    # write did
    key = (DISK, HOST, "kv")
    assert out_t["bytes"][key] < out_t["ops"][key] * out_t["chunk_bytes"]
    rep = (HOST, DISK, "kv_replica")
    assert out_t["bytes"][rep] == pytest.approx(
        out_t["ops"][rep] * out_t["chunk_bytes"]
        * compression.codec_ratio("int4", group=16))
    assert (out_t["repacks"] > 0) == sweep


def test_requant_sweep_engine_smoke(setup):
    """The reference's engine smoke, on the port: the sweep repacks in the
    background (counted) and leaves the token stream unchanged."""
    prompt = [np.random.RandomState(3).randint(2, setup[0].vocab_size, 60)]
    outs = {sweep: _run(True, setup, prompts=prompt, disk_sidecar=True,
                        real_codec=True, sidecar_requant=sweep)
            for sweep in (False, True)}
    assert outs[True]["streams"] == outs[False]["streams"]
    assert outs[False]["repacks"] == 0 and outs[True]["repacks"] > 0


def test_legacy_engine_matches_reference(setup):
    """``pooled=False, pipeline=False``: the reference's synchronous
    full-re-upload path — legacy device tier, host-assembled working sets —
    gives the reference's tokens and TrafficLog."""
    kw = dict(pooled=False, pipeline=False)
    out_j, out_t = _run(False, setup, **kw), _run(True, setup, **kw)
    _same_run(out_j, out_t)
    assert out_t["lru"] and out_t["pool_stats"]["slots"] == 0


def test_pooled_pipelined_matches_legacy_synchronous(setup):
    """The reference's parity guarantee, on the port: the pool + async
    DTP engine decodes token-identical to the synchronous full-re-upload
    engine (both attend with B2 over the same fp16 rows)."""
    legacy = _run(True, setup, pooled=False, pipeline=False)
    pooled = _run(True, setup, pooled=True, pipeline=False)
    piped = _run(True, setup, pooled=True, pipeline=True)
    assert pooled["streams"] == legacy["streams"]
    assert piped["streams"] == legacy["streams"]
    assert piped["pool_stats"]["hits"] > 0
    assert legacy["pool_stats"]["slots"] == 0


def test_legacy_engine_with_budget_and_sidecar(setup):
    """The legacy path with an evicting device budget (per layer, so the
    store's is 2 x the attention layers) and the sidecar, pipeline on (the
    legacy round submits no prefetch, as in the reference)."""
    kw = dict(budget=2, pooled=False, disk_sidecar=True)
    out_j, out_t = _run(False, setup, **kw), _run(True, setup, **kw)
    _same_run(out_j, out_t)
    assert out_t["budget"] == 2 * 4 and len(out_t["lru"]) == out_t["budget"]


def test_single_sequence_engine_with_sidecar(setup):
    cfg, tcfg, params, tparams, prompts = setup
    kw = dict(max_len=128, disk_sidecar=True, real_codec=True)
    je = JSingle(cfg, params, JCfg(**kw))
    te = TSingle(tcfg, tparams, TCfg(**kw), device="cpu")
    for e in (je, te):
        e._engine._theta = lambda li: THETA
    assert te.generate(prompts[0], 6) == je.generate(prompts[0], 6)
    je.store.requant_fence()
    te.store.requant_fence()
    assert dict(te.store.log.bytes) == dict(je.store.log.bytes)
    assert te.store.sidecar_repacks == je.store.sidecar_repacks
    je.store.close()
    te.store.close()


def _run_batcher(port, setup, **kw):
    eng = _engine(port, setup, **kw)
    Batcher, Request, Sched = (TBatcher, TRequest, TSched) if port else \
        (JBatcher, JRequest, JSched)
    b = Batcher(engine=eng, cfg=Sched(max_active=3, chunk=16))
    for i, p in enumerate(setup[4]):
        b.submit(Request(rid=i, prompt=p, max_new=N_NEW))
    done = sorted(b.run(), key=lambda r: r.rid)
    eng.store.requant_fence()
    out = ([r.out for r in done], [r.error for r in done],
           dict(eng.store.log.bytes), eng.store.sidecar_repacks)
    eng.store.close()
    return out


def test_batcher_with_sidecar_matches_reference(setup):
    kw = dict(disk_sidecar=True, real_codec=True)
    out_j, out_t = _run_batcher(False, setup, **kw), _run_batcher(True, setup,
                                                                  **kw)
    assert out_t == out_j
    assert all(len(s) == N_NEW for s in out_t[0])


def test_legacy_store_refuses_a_pooled_fetch(tmp_path):
    st = TStore(1, 4, 16, 2, 8, use_pool=False, root=str(tmp_path),
                device="cpu")
    with pytest.raises(ValueError, match="pooled store"):
        st.fetch_chunks_pooled(0, {0: [0]})
    assert st.pools == [None] and st.pool_stats()["slots"] == 0
    st.close()
