"""The port's tier store against ``repro.serving.offload.TieredKVStore``:
the same ingest / fetch / append / stage / clear script gives bitwise-equal
disk memmaps, abstracts, pool contents and slot maps, and an equal
TrafficLog (bytes and ops), with and without the real transit codec and
write-behind ingest."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.serving.offload import DEVICE, DISK, HOST
from repro.serving.offload import TieredKVStore as JStore
from repro_torch.serving.offload import TieredKVStore as TStore

L, NC, C, HKV, HD, NSEQ = 2, 8, 4, 2, 8, 2


def _stores(real_codec, tmp_path):
    kw = dict(n_seqs=NSEQ, transit_codec="int4", use_pool=True,
              pool_slots=7, real_codec=real_codec)
    (tmp_path / "jax").mkdir()
    js = JStore(L, NC, C, HKV, HD, root=str(tmp_path / "jax"), **kw)
    ts = TStore(L, NC, C, HKV, HD, root=str(tmp_path / "torch"),
                device="cpu", **kw)
    return js, ts


def _placement(shift):
    tiers = (DEVICE, DEVICE, HOST, HOST, HOST, DISK, DISK, DISK)
    return {c: tiers[(c + shift) % NC] for c in range(NC)}


def _script(store, rng_seed, executor):
    """One deterministic ingest/fetch/append history; returns every value
    the store hands back."""
    rng = np.random.RandomState(rng_seed)
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
    for rnd in range(4):
        for layer in range(L):
            sels = {seq: sorted(rng.choice(-(-lengths[seq] // C),
                                           3, replace=False).tolist())
                    for seq in lengths}
            if rnd == 2:
                out.append(store.stage_host(layer, sels))
            km, kn, billed = store.read_abstracts_batch(
                layer, {s: list(range(-(-lengths[s] // C))) for s in lengths})
            out += [km, kn, dict(billed)]
            slots, nsel, st = store.fetch_chunks_pooled(
                layer, sels, pad_to=4, theta=0.5)
            out += [slots, nsel, (st.hits, st.uploads, st.compressed,
                                  st.disk_reads, st.upload_bytes,
                                  st.disk_bytes)]
            kn_ = rng.randn(NSEQ, HKV, HD).astype(np.float32)
            vn_ = rng.randn(NSEQ, HKV, HD).astype(np.float32)
            store.append_tokens_batch(
                layer, np.array([lengths[0], lengths[1]]), kn_, vn_,
                seqs=[0, 1])
        lengths = {s: n + 1 for s, n in lengths.items()}
    return out


def _pool(store, layer):
    kv = store.pools[layer].kv
    return kv.numpy() if isinstance(kv, torch.Tensor) else np.asarray(kv)


@pytest.mark.parametrize("real_codec", [False, True])
@pytest.mark.parametrize("write_behind", [False, True])
def test_store_script_matches_reference(tmp_path, real_codec, write_behind):
    js, ts = _stores(real_codec, tmp_path)
    ex = ThreadPoolExecutor(max_workers=1) if write_behind else None
    try:
        out_j = _script(js, 7, ex)
        out_t = _script(ts, 7, ex)
        assert len(out_j) == len(out_t)
        for a, b in zip(out_j, out_t):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                assert a == b
        assert np.array_equal(np.asarray(js._disk), np.asarray(ts._disk))
        assert np.array_equal(js._abs_km, ts._abs_km)
        assert np.array_equal(js._abs_kn, ts._abs_kn)
        assert np.array_equal(np.asarray(js._crc), np.asarray(ts._crc))
        assert np.array_equal(js.tier, ts.tier)
        for layer in range(L):
            assert np.array_equal(_pool(js, layer), _pool(ts, layer))
            assert list(js.pools[layer].slot_of.items()) == \
                list(ts.pools[layer].slot_of.items())
        assert dict(js.log.bytes) == dict(ts.log.bytes)
        assert dict(js.log.ops) == dict(ts.log.ops)
        for s in range(NSEQ):
            assert dict(js.seq_logs[s].ops) == dict(ts.seq_logs[s].ops)
        assert js.pool_stats() == ts.pool_stats()
        assert js.tier_bytes() == ts.tier_bytes()
        assert (js.codec_uploads, js.plain_uploads) == \
            (ts.codec_uploads, ts.plain_uploads)
        # retire a sequence: the logs move, the slot scrubs identically
        js.clear_seq(0)
        ts.clear_seq(0)
        assert [dict(g.bytes) for g in js.retired_logs] == \
            [dict(g.bytes) for g in ts.retired_logs]
        assert np.array_equal(js._abs_km, ts._abs_km)
        for layer in range(L):
            assert js.pools[layer].slot_of == ts.pools[layer].slot_of
    finally:
        js.close()
        ts.close()
        if ex is not None:
            ex.shutdown()


def test_corrupt_replica_is_reported_lost(tmp_path):
    """CRC32 catches a flipped replica byte at promotion."""
    from repro_torch.serving.faults import ChunkLostError
    _, ts = _stores(False, tmp_path)
    k = np.ones((NC * C, HKV, HD), np.float32)
    ts.ingest(0, k, k, {c: DISK for c in range(NC)}, seq=0)
    ts._disk[0, 0, 3, 0, 0, 0, 0] += 1
    with pytest.raises(ChunkLostError):
        ts.fetch_chunks_pooled(0, {0: [2, 3]})
    assert (0, 0, 3) in ts.disk_lost_keys()
    ts.close()


@pytest.mark.parametrize("opt", [
    {"prefix_rows": 2}, {"debug_sync": True}, {"latent": True}])
def test_unported_store_options_raise(tmp_path, opt):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TStore(L, NC, C, HKV, HD, root=str(tmp_path), device="cpu", **opt)
