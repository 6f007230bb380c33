"""The port's shared-prefix cache (``EngineCfg(prefix_cache=True)``,
``TieredKVStore(prefix_rows=N)``) on the longchat smoke config, chunk 16,
``max_len`` 128, ``prefill_chunk_tokens`` 32.  The weights are one JAX
``lm.init`` tree carried over with ``params_from_jax``.

Ported from ``tests/test_prefix_cache.py`` (every test, in the port
alone): chain hashes and index units, warm == cold over seeds 0-2, N
sharers released restore the single-owner state, copy-on-write keeps the
readers' bytes, ``prefix_ref`` bills zero and COW one chunk a layer,
shared chunks take one pool slot, arena eviction, the scheduler's stats
and admission credit, the batcher run, the config refusals and the two
``prefill_time_prefix`` properties.

Then the port against ``repro``: the same event schedules through both
packages' engines — pooled, legacy (``pooled=False``), with the disk
sidecar, with ``pq_abstracts`` and with overlapped admission — must give
equal token streams, TrafficLogs (shared and per sequence, bytes and
ops), ``prefix_stats()``, refcounts, shared maps and pool slot maps after
every event; the arena rows' stored K/V and abstracts come out of each
framework's prefill and are held to the admission tests' rule (one fp16
ulp plus 1e-5).  Integers, bytes and tokens are exact.

Last, kernel B3's guard: two sequences that miss one arena chunk in one
pooled fetch share one slot and one upload, and ``DeviceChunkPool.
scatter`` refuses a slot list with a repeated slot.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serving import prefix as jprefix
from repro.serving.engine import BatchedLeoAMEngine as JEngine
from repro.serving.engine import EngineCfg as JCfg
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import lm as tlm
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import BatchedLeoAMEngine as TEngine
from repro_torch.serving.engine import EngineCfg as TCfg
from repro_torch.serving.offload import DeviceChunkPool, TieredKVStore
from repro_torch.serving.prefix import PrefixIndex, chunk_hashes
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SchedulerCfg)
from repro_torch.serving.simulator import (HWCfg, ServeCfg, prefill_time,
                                           prefill_time_prefix)

CHUNK, KV_TOL = 16, 1e-5


def _cfg(get):
    cfg = get("longchat-7b-32k", smoke=True)
    return dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=CHUNK,
                                       importance_rate=0.4, early_rate=0.6,
                                       min_seq_for_sparse=32))


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg(get_config)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return _cfg(t_get_config), tparams, jcfg, jparams


def _engine(cfg, params, prefix_cache=True, max_seqs=3, **kw):
    ecfg = TCfg(max_len=128, selection="tree", prefill_chunk_tokens=32,
                prefix_cache=prefix_cache, **kw)
    return TEngine(cfg, params, ecfg, max_seqs=max_seqs, device="cpu")


def _decode(eng, sid, tok, n):
    stream = [tok]
    cur = {sid: tok}
    for _ in range(n):
        cur = eng.decode_round(cur)
        stream.append(cur[sid])
    return stream


# ---------------------------------------------------------------------------
# chunk_hashes / PrefixIndex units
# ---------------------------------------------------------------------------


def test_chunk_hashes_chain_commits_to_prefix():
    rng = np.random.RandomState(0)
    toks = rng.randint(2, 500, 64)
    h = chunk_hashes(toks, CHUNK)
    assert len(h) == 4
    # same prefix -> same hashes; a change in chunk 1 changes chunks 1..3
    other = toks.copy()
    other[CHUNK] += 1
    h2 = chunk_hashes(other, CHUNK)
    assert h2[0] == h[0] and all(a != b for a, b in zip(h[1:], h2[1:]))
    # the partial tail commits to its length
    assert chunk_hashes(toks[:26], CHUNK)[1] != chunk_hashes(
        toks[:32], CHUNK)[1]
    assert chunk_hashes(toks, CHUNK)[0] != chunk_hashes(toks, 2 * CHUNK)[0]
    # the copy hashes as the reference does, tails included
    for n in (1, 15, 16, 26, 64):
        assert chunk_hashes(toks[:n], CHUNK) == \
            jprefix.chunk_hashes(toks[:n], CHUNK)


def test_prefix_index_match_refcounts_and_eviction():
    px = PrefixIndex(rows=[10, 11])
    h = [b"h%d" % i for i in range(3)]
    row, scrub = px.alloc_row()
    assert (row, scrub) == (10, [])
    px.plan(row, range(3))
    for c in range(3):
        assert px.publish(row, c, h[c])
    assert not px.publish(99, 0, h[0])        # first registrant wins
    assert px.match(h) == [(10, 0), (10, 1), (10, 2)]
    assert px.match([h[0], b"x", h[2]]) == [(10, 0)]  # stops at first miss
    px.acquire([(10, 0)])
    px.acquire([(10, 0)])
    assert px.ref_count((10, 0)) == 2
    px.decref([(10, 0)])
    assert px.ref_count((10, 0)) == 1
    row2, _ = px.alloc_row()
    assert row2 == 11
    px.plan(row2, [0])
    px.acquire([(row2, 0)])
    assert px.alloc_row() is None             # every row pinned
    px.decref([(10, 0)])
    victim, scrub = px.alloc_row()
    assert victim == 10 and scrub == [0, 1, 2]
    assert px.match(h, record=False) == []
    with pytest.raises(AssertionError):
        px.decref([(10, 0)])                  # double-free trips


# ---------------------------------------------------------------------------
# warm == cold under randomized interleavings
# ---------------------------------------------------------------------------


def _schedule(seed, n_admit=6, max_live=3):
    """The reference's event list: admit/decode/release over two shared
    64-token prefixes with chunk-partial suffixes (so COW fires)."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(2, 500, 64) for _ in range(2)]
    events, live, decoded, admitted = [], [], {}, 0
    while admitted < n_admit or live:
        roll = rng.rand()
        if admitted < n_admit and len(live) < max_live and roll < 0.4:
            p = np.concatenate([prefixes[rng.randint(2)],
                                rng.randint(2, 500, rng.choice([8, 12, 16]))])
            events.append(("admit", admitted, p))
            live.append(admitted)
            decoded[admitted] = 0
            admitted += 1
        elif live and roll < 0.75:
            events.append(("decode",))
            for r in live:
                decoded[r] += 1
        elif live:
            full = [r for r in live if decoded[r] >= 5]
            r = full[0] if full else live[rng.randint(len(live))]
            events.append(("release", r))
            live.remove(r)
        for r in [r for r in live if decoded[r] >= 6]:
            events.append(("release", r))
            live.remove(r)
    return events


def _run(eng, events, *, mode="sync", after=None):
    """Replay ``events``; ``after(eng)`` runs after each one.  Returns the
    token streams by request id."""
    streams, sids, cur = {}, {}, {}
    for ev in events:
        if ev[0] == "admit":
            _, rid, prompt = ev
            if mode == "async":
                sid, tok = eng.add_sequence_async(prompt).result()
            else:
                sid, tok = eng.add_sequence(prompt)
            sids[rid], streams[rid], cur[sid] = sid, [tok], tok
        elif ev[0] == "decode":
            cur = eng.decode_round(cur)
            for rid, sid in sids.items():
                if sid in cur:
                    streams[rid].append(cur[sid])
        else:
            sid = sids[ev[1]]
            eng.release(sid)
            cur.pop(sid, None)
        if after is not None:
            after(eng)
    return streams


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warm_admission_token_identical_to_cold(setup, seed):
    """Any interleaving of admissions, decode rounds and releases over
    shared prefixes decodes the same token streams with the cache on and
    off."""
    cfg, params = setup[:2]
    events = _schedule(seed)
    out, stats = {}, None
    for pc in (True, False):
        eng = _engine(cfg, params, prefix_cache=pc)
        out[pc] = _run(eng, events)
        stats = stats or eng.store.prefix_stats()
        eng.store.close()
    assert out[True] == out[False], (seed, out)
    assert stats["prefix_hit_chunks"] > 0     # reuse engaged
    assert stats["shared_refs"] == 0          # all released -> no strand


# ---------------------------------------------------------------------------
# refcounts: N sharers released -> single-owner state
# ---------------------------------------------------------------------------


def test_release_of_n_sharers_restores_single_owner_state(setup):
    cfg, params = setup[:2]
    eng = _engine(cfg, params, max_seqs=3)
    rng = np.random.RandomState(5)
    prompt = rng.randint(2, cfg.vocab_size, 80)   # 5 full chunks
    store = eng.store

    sid0, tok0 = eng.add_sequence(prompt)
    single_refs = dict(store._prefix.refs)
    arena_disk = {row: np.array(store._disk[row])
                  for m in store._shared_map.values()
                  for row in set(m.values())}
    streams = {sid0: _decode(eng, sid0, tok0, 2)}

    sid1, tok1 = eng.add_sequence(prompt)
    sid2, tok2 = eng.add_sequence(prompt)
    streams[sid1] = _decode(eng, sid1, tok1, 2)
    streams[sid2] = _decode(eng, sid2, tok2, 2)
    assert streams[sid1] == streams[sid0] == streams[sid2]
    assert store._prefix.live_refs() > sum(single_refs.values())
    eng.release(sid1)
    eng.release(sid2)

    assert dict(store._prefix.refs) == single_refs
    for row, snap in arena_disk.items():
        np.testing.assert_array_equal(np.array(store._disk[row]), snap)
    eng.release(sid0)
    assert store._prefix.live_refs() == 0     # nothing stranded
    # zero refs is cache, not garbage: a fresh admission is still warm
    sid3, tok3 = eng.add_sequence(prompt)
    assert store.prefix_stats()["warm_admissions"] >= 3
    assert _decode(eng, sid3, tok3, 2) == streams[sid0]
    eng.store.close()


# ---------------------------------------------------------------------------
# COW: the writer privatizes, readers keep their bytes
# ---------------------------------------------------------------------------


def test_cow_preserves_shared_readers_bytes(setup):
    cfg, params = setup[:2]
    eng = _engine(cfg, params, max_seqs=3)
    rng = np.random.RandomState(6)
    prompt = rng.randint(2, cfg.vocab_size, 76)   # partial tail chunk
    tail_c = 76 // CHUNK                          # chunk 4, 12 tokens
    store = eng.store

    sid0, tok0 = eng.add_sequence(prompt)
    sid1, tok1 = eng.add_sequence(prompt)
    row = store._shared_map[sid1][tail_c]
    assert row >= store.n_seqs
    snap = np.array(store._disk[row, :, tail_c])

    s0 = _decode(eng, sid0, tok0, 3)
    assert store.cow_copies >= 1
    assert tail_c not in store._shared_map.get(sid0, {})
    assert store._shared_map[sid1][tail_c] == row
    np.testing.assert_array_equal(np.array(store._disk[row, :, tail_c]),
                                  snap)
    s1 = _decode(eng, sid1, tok1, 3)
    assert s1 == s0
    np.testing.assert_array_equal(np.array(store._disk[row, :, tail_c]),
                                  snap)
    eng.store.close()


# ---------------------------------------------------------------------------
# billing: zero-byte adoption, one chunk copy a layer per COW
# ---------------------------------------------------------------------------


def test_prefix_ref_bills_zero_and_cow_bills_one_chunk_copy(setup):
    cfg, params = setup[:2]
    eng = _engine(cfg, params, max_seqs=2)
    rng = np.random.RandomState(7)
    prompt = rng.randint(2, cfg.vocab_size, 76)
    store = eng.store
    n_layers = store.n_layers

    sid0, tok0 = eng.add_sequence(prompt)
    replica = store.log.bytes[("host", "disk", "kv_replica")]
    sid1, tok1 = eng.add_sequence(prompt)
    adopted = len(store._shared_map[sid1])
    assert adopted == 5                           # 4 full + the tail
    assert store.log.ops[("host", "disk", "prefix_ref")] == adopted
    assert store.log.bytes[("host", "disk", "prefix_ref")] == 0.0
    # the warm admission wrote no replica of an adopted chunk: only the
    # zero chunks past its prompt (8 - 5 a layer)
    assert store.log.bytes[("host", "disk", "kv_replica")] - replica == \
        (8 - adopted) * n_layers * float(store.chunk_bytes)
    assert store.prefix_stats()["bytes_deduped"] == adopted * n_layers * (
        store.chunk_bytes + store.abstract_bytes)

    _decode(eng, sid0, tok0, 2)
    _decode(eng, sid1, tok1, 2)
    cow = store.cow_copies
    assert cow == 2                               # each tail, once
    assert store.log.bytes[("host", "disk", "cow_copy")] == \
        cow * n_layers * float(store.chunk_bytes)
    assert store.log.bytes[("disk", "host", "cow_read")] == \
        cow * n_layers * float(store.chunk_bytes)
    for key, v in store.log.bytes.items():
        per_seq = sum(lg.bytes.get(key, 0.0)
                      for lg in store.seq_logs.values())
        assert v == per_seq, (key, v, per_seq)
    eng.store.close()


def test_shared_chunks_occupy_one_pool_slot(setup):
    cfg, params = setup[:2]
    eng = _engine(cfg, params, max_seqs=2)
    rng = np.random.RandomState(8)
    prompt = rng.randint(2, cfg.vocab_size, 80)
    store = eng.store
    sid0, tok0 = eng.add_sequence(prompt)
    sid1, tok1 = eng.add_sequence(prompt)
    cur = {sid0: tok0, sid1: tok1}
    for _ in range(2):
        cur = eng.decode_round(cur)
    # slots of shared chunks are keyed by the arena row: neither sequence
    # ever holds a private slot for an adopted chunk
    shared = 0
    for sid in (sid0, sid1):
        mapping = store._shared_map.get(sid, {})
        shared += len(mapping)
        for li, pool in enumerate(store.pools):
            for c, row in mapping.items():
                assert (sid, c) not in pool.slot_of, (sid, li, c)
    assert shared > 0
    eng.store.close()


# ---------------------------------------------------------------------------
# arena eviction under pressure
# ---------------------------------------------------------------------------


def test_arena_eviction_under_pressure_stays_correct(setup):
    cfg, params = setup[:2]
    eng = _engine(cfg, params, max_seqs=2, prefix_arena_rows=1)
    rng = np.random.RandomState(9)
    pa = rng.randint(2, cfg.vocab_size, 80)
    pb = rng.randint(2, cfg.vocab_size, 80)
    store = eng.store

    sid, tok = eng.add_sequence(pa)
    sa = _decode(eng, sid, tok, 2)
    # while A is live its row is held: B admits cold and unregistered
    sidb, tokb = eng.add_sequence(pb)
    assert sidb not in store._shared_map
    _decode(eng, sidb, tokb, 2)
    eng.release(sid)
    eng.release(sidb)

    sidb, tokb = eng.add_sequence(pb)         # evicts A's row
    assert store.prefix_stats()["arena_evictions"] == 1
    _decode(eng, sidb, tokb, 2)
    eng.release(sidb)

    assert store.prefix_probe(pa)["hit_chunks"] == 0
    sid, tok = eng.add_sequence(pa)
    assert _decode(eng, sid, tok, 2) == sa
    eng.store.close()


# ---------------------------------------------------------------------------
# scheduler: stats surface and admission credit
# ---------------------------------------------------------------------------


def test_scheduler_stats_and_admission_credit(setup):
    cfg, params = setup[:2]
    eng = _engine(cfg, params, max_seqs=3)
    rng = np.random.RandomState(10)
    prompt = rng.randint(2, cfg.vocab_size, 80)
    b = ContinuousBatcher(cfg=SchedulerCfg(max_active=2, chunk=CHUNK),
                          engine=eng)
    cold_need = b._need(Request(0, prompt, max_new=4))

    sid, tok = eng.add_sequence(prompt)
    _decode(eng, sid, tok, 2)
    eng.release(sid)
    probe = eng.store.prefix_probe(prompt)
    assert probe["device_hits"] > 0
    warm_need = b._need(Request(1, prompt, max_new=4))
    assert warm_need == max(cold_need - probe["device_hits"], 1)
    assert warm_need < cold_need
    assert b._need(Request(1, prompt, max_new=4)) == warm_need  # memoized

    sid, tok = eng.add_sequence(prompt)
    eng.release(sid)
    stt = b.stats()
    assert stt["prefix_hit_rate"] > 0
    assert stt["warm_admissions"] >= 1
    assert "shared_chunks" in stt and "bytes_deduped" in stt
    eng.store.close()


def test_scheduler_runs_requests_through_prefix_engine(setup):
    cfg, params = setup[:2]
    eng = _engine(cfg, params, max_seqs=3)
    rng = np.random.RandomState(11)
    prefix = rng.randint(2, cfg.vocab_size, 64)
    b = ContinuousBatcher(cfg=SchedulerCfg(max_active=2, chunk=CHUNK),
                          engine=eng)
    for rid in range(4):
        p = np.concatenate([prefix, rng.randint(2, cfg.vocab_size, 12)])
        b.submit(Request(rid, p, max_new=4))
    done = b.run()
    assert len(done) == 4 and all(len(r.out) == 4 for r in done)
    assert b.stats()["warm_admissions"] >= 3
    assert eng.store.prefix_stats()["shared_refs"] == 0
    eng.store.close()


# ---------------------------------------------------------------------------
# engine config gates
# ---------------------------------------------------------------------------


def test_prefix_cache_rejects_recurrent_and_bad_chunking(setup):
    cfg, params = setup[:2]
    xcfg = t_get_config("xlstm-125m", smoke=True)
    with pytest.raises(ValueError, match="attention-only"):
        TEngine(xcfg, params, TCfg(max_len=128, prefix_cache=True,
                                   prefill_chunk_tokens=32), device="cpu")
    for C in (24, 48):                        # not a multiple / no divisor
        with pytest.raises(ValueError, match="prefill_chunk_tokens"):
            TEngine(cfg, params, TCfg(max_len=128, prefix_cache=True,
                                      prefill_chunk_tokens=C), device="cpu")


# ---------------------------------------------------------------------------
# simulator: prefix-aware TTFT model
# ---------------------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(st.floats(0.0, 1.0))
def test_prefill_time_prefix_bounded_and_anchored(hit_frac):
    cfg = t_get_config("longchat-7b-32k")
    scfg, hw = ServeCfg(), HWCfg()
    base = prefill_time(cfg, scfg, hw)
    t = prefill_time_prefix(cfg, scfg, hw, hit_frac)
    assert 0.0 < t <= base + 1e-12
    assert prefill_time_prefix(cfg, scfg, hw, 0.0) == pytest.approx(base)


def test_prefill_time_prefix_monotone_decreasing():
    cfg = t_get_config("longchat-7b-32k")
    scfg, hw = ServeCfg(), HWCfg()
    ts = [prefill_time_prefix(cfg, scfg, hw, h)
          for h in np.linspace(0.0, 1.0, 9)]
    assert all(a > b for a, b in zip(ts, ts[1:]))


# ---------------------------------------------------------------------------
# fidelity rows: bf16 kept as bf16, the round trip bitwise
# ---------------------------------------------------------------------------


def test_fidelity_rows_keep_bf16_and_round_trip_bitwise(tmp_path):
    """Ingest is handed bf16 values widened to f32; a store with
    ``fidelity_dtype=bfloat16`` keeps its registered rows as bf16 (half
    the host bytes) and hands back exactly the original values, which
    ``load_prefix_rows`` writes into a bf16 cache bit for bit."""
    cfg = dataclasses.replace(_cfg(t_get_config), dtype="bfloat16")
    n_layers, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    st_ = TieredKVStore(n_layers, 8, CHUNK, Hkv, hd, n_seqs=1,
                        prefix_rows=1, root=str(tmp_path), device="cpu",
                        fidelity_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    toks = np.arange(2, 2 + 3 * CHUNK)
    assert st_.prefix_admit(0, toks) == 0     # cold: registers 3 chunks
    rows = []
    for li in range(n_layers):
        k, v = (torch.randn(3 * CHUNK, Hkv, hd, generator=gen,
                            dtype=torch.bfloat16) for _ in range(2))
        rows.append((k, v))
        st_.ingest(li, k.float().numpy(), v.float().numpy(), seq=0)
    assert all(k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16
               for k, v in st_._fidelity.values())
    back = st_.prefix_fill_rows(0, 2 * CHUNK)
    for (k, v), (bk, bv) in zip(rows, back):
        assert torch.equal(bk.view(torch.int16),
                           k[:2 * CHUNK].view(torch.int16))
        assert torch.equal(bv.view(torch.int16),
                           v[:2 * CHUNK].view(torch.int16))
    cache = tlm.init_decode_cache(cfg, 1, 128, device="cpu")
    tlm.load_prefix_rows(cfg, cache, back, 2 * CHUNK)
    layers = [cache["prologue"][i] for i in range(len(cache["prologue"]))]
    reps = cache["body"][0]["k"].shape[0] if cache["body"] else 0
    layers += [{n: cache["body"][pi][n][r] for n in ("k", "v")}
               for r in range(reps) for pi in range(len(cache["body"]))]
    for c, (k, v) in zip(layers, rows):
        assert torch.equal(c["k"][0, :2 * CHUNK].view(torch.int16),
                           k[:2 * CHUNK].view(torch.int16))
        assert torch.equal(c["v"][0, :2 * CHUNK].view(torch.int16),
                           v[:2 * CHUNK].view(torch.int16))
        assert not c["k"][0, 2 * CHUNK:].any()
    st_.close()


def test_load_prefix_rows_matches_reference(setup):
    cfg, _, jcfg, _ = setup
    rng = np.random.RandomState(3)
    n, L = 2 * CHUNK, cfg.n_layers
    rows = [tuple(rng.randn(n, cfg.n_kv_heads, cfg.hd).astype(np.float32)
                  for _ in range(2)) for _ in range(L)]
    tcache = tlm.load_prefix_rows(
        cfg, tlm.init_decode_cache(cfg, 1, 128, device="cpu"), rows, n)
    jcache = jlm.load_prefix_rows(
        jcfg, jlm.init_decode_cache(jcfg, 1, 128), rows, n)
    for tc, jc in zip(tcache["prologue"], jcache["prologue"]):
        for name in ("k", "v"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
    for tc, jc in zip(tcache["body"], jcache["body"]):
        for name in ("k", "v"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))


# ---------------------------------------------------------------------------
# the port against repro: the same schedules through both packages
# ---------------------------------------------------------------------------


def _pair_engine(port, setup, **kw):
    cfg, tparams, jcfg, jparams = setup
    base = dict(max_len=128, selection="tree", prefill_chunk_tokens=32,
                prefix_cache=True, prefix_arena_rows=2)
    base.update(kw)
    if port:
        eng = TEngine(cfg, tparams, TCfg(**base), max_seqs=3, device="cpu")
    else:
        eng = JEngine(jcfg, jparams, JCfg(**base), max_seqs=3)
    eng._theta = lambda li: 0.5        # θ comes from wall clock: pin it
    return eng


def _observe(trace):
    """What must be equal after every event: prefix counters, refcounts,
    shared maps and the device tier's residency.  Each event ends with the
    write-behind ingest and the requant sweep's background re-encodes
    landed, so that the next round's reads do not race them on either
    side."""
    def after(eng):
        st_ = eng.store
        st_.ingest_fence_all()
        st_.requant_fence()
        trace.append({
            "stats": st_.prefix_stats(),
            "refs": dict(st_._prefix.refs) if st_._prefix else {},
            "shared": {s: dict(m) for s, m in st_._shared_map.items()},
            "slots": [dict(p.slot_of) for p in st_.pools if p is not None],
            "dev": sorted(st_._dev_k), "tier": st_.tier.copy()})
    return after


def _pair_run(port, setup, seed, mode, **kw):
    eng = _pair_engine(port, setup, **kw)
    trace = []
    streams = _run(eng, _schedule(seed), mode=mode, after=_observe(trace))
    st_ = eng.store
    st_.ingest_fence_all()
    st_.requant_fence()
    arena = slice(st_.n_seqs, None)
    out = dict(streams=streams, trace=trace,
               bytes=dict(st_.log.bytes), ops=dict(st_.log.ops),
               seq_bytes={s: dict(lg.bytes) for s, lg in st_.seq_logs.items()},
               retired=[(dict(lg.bytes), dict(lg.ops))
                        for lg in st_.retired_logs],
               disk=np.array(st_._disk[arena]), km=st_._abs_km[arena].copy(),
               kn=st_._abs_kn[arena].copy(), pool=st_.pool_stats(),
               fid=sorted(st_._fidelity))
    st_.close()
    return out


def _kv_close(t, j):
    """Stored K/V of the two frameworks: each one's prefill within 1e-5,
    then rounded to fp16 once."""
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t))
    t, j = t[fin].astype(np.float32), j[fin].astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(t), np.abs(j)).astype(
        np.float16)).astype(np.float32)
    assert np.all(np.abs(t - j) <= ulp + KV_TOL), np.abs(t - j).max()


_MODES = {
    "pooled": ("sync", {}),
    "legacy": ("sync", {"pooled": False}),
    "sidecar": ("sync", {"disk_sidecar": True, "real_codec": True}),
    "pq": ("sync", {"pq_abstracts": True, "cpu_chunk_frac": 0.2}),
    "overlapped": ("async", {}),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(_MODES))
def test_prefix_schedule_matches_reference(setup, name, seed):
    mode, kw = _MODES[name]
    t = _pair_run(True, setup, seed, mode, **kw)
    j = _pair_run(False, setup, seed, mode, **kw)
    assert t["streams"] == j["streams"]
    assert t["bytes"] == j["bytes"] and t["ops"] == j["ops"]
    assert t["seq_bytes"] == j["seq_bytes"]
    assert t["retired"] == j["retired"]
    assert len(t["trace"]) == len(j["trace"])
    for a, b in zip(t["trace"], j["trace"]):
        assert a["stats"] == b["stats"]
        assert a["refs"] == b["refs"]
        assert a["shared"] == b["shared"]
        assert a["slots"] == b["slots"] and a["dev"] == b["dev"]
        assert np.array_equal(a["tier"], b["tier"])
    assert t["pool"] == j["pool"]
    assert t["fid"] == j["fid"]
    assert t["trace"][-1]["stats"]["prefix_hit_chunks"] > 0
    for k in ("disk", "km", "kn"):
        _kv_close(t[k], j[k])


# ---------------------------------------------------------------------------
# kernel B3's guard: one slot and one upload per missed arena chunk
# ---------------------------------------------------------------------------


def _shared_store(tmp_path, real_codec):
    """A one-layer pooled store whose two arena chunks (row 2) are held
    by both sequences — registered by seq 0, adopted by seq 1 — and sit
    on the host, in no pool slot."""
    st_ = TieredKVStore(1, 4, CHUNK, 2, 8, n_seqs=2, prefix_rows=1,
                        use_pool=True, real_codec=real_codec,
                        root=str(tmp_path), device="cpu")
    rng = np.random.RandomState(0)
    toks = np.arange(2, 2 + 2 * CHUNK)
    st_.prefix_admit(0, toks)
    kv = rng.randn(2 * CHUNK, 2, 8).astype(np.float32)
    st_.ingest(0, kv, kv * 0.5, seq=0)
    st_.finish_admission(0)
    assert st_.prefix_admit(1, toks) == 2 * CHUNK
    assert st_._shared_map[0] == st_._shared_map[1] == {0: 2, 1: 2}
    return st_


@pytest.mark.parametrize("real_codec", [False, True])
def test_two_sequences_missing_one_arena_chunk_share_one_upload(
        tmp_path, real_codec):
    st_ = _shared_store(tmp_path, real_codec)
    pool = st_.pools[0]
    scattered = []
    scatter = pool.scatter

    def spy(slots, *a, **kw):
        scattered.append(list(slots))
        return scatter(slots, *a, **kw)

    pool.scatter = spy
    slots, nsel, fst = st_.fetch_chunks_pooled(0, {0: [0, 1], 1: [0, 1]},
                                               theta=1.0)
    assert fst.uploads == 2 and fst.hits == 0
    assert list(slots[0]) == list(slots[1])   # one slot per arena chunk
    assert len(scattered) == 1 and len(scattered[0]) == 2
    assert sorted(scattered[0]) == sorted(slots[0].tolist())
    assert set(pool.slot_of) == {(2, 0), (2, 1)}
    # one upload each, billed kv_shared to the first sequence that missed
    assert st_.seq_logs[0].ops[("host", "device", "kv_shared")] == 2
    assert ("host", "device", "kv_shared") not in st_.seq_logs[1].ops
    if not real_codec:                        # fp16 upload: the host rows
        np.testing.assert_array_equal(
            pool.kv[torch.as_tensor(slots[0], dtype=torch.long)].numpy(),
            np.stack([np.stack([st_._host_k[(2, 0, c)],
                                st_._host_v[(2, 0, c)]]) for c in (0, 1)]))
    st_.close()


def test_scatter_refuses_a_repeated_slot():
    pool = DeviceChunkPool(4, CHUNK, 2, 8, torch.float16,
                           torch.device("cpu"))
    kv = np.ones((3, 2, CHUNK, 2, 8), np.float16)
    with pytest.raises(ValueError, match="slot 1 appears more than once"):
        pool.scatter([1, 3, 1], kv)
    assert not pool.kv.any()                  # nothing written
    pool.scatter([1, 3, 0], kv)               # distinct slots go through
    assert pool.kv[[0, 1, 3]].all()
