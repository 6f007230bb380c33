"""The port's three admission modes against ``repro``'s, on the longchat
smoke config (chunk 16, ``max_len`` 128, ragged prompts, θ pinned):
synchronous ``add_sequence``, overlapped ``add_sequence_async`` (prefill and
ingest on the ``leoam-admit`` worker, device placements deferred into the
pool's ``pending_place``) and chunked ``begin_admission`` /
``ChunkedAdmission`` — directly and through ``ContinuousBatcher``.  Ported
from ``tests/test_pipelined_admission.py`` and
``tests/test_chunked_prefill.py``.

What each mode must give, against the same mode of ``repro``: identical
token streams, TrafficLog (bytes and ops), tier labels and pool slot maps.
The stored K/V (disk replica, min/max abstracts) comes out of each
framework's own prefill, which agree within 1e-5 (ROADMAP's prefill
tolerance), and is then rounded to fp16 once: it is held to that, one fp16
ulp of each value plus 1e-5.  Inside each package every mode stores the
synchronous mode's bytes bit for bit, which is what a mode may not change.
Store scripts that feed both stores the same K/V are bitwise equal.

Left out on purpose: the JAX compile-count test
(``test_mixed_lengths_compile_log_programs``) bounds the number of XLA
programs, and eager PyTorch compiles none, so it has no counterpart here;
the disk-sidecar and ``masked_state_scan`` tests wait for the sidecar
(ROADMAP A4) and recurrent layers (A11).
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.pipeline import chunked_admission_model as j_model
from repro.models import lm as jlm
from repro.serving.engine import BatchedLeoAMEngine as JEngine
from repro.serving.engine import EngineCfg as JCfg
from repro.serving.offload import TieredKVStore as JStore
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerCfg as JSched
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.pipeline import chunked_admission_model
from repro_torch.models import lm as tlm
from repro_torch.models.params import params_from_jax
from repro_torch.serving import offload as toffload
from repro_torch.serving.engine import BatchedLeoAMEngine as TEngine
from repro_torch.serving.engine import EngineCfg as TCfg
from repro_torch.serving.faults import AdmissionError
from repro_torch.serving.offload import DEVICE, DISK, HOST
from repro_torch.serving.offload import TieredKVStore as TStore
from repro_torch.serving.scheduler import ContinuousBatcher as TBatcher
from repro_torch.serving.scheduler import Request as TRequest
from repro_torch.serving.scheduler import SchedulerCfg as TSched

LENS, THETA, KV_TOL = (48, 57, 64, 50), 0.5, 1e-5


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
    rng = np.random.RandomState(7)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in LENS]
    return cfg, tcfg, params, tparams, prompts


def _engine(port, setup, max_seqs=2, **kw):
    cfg, tcfg, params, tparams, _ = setup
    if port:
        eng = TEngine(tcfg, tparams, TCfg(max_len=128, selection="tree", **kw),
                      max_seqs=max_seqs, device="cpu")
    else:
        eng = JEngine(cfg, params, JCfg(max_len=128, selection="tree", **kw),
                      max_seqs=max_seqs)
    eng._theta = lambda li: THETA      # θ comes from wall clock: pin it
    return eng


def _snapshot(eng, out=None):
    """Everything a mode may not change, after every write has landed."""
    st = eng.store
    st.ingest_fence_all()
    st.requant_fence()
    res = dict(out=out, bytes=dict(st.log.bytes), ops=dict(st.log.ops),
               disk=np.array(st._disk), km=st._abs_km.copy(),
               kn=st._abs_kn.copy(), tier=st.tier.copy(),
               slots=[dict(p.slot_of) for p in st.pools])
    if st.pq:
        res.update(codes=np.array(st._pq_codes), cb=st._pq_cb.copy(),
                   counts=st._pq_counts.copy(), valid=st._pq_valid.copy())
    return res


def _kv_close(t, j):
    """Stored K/V of the two frameworks: each one's prefill within 1e-5,
    then rounded to fp16 once."""
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t))
    t, j = t[fin].astype(np.float32), j[fin].astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(t), np.abs(j)).astype(
        np.float16)).astype(np.float32)
    assert np.all(np.abs(t - j) <= ulp + KV_TOL), np.abs(t - j).max()


def _same(t, j, kv=True):
    """Port against reference, same mode.  ``kv``: the stored K/V too —
    for a store that only admission wrote; rows that decode rounds
    appended come out of each framework's decode arithmetic, which the
    token streams and logs hold instead."""
    assert t["out"] == j["out"]
    assert t["bytes"] == j["bytes"] and t["ops"] == j["ops"]
    assert np.array_equal(t["tier"], j["tier"])
    assert t["slots"] == j["slots"]
    for k in ("disk", "km", "kn") if kv else ():
        _kv_close(t[k], j[k])


def _bitwise(a, b):
    """Two runs of one package: the stored bytes are identical."""
    for k in ("disk", "km", "kn"):
        assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# Model: chunked prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,C", [(41, 32), (64, 16), (100, 64)])
def test_prefill_chunk_matches_reference(setup, S, C):
    """Chunk by chunk, the port's ``prefill_chunk`` gives the reference's
    logits within 1e-4 and its decode cache within 1e-5; the last chunk's
    logits are whole-prompt prefill's."""
    cfg, tcfg, params, tparams, _ = setup
    prompt = np.random.RandomState(S).randint(2, cfg.vocab_size, S)
    jc = jlm.init_decode_cache(cfg, 1, 128)
    tc = tlm.init_decode_cache(tcfg, 1, 128, device="cpu")
    for start in range(0, S, C):
        toks = np.zeros(C, np.int64)
        toks[:min(C, S - start)] = prompt[start:start + C]
        jl, jc = jlm.prefill_chunk(
            params, cfg, {"tokens": toks[None].astype(np.int32),
                          "start": start, "length": S}, jc, max_len=128)
        with torch.no_grad():
            tl, tc = tlm.prefill_chunk(
                tparams, tcfg, {"tokens": torch.from_numpy(toks[None]),
                                "start": start, "length": S}, tc,
                max_len=128)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        for part in ("prologue", "body"):
            for jd, td in zip(jc[part], tc[part]):
                for name in ("k", "v"):
                    np.testing.assert_allclose(
                        td[name].numpy(), np.asarray(jd[name]), atol=1e-5,
                        rtol=1e-5)
    with torch.no_grad():
        whole, _ = tlm.prefill(tparams, tcfg,
                               {"tokens": torch.from_numpy(prompt[None])},
                               max_len=128)
    np.testing.assert_allclose(tl.numpy(), whole.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_init_decode_cache_has_prefills_structure(setup):
    """A zeroed batch-1 cache shaped, typed and nested as ``prefill``'s."""
    _, tcfg, _, tparams, prompts = setup
    with torch.no_grad():
        _, pc = tlm.prefill(tparams, tcfg,
                            {"tokens": torch.from_numpy(prompts[0][None])},
                            max_len=128)
    zc = tlm.init_decode_cache(tcfg, 1, 128, device="cpu")
    for part in ("prologue", "body"):
        assert len(zc[part]) == len(pc[part])
        for z, p in zip(zc[part], pc[part]):
            assert sorted(z) == sorted(p) == ["k", "v"]
            for name in ("k", "v"):
                assert z[name].shape == p[name].shape
                assert z[name].dtype == p[name].dtype
                assert not z[name].any()


@pytest.mark.parametrize("q_offset", [0, 16, 40])
def test_blocked_attention_q_offset_matches_reference(q_offset):
    """Query rows at global positions ``q_offset + [0, S)``: the causal and
    window masks as the reference draws them."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.RandomState(q_offset)
    q = rng.randn(2, 8, 4, 16).astype(np.float32)
    k = rng.randn(2, 64, 2, 16).astype(np.float32)
    v = rng.randn(2, 64, 2, 16).astype(np.float32)
    for window in (None, 24):
        want = jattn.blocked_attention(q, k, v, window=window, block_kv=32,
                                       q_offset=q_offset)
        got = tattn.blocked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=window, block_kv=32, q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# Engine: the three modes, directly
# ---------------------------------------------------------------------------


def _admit_all(eng, prompts, mode):
    toks = {}
    for p in prompts:
        if mode == "sync":
            sid, tok = eng.add_sequence(p)
        elif mode == "async":
            sid, tok = eng.add_sequence_async(p).result(timeout=300)
        else:
            sid, tok = eng.begin_admission(p).drain()
        toks[sid] = tok
    return toks


def _run_direct(port, setup, mode, rounds=4, **kw):
    """Admit every prompt, snapshot the store that admission wrote, then
    decode; returns (admitted store, after decoding, admit profiles)."""
    eng = _engine(port, setup, max_seqs=len(LENS), prefill_chunk_tokens=32,
                  **kw)
    toks = _admit_all(eng, setup[4], mode)
    admitted = _snapshot(eng, dict(toks))
    out = {sid: [t] for sid, t in toks.items()}
    for _ in range(rounds):
        toks = eng.decode_round(toks)
        for sid, t in toks.items():
            out[sid].append(t)
    decoded = _snapshot(eng, out)
    eng.store.close()
    return admitted, decoded, list(eng.admit_profiles)


_DIRECT = {}


def _direct(port, setup, mode, **kw):
    key = (port, mode, tuple(sorted(kw.items())))
    if key not in _DIRECT:
        _DIRECT[key] = _run_direct(port, setup, mode, **kw)
    return _DIRECT[key]


@pytest.mark.parametrize("mode", ["sync", "async", "chunked"])
@pytest.mark.parametrize("codec", [False, True], ids=["ledger", "codec"])
def test_admission_mode_matches_reference(setup, mode, codec):
    """Each mode against the same mode of ``repro``, then against the
    port's own synchronous admission: the stored bytes bit for bit."""
    kw = {"real_codec": True} if codec else {}
    t, t_dec, t_prof = _direct(True, setup, mode, **kw)
    j, j_dec, j_prof = _direct(False, setup, mode, **kw)
    _same(t, j)
    _same(t_dec, j_dec, kv=False)
    sync, sync_dec, _ = _direct(True, setup, "sync", **kw)
    _bitwise(t, sync)
    _bitwise(t_dec, sync_dec)
    assert t_dec["out"] == sync_dec["out"]
    # overlapped admission defers its device placements (tiered HOST until
    # the first round folds them); after decoding the tiers agree
    want = np.where(sync["tier"] == DEVICE, HOST, sync["tier"]) \
        if mode == "async" else sync["tier"]
    assert np.array_equal(t["tier"], want)
    assert np.array_equal(t_dec["tier"], sync_dec["tier"])
    keys = {"total_s", "prefill_s", "ingest_s", "overlapped"}
    if mode == "chunked":
        keys |= {"chunked", "chunks"}
        assert [p["chunks"] for p in t_prof] == \
            [float(-(-n // 32)) for n in LENS]
    assert all(set(p) == keys for p in t_prof)
    assert all(set(p) - {"prefix_hit_tokens"} == keys for p in j_prof)


def test_async_admission_runs_on_the_admission_worker(setup):
    """``add_sequence_async`` runs ``_admit`` on the ``leoam-admit`` thread
    with device placements deferred; the next decode round folds them
    into the pool, unbilled."""
    eng = _engine(True, setup)
    seen = []
    admit = eng._admit

    def spy(*a, **kw):
        seen.append((threading.current_thread().name, kw["pool_place"]))
        return admit(*a, **kw)

    eng._admit = spy
    sid, tok = eng.add_sequence_async(setup[4][0]).result(timeout=60)
    assert seen == [(seen[0][0], False)]
    assert seen[0][0].startswith("leoam-admit")
    pools = eng.store.pools
    assert all(p.pending_place and not p.slot_of for p in pools)
    assert (eng.store.tier[sid] != DEVICE).all()
    deferred = sum(len(p.pending_place) for p in pools)
    eng.decode_round({sid: tok})
    assert not any(p.pending_place for p in pools)
    assert all((sid, 0) in p.slot_of for p in pools)
    # the slab took the round's selection misses and the folds; only the
    # misses were billed
    billed = eng.store.log.ops[(HOST, DEVICE, "kv")]
    assert sum(p.uploads for p in pools) == billed + deferred
    eng.store.close()


def test_async_admission_failure_names_the_slot(setup):
    """A failed worker admission resolves the future with AdmissionError
    carrying the slot; ``abort_admission`` reclaims exactly that slot."""
    eng = _engine(True, setup)

    def boom(*a, **kw):
        raise RuntimeError("prefill failed")

    eng._prefill = boom
    fut = eng.add_sequence_async(setup[4][0])
    with pytest.raises(AdmissionError) as err:
        fut.result(timeout=60)
    assert eng.free_slots == 1
    eng.abort_admission(err.value.sid)
    assert eng.free_slots == 2
    eng.store.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_admission_interleaved_matches_serial(setup, seed):
    """Chunked admission stepped at random points between a running
    sequence's decode rounds: the port equals ``repro`` under the same
    interleaving, and its token streams equal whole-prompt admission's at
    the same round schedule."""
    cfg = setup[0]
    rng = np.random.RandomState(seed)
    pa = rng.randint(2, cfg.vocab_size, 41)
    pb = rng.randint(2, cfg.vocab_size, 57)
    pre_rounds = int(rng.randint(0, 3))
    interleave = [bool(b) for b in rng.randint(2, size=8)]

    def run(port, chunked):
        """(store after B's admission, after the last round)."""
        eng = _engine(port, setup, prefill_chunk_tokens=32)
        sa_, ta = eng.add_sequence(pa)
        outs = {sa_: [ta]}
        toks = {sa_: ta}
        for _ in range(pre_rounds):
            toks = eng.decode_round(toks)
            outs[sa_].append(toks[sa_])
        if chunked:
            adm = eng.begin_admission(pb)
            for do_round in interleave:
                adm.step()
                if adm.done:
                    break
                if do_round:
                    toks = eng.decode_round(toks)
                    outs[sa_].append(toks[sa_])
            sb, tb = adm.drain()
            assert adm.remaining == 0 and adm.n_steps == 2
        else:
            sb, tb = eng.add_sequence(pb)
        eng.store.ingest_fence(sb)
        b_rows = np.array(eng.store._disk[sb])
        outs[sb] = [tb]
        toks[sb] = tb
        for _ in range(3):
            toks = eng.decode_round(toks)
            for s, t in toks.items():
                outs[s].append(t)
        res = _snapshot(eng, outs)
        eng.store.close()
        return b_rows, res

    b_rows, t = run(True, True)
    j_rows, j = run(False, True)
    _same(t, j, kv=False)
    _kv_close(b_rows, j_rows)
    ser_rows, ser = run(True, False)
    assert np.array_equal(b_rows, ser_rows)
    a, b = sorted(t["out"])
    n = min(len(t["out"][a]), len(ser["out"][a]))
    assert t["out"][a][:n] == ser["out"][a][:n]
    assert t["out"][b] == ser["out"][b]


def test_chunked_admission_with_pq_abstracts_matches_reference(setup):
    """A PQ store admitted chunk by chunk trains its codebook once per
    partial batch on the write-behind worker: codes, counts and validity
    equal ``repro``'s, the codebook within one fp16 ulp of its largest
    entry (each side's keys come from its own prefill, see
    ``tests/test_torch_pq.py``)."""
    kw = dict(pq_abstracts=True, cpu_chunk_frac=0.2)
    t, t_dec, _ = _direct(True, setup, "chunked", **kw)
    j, j_dec, _ = _direct(False, setup, "chunked", **kw)
    _same(t, j)
    _same(t_dec, j_dec, kv=False)
    assert t_dec["bytes"][(DISK, HOST, "pq_codes_read")] > 0
    for k in ("codes", "counts", "valid"):
        np.testing.assert_array_equal(t[k], j[k])
    ulp = float(np.spacing(np.float16(np.abs(j["cb"]).max())))
    assert np.abs(t["cb"] - j["cb"]).max() <= ulp


# ---------------------------------------------------------------------------
# Engine: through the batcher
# ---------------------------------------------------------------------------


def _drive(port, setup, order, *, mode, max_new=4, budget=32, **scfg_kw):
    eng = _engine(port, setup, prefill_chunk_tokens=16)
    Batcher, Request, Sched = (TBatcher, TRequest, TSched) if port else \
        (JBatcher, JRequest, JSched)
    b = Batcher(engine=eng, cfg=Sched(
        max_active=2, chunk=16, overlap_admission=mode == "async",
        chunked_admission=mode == "chunked", prefill_round_tokens=budget,
        **scfg_kw))
    for i in order:
        b.submit(Request(int(i), setup[4][i], max_new=max_new))
    done = b.run()
    out = {r.rid: r.out for r in done}
    assert all(r.error is None for r in done)
    stats = b.stats()
    res = _snapshot(eng, out)
    eng.store.close()
    return res, stats


_SERIAL = {}


def _serial(setup):
    if not _SERIAL:
        _SERIAL["res"] = _drive(True, setup, range(4), mode="sync")[0]
    return _SERIAL["res"]


@pytest.mark.parametrize("seed", [0, 1])
def test_overlapped_admission_arrival_order_parity(setup, seed):
    """``SchedulerCfg(overlap_admission=True)``: for a random arrival
    order the port's batcher gives ``repro``'s token streams and the
    serial order's, with every admission on the worker."""
    order = list(np.random.RandomState(seed).permutation(4))
    t, _ = _drive(True, setup, order, mode="async")
    j, _ = _drive(False, setup, order, mode="async")
    assert t["out"] == j["out"] == _serial(setup)["out"]
    assert t["bytes"] == j["bytes"] and t["ops"] == j["ops"]
    assert np.array_equal(t["tier"], j["tier"])


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_chunked_admission_matches_reference(setup, seed):
    """``SchedulerCfg(chunked_admission=True)``: budgeted chunk steps
    between rounds give ``repro``'s streams, TrafficLog, tiers and slot
    maps for a random arrival order and budget, and the serial streams."""
    rng = np.random.RandomState(seed)
    order = list(rng.permutation(4))
    budget = int(rng.choice([16, 32, 64]))
    t, ts = _drive(True, setup, order, mode="chunked", budget=budget)
    j, js = _drive(False, setup, order, mode="chunked", budget=budget)
    _same(t, j, kv=False)
    assert t["out"] == _serial(setup)["out"]
    assert "chunk_step_ewma_s" in ts and "chunk_step_ewma_s" in js


# ---------------------------------------------------------------------------
# C7: a scheduler mode runs, or raises naming its ROADMAP item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["async", "chunked"])
def test_batcher_runs_the_mode_it_was_asked_for(setup, mode):
    """The scheduler copy picks a mode by ``hasattr`` on the engine: the
    port's batcher must really run it, never admit synchronously in its
    place.  Overlapped: every admission's prefill runs on the admission
    worker.  Chunked: ``stats()`` carries the chunk-step EWMA and every
    admission profile is a chunked one."""
    eng = _engine(True, setup, prefill_chunk_tokens=16)
    threads = []
    admit = eng._admit

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return admit(*a, **kw)

    eng._admit = spy
    b = TBatcher(engine=eng, cfg=TSched(
        max_active=2, chunk=16, overlap_admission=mode == "async",
        chunked_admission=mode == "chunked"))
    for i in range(3):
        b.submit(TRequest(i, setup[4][i], max_new=3))
    done = b.run()
    assert len(done) == 3 and all(r.error is None for r in done)
    stats = b.stats()
    if mode == "async":
        assert len(threads) == 3
        assert all(n.startswith("leoam-admit") for n in threads)
        assert "chunk_step_ewma_s" not in stats
    else:
        assert threads == []
        assert stats["chunk_step_ewma_s"] > 0
        assert all(p.get("chunked") == 1.0 for p in eng.admit_profiles)
    eng.store.close()


class _Resource:
    """A pressure monitor that turns resource-yellow after its first
    sample: the scheduler then drains one victim per round by
    preemption."""

    def __init__(self):
        self.samples = 0

    def sample(self, queue_len):
        self.samples += 1
        return ("green", ()) if self.samples == 1 else ("yellow", ("pool",))


def test_preemption_raises_naming_its_roadmap_item(setup):
    """The batcher's preemption path reaches the engine.  Until the fault
    domain landed (ROADMAP A9) the engine's ``suspend_sequence`` and
    ``resume_sequence`` raised ``NotImplementedError`` naming A9 here; now
    nothing raises: the resource-yellow monitor makes the batcher suspend
    a victim and resume it, and both requests finish with their tokens."""
    eng = _engine(True, setup)
    b = TBatcher(engine=eng, cfg=TSched(max_active=2, chunk=16),
                 monitor=_Resource())
    for i in range(2):
        b.submit(TRequest(i, setup[4][i], max_new=4))
    done = b.run()
    assert sorted(r.rid for r in done) == [0, 1]
    assert all(r.error is None and len(r.out) == 4 for r in done)
    st = b.stats()
    assert st["suspensions"] >= 1 and st["resumes"] >= 1
    assert not eng.suspended and not eng.store._swapped
    for call in (eng.suspend_sequence, eng.resume_sequence):
        with pytest.raises(KeyError):  # no such live or parked sequence
            call(0)
    eng.store.close()


# ---------------------------------------------------------------------------
# Lifecycle guards
# ---------------------------------------------------------------------------


def test_release_drains_inflight_writes_before_slot_reuse(setup):
    """A retired sequence's write-behind ingest is drained by release():
    the slot's next occupant decodes as on a fresh engine, and as on
    ``repro``'s."""
    def gen(eng, p, n=4):
        sid, tok = eng.add_sequence(p)
        out = [tok]
        toks = {sid: tok}
        for _ in range(n):
            toks = eng.decode_round(toks)
            out.append(toks[sid])
        return sid, out

    prompts = setup[4]
    fresh = _engine(True, setup, max_seqs=1)
    _, want = gen(fresh, prompts[1])
    fresh.store.close()
    ref = _engine(False, setup, max_seqs=1)
    _, want_j = gen(ref, prompts[1])
    ref.store.close()

    eng = _engine(True, setup, max_seqs=1)
    sid, _ = eng.add_sequence(prompts[0])
    eng.release(sid)                  # cold writes may still be in flight
    sid2, got = gen(eng, prompts[1])
    assert sid2 == sid
    assert got == want == want_j
    eng.store.close()


def test_oversized_prompt_rejected_without_slot_leak(setup):
    """The prompt-length check runs before the slot pop, for every mode."""
    cfg = setup[0]
    eng = _engine(True, setup, max_seqs=1)
    too_long = np.arange(2, 200, dtype=np.int64) % cfg.vocab_size
    for add in (eng.add_sequence, eng.add_sequence_async,
                eng.begin_admission):
        with pytest.raises(ValueError, match="max_len"):
            add(too_long)
        assert eng.free_slots == 1
    eng.store.close()


@pytest.mark.parametrize("chunk_tokens", [24, 48, 8])
def test_begin_admission_refuses_a_misaligned_chunk(setup, chunk_tokens):
    """The chunk must be a multiple of the store chunk (16) and divide
    max_len (128); a refusal takes no slot."""
    eng = _engine(True, setup, max_seqs=1, prefill_chunk_tokens=chunk_tokens)
    with pytest.raises(ValueError, match="chunk_tokens"):
        eng.begin_admission(setup[4][0])
    assert eng.free_slots == 1
    eng.store.close()


def test_chunked_admission_cancel_frees_the_slot(setup):
    """A cancelled partial admission drains its streamed chunks and
    releases the slot; later steps do nothing."""
    eng = _engine(True, setup, max_seqs=1, prefill_chunk_tokens=16)
    adm = eng.begin_admission(setup[4][2])
    adm.step()
    adm.step()
    assert eng.free_slots == 0 and adm.remaining == 32
    adm.cancel()
    assert eng.free_slots == 1 and adm.step() == 0
    assert not eng.store._host_k and (eng.store.tier[0] == HOST).all()
    eng.store.close()


# ---------------------------------------------------------------------------
# Store: deferred placement and partial ingest
# ---------------------------------------------------------------------------


def _store_pair(tmp_path, **kw):
    (tmp_path / "jax").mkdir()
    js = JStore(1, 4, 16, 2, 8, n_seqs=1, use_pool=True,
                root=str(tmp_path / "jax"), **kw)
    ts = TStore(1, 4, 16, 2, 8, n_seqs=1, use_pool=True,
                root=str(tmp_path / "torch"), device="cpu", **kw)
    return js, ts


@pytest.mark.parametrize("real_codec", [False, True])
def test_deferred_placement_folds_unbilled(tmp_path, rng, real_codec):
    """Ingest with ``pool_place=False`` defers device placements; the next
    pooled fetch folds them into its slab update with no H2D billing, as
    ``repro`` does, and kernel B3's slot list (the codec part of the
    delta) never includes a placed slot."""
    k = rng.randn(64, 2, 8).astype(np.float16)
    v = rng.randn(64, 2, 8).astype(np.float16)
    kw = dict(transit_codec="int4", real_codec=real_codec)
    js, ts = _store_pair(tmp_path, **kw)
    scattered = []
    real_scatter = toffload.kv_dequant_scatter

    def spy(data, scale, slab, slots, **kw_):
        scattered.append(list(slots))
        return real_scatter(data, scale, slab, slots, **kw_)

    toffload.kv_dequant_scatter = spy
    try:
        for st in (js, ts):
            st.ingest(0, k, v, {0: DEVICE, 1: DEVICE, 2: HOST, 3: HOST},
                      pool_place=False)
            assert set(st.pools[0].pending_place) == {(0, 0), (0, 1)}
            assert st.tier[0, 0, 0] == HOST
            st.fetch_chunks_pooled(0, {0: [2, 3]}, theta=0.5)
            assert not st.pools[0].pending_place
            assert st.tier[0, 0, 0] == DEVICE
            # a later selection of a folded chunk is a pool hit
            st.fetch_chunks_pooled(0, {0: [0, 1]}, theta=0.5)
    finally:
        toffload.kv_dequant_scatter = real_scatter
    assert dict(ts.log.bytes) == dict(js.log.bytes)
    assert dict(ts.log.ops) == dict(js.log.ops)
    assert ts.log.ops[(HOST, DEVICE, "kv")] == 2     # the selection only
    assert dict(ts.pools[0].slot_of) == dict(js.pools[0].slot_of)
    assert np.array_equal(ts.pools[0].kv.numpy(),
                          np.asarray(js.pools[0].kv))
    assert ts.pool_stats() == js.pool_stats()
    placed = {ts.pools[0].slot_of[(0, c)] for c in (0, 1)}
    if real_codec:
        assert scattered == [[ts.pools[0].slot_of[(0, 2)]]]
    assert not placed & {s for sl in scattered for s in sl}
    js.close()
    ts.close()


def test_deferred_placement_dropped_with_its_sequence(tmp_path, rng):
    """``clear_seq`` (release, abort) drops a sequence's deferred
    placements before any fetch folds them."""
    k = rng.randn(64, 2, 8).astype(np.float16)
    js, ts = _store_pair(tmp_path, transit_codec=None)
    for st in (js, ts):
        st.ingest(0, k, k, {0: DEVICE, 1: DEVICE}, pool_place=False)
        st.clear_seq(0)
        assert not st.pools[0].pending_place
        st.fetch_chunks_pooled(0, {0: [2]})
        assert list(st.pools[0].slot_of) == [(0, 2)]
    js.close()
    ts.close()


def test_partial_ingest_matches_whole(tmp_path, rng):
    """Chunk-aligned partial ingest (``start=``) lands the same replicas,
    abstracts, tiers and billed bytes as one whole-sequence ingest, in
    the port and in ``repro``."""
    k = rng.randn(64, 2, 8).astype(np.float16)
    v = rng.randn(64, 2, 8).astype(np.float16)
    place = {0: DEVICE, 1: HOST, 2: DISK, 3: DISK}
    out = []
    for Store, sub in ((TStore, "t"), (JStore, "j")):
        kw = dict(n_seqs=1, transit_codec="int4", use_pool=True)
        if Store is TStore:
            kw["device"] = "cpu"
        else:
            (tmp_path / f"{sub}w").mkdir()
            (tmp_path / f"{sub}p").mkdir()
        whole = Store(1, 4, 16, 2, 8, root=str(tmp_path / f"{sub}w"), **kw)
        whole.ingest(0, k, v, place)
        part = Store(1, 4, 16, 2, 8, root=str(tmp_path / f"{sub}p"), **kw)
        for start in (0, 32):
            part.ingest(0, k[start:start + 32], v[start:start + 32], place,
                        start=start)
        np.testing.assert_array_equal(np.asarray(whole._disk),
                                      np.asarray(part._disk))
        np.testing.assert_array_equal(whole._abs_km, part._abs_km)
        np.testing.assert_array_equal(whole._abs_kn, part._abs_kn)
        assert list(whole.tier[0, 0]) == list(part.tier[0, 0])
        assert dict(whole.log.bytes) == dict(part.log.bytes)
        assert dict(whole.log.ops) == dict(part.log.ops)
        out.append((np.array(part._disk), dict(part.log.bytes)))
        whole.close()
        part.close()
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


@pytest.mark.parametrize("start", [8, 1, 17])
def test_unaligned_partial_ingest_refused(rng, start):
    st = TStore(1, 4, 16, 2, 8, n_seqs=1, transit_codec=None, use_pool=True,
                device="cpu")
    k = rng.randn(16, 2, 8).astype(np.float16)
    with pytest.raises(ValueError, match="multiple of the store chunk"):
        st.ingest(0, k, k, {}, start=start)
    assert (st.tier == HOST).all() and not st._host_k
    st.close()


# ---------------------------------------------------------------------------
# Contention-aware admission pacing
# ---------------------------------------------------------------------------


def test_admission_pacing_gate_closes_and_reopens():
    """The pacing gate of the scheduler copy: inflated rounds (against the
    idle baseline) close it, cool rounds reopen it, and a closed gate
    blocks chunk advancement while decode is active."""
    b = TBatcher(make_engine=lambda: None,
                 cfg=TSched(pace_admission=True, max_round_inflation=0.3,
                            ewma_alpha=0.5))
    for _ in range(4):
        b._note_round(0.1, admission_active=False)
    assert b._gate_open
    for _ in range(4):
        b._note_round(0.3, admission_active=True)
    assert not b._gate_open

    class _Adm:
        done = False

        def step(self):
            raise AssertionError("gated admission must not advance")

    b._chunked = [(TRequest(0, np.arange(4), max_new=1), _Adm())]
    b.active[9] = (TRequest(9, np.arange(4), max_new=8), 0, 1)
    b._advance_chunked()
    assert b._gated_rounds == 1
    stt = b.stats()
    assert stt["admission_gate_open"] == 0.0
    assert stt["gated_rounds"] == 1.0
    assert stt["round_ewma_s"] > stt["idle_round_ewma_s"]
    for _ in range(8):
        b._note_round(0.1, admission_active=False)
    assert b._gate_open


def test_pacing_gate_open_allows_chunked_progress(setup):
    """With ample inflation headroom the gate stays open end to end and
    the port's chunked admission completes, with ``repro``'s streams."""
    cfg = setup[0]
    outs = {}
    for port in (True, False):
        eng = _engine(port, setup, max_seqs=3, prefill_chunk_tokens=32)
        Batcher, Request, Sched = (TBatcher, TRequest, TSched) if port \
            else (JBatcher, JRequest, JSched)
        b = Batcher(engine=eng, cfg=Sched(
            max_active=2, chunk=16, chunked_admission=True,
            prefill_round_tokens=32, pace_admission=True,
            max_round_inflation=1e6))
        rng = np.random.RandomState(0)
        for i in range(3):
            b.submit(Request(i, rng.randint(2, cfg.vocab_size, 48),
                             max_new=3))
        done = b.run()
        assert len(done) == 3
        assert b.stats()["admission_gate_open"] == 1.0
        outs[port] = {r.rid: r.out for r in done}
        eng.store.close()
    assert outs[True] == outs[False]


@pytest.mark.parametrize("chunk_s,n,round_s,k", [
    (0.1, 8, 0.2, 2), (0.1, 8, 0.2, 8), (0.03, 5, 0.5, 3), (1.0, 1, 0.1, 4)])
def test_chunked_admission_model_bounds_round_gap(chunk_s, n, round_s, k):
    """The copied analytic model: a chunked admission's round gap is one
    round plus at most ``k`` chunks, its TTFT pays the interleaved rounds,
    and it equals the reference's."""
    m = chunked_admission_model(chunk_s, n, round_s, k)
    assert m == j_model(chunk_s, n, round_s, k)
    assert m["max_round_gap_chunked_s"] == pytest.approx(
        round_s + min(n, k) * chunk_s)
    assert m["max_round_gap_whole_s"] == pytest.approx(round_s + n * chunk_s)
    assert m["ttft_chunked_s"] == pytest.approx(
        n * chunk_s + (-(-n // k) - 1) * round_s)
    assert m["max_round_gap_chunked_s"] <= m["max_round_gap_whole_s"]
