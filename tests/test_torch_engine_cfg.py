"""The engine's configuration leftovers against ``repro``'s, on the
longchat smoke config (chunk 16, ``max_len`` 128) of
``tests/test_pipelined_admission.py`` and ``tests/test_chunked_prefill.py``:

- ``EngineCfg`` has every field of the reference's, with its default,
  except ``jit_prefill`` (eager PyTorch compiles no prefill program);
- ``overlap_ingest=False``, the serial ingest: in each admission mode the
  token streams of write-behind ingest, and against the reference's serial
  run the same streams, per-tier ``TrafficLog`` and ``overlapped`` flags;
- ``prefill_buckets``: ``_bucket_len`` for every prompt length, and the
  token streams with a schedule; a bucket that the 1024-key attention
  blocks do not divide (1536) takes a shorter last block;
- ``prefill_programs``: the reference's count of compiled prefill programs,
  over ``test_chunked_prefill.py``'s 16 prompt lengths;
- ``profile``: the reference's ``round_profiles`` keys and the port's
  round parts, the measured ``attend_s`` inside the rest of the round, and
  the streams and traffic of a run without it;
- the single-sequence ``LeoAMEngine``'s passthroughs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serving.engine import BatchedLeoAMEngine as JEngine
from repro.serving.engine import EngineCfg as JCfg
from repro.serving.engine import LeoAMEngine as JSingle
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import BatchedLeoAMEngine as TEngine
from repro_torch.serving.engine import EngineCfg as TCfg
from repro_torch.serving.engine import LeoAMEngine as TSingle
from repro_torch.serving.engine import ROUND_KEYS

MAX_LEN, LENS, ROUNDS = 128, (48, 57), 4
# test_chunked_prefill.py:100's 16 distinct prompt lengths
MIXED_LENGTHS = tuple(range(17, 113, 6))
# an explicit schedule whose last bucket lies past max_len (capped)
SCHEDULE = (24, 50, 100, 256)


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


def _engine(port, setup, max_seqs=len(LENS), **kw):
    cfg, tcfg, params, tparams, _ = setup
    if port:
        return TEngine(tcfg, tparams,
                       TCfg(max_len=MAX_LEN, selection="tree", **kw),
                       max_seqs=max_seqs, device="cpu")
    return JEngine(cfg, params, JCfg(max_len=MAX_LEN, selection="tree", **kw),
                   max_seqs=max_seqs)


def _admit(eng, p, mode):
    if mode == "sync":
        return eng.add_sequence(p)
    if mode == "async":
        return eng.add_sequence_async(p).result(timeout=300)
    return eng.begin_admission(p).drain()


def _serve(port, setup, mode="sync", rounds=ROUNDS, **kw):
    """Admit the prompts in ``mode``, decode ``rounds`` rounds; returns the
    streams, the TrafficLog, the profiles and the engine's program count."""
    eng = _engine(port, setup, prefill_chunk_tokens=32, **kw)
    toks = {}
    for p in setup[4]:
        sid, tok = _admit(eng, p, mode)
        toks[sid] = tok
    out = {sid: [t] for sid, t in toks.items()}
    for _ in range(rounds):
        toks = eng.decode_round(toks)
        for sid, t in toks.items():
            out[sid].append(t)
    st = eng.store
    st.ingest_fence_all()
    st.requant_fence()
    res = dict(streams=[out[s] for s in sorted(out)],
               bytes=dict(st.log.bytes), ops=dict(st.log.ops),
               admit=[dict(p) for p in eng.admit_profiles],
               rounds=[dict(p) for p in eng.round_profiles],
               programs=eng.prefill_programs)
    st.close()
    return res


_RUNS = {}


def _run(port, setup, mode="sync", **kw):
    key = (port, mode, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _serve(port, setup, mode, **kw)
    return _RUNS[key]


# ---------------------------------------------------------------------------
# EngineCfg
# ---------------------------------------------------------------------------


def test_engine_cfg_has_every_reference_field_but_jit_prefill():
    ref = {f.name: f.default for f in dataclasses.fields(JCfg)}
    port = {f.name: f.default for f in dataclasses.fields(TCfg)}
    assert set(ref) - set(port) == {"jit_prefill"}
    assert set(port) <= set(ref)
    assert {k: port[k] for k in port} == {k: ref[k] for k in port}


# ---------------------------------------------------------------------------
# overlap_ingest=False: serial ingest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "async", "chunked"])
def test_serial_ingest_matches_write_behind_and_reference(setup, mode):
    """Serial ingest gives write-behind ingest's streams and traffic in the
    port, and the reference's serial streams, TrafficLog and profiles."""
    serial = _run(True, setup, mode, overlap_ingest=False)
    behind = _run(True, setup, mode, overlap_ingest=True)
    ref = _run(False, setup, mode, overlap_ingest=False)
    assert serial["streams"] == behind["streams"]
    assert serial["bytes"] == behind["bytes"]
    assert serial["ops"] == behind["ops"]
    assert serial["streams"] == ref["streams"]
    assert serial["bytes"] == ref["bytes"] and serial["ops"] == ref["ops"]
    for got, want in zip(serial["admit"], ref["admit"]):
        assert set(got) == set(want)
        assert got["overlapped"] == want["overlapped"] == 0.0
    assert all(p["overlapped"] == 1.0 for p in behind["admit"])
    assert len(serial["admit"]) == len(ref["admit"]) == len(LENS)


# ---------------------------------------------------------------------------
# prefill_buckets and prefill_programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", [None, SCHEDULE])
def test_bucket_len_matches_reference_at_every_length(setup, schedule):
    port = _engine(True, setup, prefill_buckets=schedule)
    ref = _engine(False, setup, prefill_buckets=schedule)
    try:
        got = [port._bucket_len(S) for S in range(1, MAX_LEN + 1)]
        want = [ref._bucket_len(S) for S in range(1, MAX_LEN + 1)]
        assert got == want
        assert max(got) == MAX_LEN
    finally:
        port.store.close()
        ref.store.close()


def test_bucket_schedule_streams_match_reference(setup):
    """Prompts of 48 and 57 tokens prefilled in buckets 50 and 100: the
    reference's streams and traffic, and the power-of-two buckets'
    streams (padding is causally invisible)."""
    got = _run(True, setup, prefill_buckets=SCHEDULE)
    want = _run(False, setup, prefill_buckets=SCHEDULE)
    assert got["streams"] == want["streams"]
    assert got["bytes"] == want["bytes"] and got["ops"] == want["ops"]
    assert got["streams"] == _run(True, setup)["streams"]
    assert got["programs"] == want["programs"] == 2


@pytest.mark.parametrize("window", [None, 20])
def test_ragged_kv_block_matches_reference(window):
    """A bucket such as 1536 under 1024-key blocks (ROADMAP C18): the
    port's blocked attention over 48 keys in blocks of 32 (the last one
    16) gives the reference's over blocks of 16, which divide the keys."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.RandomState(5)
    q = rng.randn(2, 48, 4, 16).astype(np.float32)
    k = rng.randn(2, 48, 2, 16).astype(np.float32)
    v = rng.randn(2, 48, 2, 16).astype(np.float32)
    want = jattn.blocked_attention(q, k, v, window=window, block_kv=16)
    got = tattn.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bucket", [True, False])
def test_prefill_programs_match_reference(setup, bucket):
    """16 prompt lengths admitted whole, then three admitted chunked: the
    reference's program count after each phase, first tokens equal."""
    cfg = setup[0]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(2, cfg.vocab_size, L) for L in MIXED_LENGTHS]
    counts = {}
    for port in (True, False):
        eng = _engine(port, setup, max_seqs=1, bucket_prefill=bucket,
                      prefill_chunk_tokens=32)
        firsts, seen = [], []
        for p in prompts:
            sid, tok = eng.add_sequence(p)
            eng.release(sid)
            firsts.append(tok)
        seen.append(eng.prefill_programs)
        for p in prompts[:3]:
            sid, tok = eng.begin_admission(p).drain()
            eng.release(sid)
            firsts.append(tok)
        seen.append(eng.prefill_programs)
        eng.store.close()
        counts[port] = (firsts, seen)
    assert counts[True] == counts[False]
    whole, total = counts[True][1]
    assert total == whole + 1                 # one chunk-step size
    if bucket:
        # 32, 64 and 128: the powers of two the 16 lengths fall into
        assert whole == 3
    else:
        assert whole == len(MIXED_LENGTHS)


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pooled", [True, False])
def test_profile_times_attend_and_changes_nothing_else(setup, pooled):
    prof = _run(True, setup, pooled=pooled, profile=True)
    plain = _run(True, setup, pooled=pooled, profile=False)
    ref = _run(False, setup, pooled=pooled, profile=True)
    # the port's rounds keep every key of the reference's and add the
    # round's parts (engine.ROUND_KEYS)
    assert [sorted(p) for p in prof["rounds"]] == \
        [sorted(ROUND_KEYS) for _ in ref["rounds"]]
    assert [sorted(p) for p in plain["rounds"]] == \
        [sorted(ROUND_KEYS) for _ in ref["rounds"]]
    assert all(set(p) <= set(ROUND_KEYS) for p in ref["rounds"])
    for p in prof["rounds"]:
        rest = p["total_s"] - p["eval_s"] - p["gather_s"] - p["upload_s"]
        assert 0.0 < p["attend_s"] <= rest
    # real_codec=False: θ is 1 whatever attend_s reads, so the profile
    # moves no byte and no token
    assert prof["streams"] == plain["streams"] == ref["streams"]
    assert prof["bytes"] == plain["bytes"] == ref["bytes"]
    assert prof["ops"] == plain["ops"] == ref["ops"]


# ---------------------------------------------------------------------------
# LeoAMEngine
# ---------------------------------------------------------------------------


def test_single_sequence_passthroughs_match_reference(setup):
    cfg, tcfg, params, tparams, prompts = setup
    ecfg = dict(max_len=MAX_LEN, selection="tree")
    port = TSingle(tcfg, tparams, TCfg(**ecfg), device="cpu")
    ref = JSingle(cfg, params, JCfg(**ecfg))
    try:
        assert port.generate(prompts[0], ROUNDS + 1) == \
            ref.generate(prompts[0], ROUNDS + 1)
        assert port.cfg is port._engine.cfg and port.ecfg is port._engine.ecfg
        assert port.cfg.name == ref.cfg.name
        assert port.ecfg.max_len == ref.ecfg.max_len
        assert (port.chunk, port.n_chunks) == (ref.chunk, ref.n_chunks)
        assert port.attn_layers == ref.attn_layers
        assert port.length == ref.length == len(prompts[0]) + ROUNDS
        np.testing.assert_array_equal(port.access.counts, ref.access.counts)
        assert len(port.round_profiles) == len(ref.round_profiles) == ROUNDS
        assert len(port.admit_profiles) == len(ref.admit_profiles) == 1
        assert [sorted(p) for p in port.admit_profiles] == \
            [sorted(p) for p in ref.admit_profiles]
        assert len(port.stats) == len(ref.stats) == ROUNDS
    finally:
        port.store.close()
        ref.store.close()
