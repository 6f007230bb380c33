"""The port's serving engine on the A11 families against
``repro.serving.engine``: jamba's hybrid stack (Mamba layers beside an
attention layer, MoE) and qwen2-vl (M-RoPE), at their smoke sizes with
the same weights, 2 ragged prompts (48, 57), ``max_len`` 128, θ pinned.
Identical greedy token streams and TrafficLogs (bytes and ops) are
required.

- jamba at 8 layers (every layer in the prologue): synchronous,
  overlapped and chunked admission, suspend/resume, and the
  recompute-from-prompt recovery of a lost replica chunk.
- jamba at 16 layers (prologue 8, one body repeat): the reference engine
  cannot serve it (its body-state update writes into a read-only array,
  ROADMAP C13), so the port is held against the reference run with
  ``prologue_layers=16`` — the same layers and weights, every one through
  the reference's working prologue branch (the parameters restacked
  between the two layouts; no LeoAM budget depends on the layout here:
  both attention layers, 3 and 11, are past ``early_layers=4``).
- qwen2-vl: the reference's round passes its (B, 1) positions to M-RoPE
  as the three streams — the t/h/w sections then take the lengths of
  batch rows 0, 1 and 2 (out of range: INT_MIN) for every row (ROADMAP
  C15).  The port rotates with the token's position in all three
  streams, as the reference's own ``gqa_decode`` does, so it is held
  against the reference with that position handed to ``_qkv``.
- refusals: seamless raises the reference's ``ValueError``; xlstm, with
  no attention layer, the port's (the reference fails in its store,
  ROADMAP C14).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serving.engine import BatchedLeoAMEngine as JEngine
from repro.serving.engine import EngineCfg as JCfg
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import lm as tlm
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import BatchedLeoAMEngine as TEngine
from repro_torch.serving.engine import EngineCfg as TCfg
from repro_torch.serving.offload import DISK

LENS, THETA, MAX_LEN, ROUNDS = (48, 57), 0.5, 128, 4

_SETUP = {}


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch, smoke=True), **kw),
            dataclasses.replace(t_get_config(arch, smoke=True), **kw))


def _setup(name):
    if name not in _SETUP:
        arch, kw = {"jamba8": ("jamba-1.5-large-398b", {"n_layers": 8}),
                    "qwen": ("qwen2-vl-2b", {})}[name]
        cfg, tcfg = _cfgs(arch, **kw)
        params = jlm.init(cfg, jax.random.PRNGKey(1))
        tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
        prompts = [np.random.RandomState(0).randint(2, cfg.vocab_size, n)
                   for n in LENS]
        _SETUP[name] = (cfg, tcfg, params, tparams, prompts)
    return _SETUP[name]


def _engine(port, cfg, params, **kw):
    if port:
        eng = TEngine(cfg, params, TCfg(max_len=MAX_LEN, **kw),
                      max_seqs=len(LENS), device="cpu")
    else:
        eng = JEngine(cfg, params, JCfg(max_len=MAX_LEN, **kw),
                      max_seqs=len(LENS))
    eng._theta = lambda li: THETA
    return eng


def _admit(eng, p, mode):
    if mode == "sync":
        return eng.add_sequence(p)
    if mode == "async":
        return eng.add_sequence_async(p).result()
    return eng.begin_admission(p).drain()


def _serve(eng, prompts, mode="sync", script=None):
    """Admit the prompts in ``mode``, then ``ROUNDS`` rounds; ``script``
    (round -> fn(eng, sids) returning the live sids) may change the
    batch.  Returns (streams, TrafficLog bytes, ops, fault counters)."""
    toks, streams = {}, {}
    for p in prompts:
        sid, tok = _admit(eng, p, mode)
        toks[sid], streams[sid] = tok, [tok]
    live = sorted(toks)
    for rnd in range(ROUNDS):
        if script and rnd in script:
            live = script[rnd](eng, sorted(toks))
        got = eng.decode_round({s: toks[s] for s in live})
        for s, t in got.items():
            toks[s] = t
            streams[s].append(t)
    out = ([streams[s] for s in sorted(streams)], dict(eng.store.log.bytes),
           dict(eng.store.log.ops), eng.fault_stats())
    eng.store.close()
    return out


def _same(t, j):
    """Streams, TrafficLog and the port's fault counters equal."""
    assert t[0] == j[0]
    assert t[1] == j[1] and t[2] == j[2]
    assert {k: j[3][k] for k in t[3]} == t[3]


def _both(name, mode="sync", script=None, **kw):
    cfg, tcfg, params, tparams, prompts = _setup(name)
    if mode == "chunked":
        kw["prefill_chunk_tokens"] = 32
    j = _serve(_engine(False, cfg, params, **kw), prompts, mode, script)
    t = _serve(_engine(True, tcfg, tparams, **kw), prompts, mode, script)
    return t, j


@pytest.mark.parametrize("mode", ["sync", "async", "chunked"])
def test_jamba_engine_matches_reference(mode):
    _same(*_both("jamba8", mode, real_codec=True))


def test_jamba_admission_modes_carry_one_state():
    """The recurrent state each admission mode leaves in ``_SeqState``
    (Mamba conv window and SSM state, attention layers None) is the state
    of ``lm.prefill`` over the prompt: within 1e-4, as the engine's
    bucketed prefill and chunked steps round otherwise than one exact
    prefill (the port against itself: 1.3e-5 measured)."""
    _, tcfg, _, tparams, prompts = _setup("jamba8")
    with torch.no_grad():
        _, cache = tlm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(
            prompts[1][None])}, max_len=MAX_LEN)
    for mode in ("sync", "async", "chunked"):
        eng = _engine(True, tcfg, tparams,
                      **({"prefill_chunk_tokens": 32}
                         if mode == "chunked" else {}))
        sid, _ = _admit(eng, prompts[1], mode)
        st = eng.seqs[sid].state
        kinds = tcfg.layer_kinds()
        for i, leaves in enumerate(st["prologue"]):
            assert (leaves is None) == kinds[i].startswith("attn")
            for name, t in (leaves or {}).items():
                torch.testing.assert_close(t, cache["prologue"][i][name],
                                           rtol=1e-4, atol=1e-4)
        eng.store.close()


def _suspend_script(port_states=None):
    def suspend(eng, sids):
        if port_states is not None:
            port_states.append([t.clone() for t in _state_leaves(
                eng.seqs[sids[1]].state)])
        eng.suspend_sequence(sids[1])
        return sids[:1]

    def resume(eng, sids):
        eng.resume_sequence(sids[1])
        if port_states is not None:
            port_states.append([t.clone() for t in _state_leaves(
                eng.seqs[sids[1]].state)])
        return sids
    return {1: suspend, 3: resume}


def _state_leaves(state):
    for part in ("prologue", "body"):
        for leaves in state[part]:
            for name in sorted(leaves or {}):
                yield leaves[name]


def test_jamba_suspend_resume_matches_reference():
    """Sequence 1 suspended for rounds 1-2 and resumed: streams and logs
    equal the reference's, and its recurrent state comes back bitwise."""
    cfg, tcfg, params, tparams, prompts = _setup("jamba8")
    j = _serve(_engine(False, cfg, params), prompts, "sync",
               _suspend_script())
    states = []
    t = _serve(_engine(True, tcfg, tparams), prompts, "sync",
               _suspend_script(states))
    _same(t, j)
    assert len(states[0]) == len(states[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*states))


def test_jamba_replica_loss_recovery_matches_reference():
    """A prompt-span replica chunk of sequence 0 lost before round 1: both
    engines recompute it from the prompt (the chunked-prefill replay runs
    the Mamba layers too) and go on with equal streams, counters and
    logs; the recurrent state is the sequence's own, untouched."""
    def corrupt(eng, sids):
        st = eng.store
        for li in range(len(eng.attn_layers)):
            st._disk[sids[0], li, 0, 0].reshape(-1)[0] += np.float16(1.0)
            st._host_k.pop((sids[0], li, 0), None)
            st._host_v.pop((sids[0], li, 0), None)
            st.tier[sids[0], li, 0] = DISK
            pool = st.pools[li]
            slot = pool.slot_of.pop((sids[0], 0), None)
            if slot is not None:
                pool.free.append(slot)
        return sids

    cfg, tcfg, params, tparams, prompts = _setup("jamba8")
    kw = dict(pipeline=False, prefill_chunk_tokens=32)
    j = _serve(_engine(False, cfg, params, **kw), prompts, "sync",
               {1: corrupt})
    t = _serve(_engine(True, tcfg, tparams, **kw), prompts, "sync",
               {1: corrupt})
    assert t[3]["chunks_recomputed"] >= 1
    _same(t, j)


def _restack(params16, pro_n, period):
    """A prologue-only (16-layer) parameter tree as a prologue of
    ``pro_n`` layers and a body of one repeat per ``period`` position."""
    rest = params16["prologue"][pro_n:]
    body = [jax.tree.map(lambda *a: jnp.stack(a), *rest[pi::period])
            for pi in range(period)]
    return {**params16, "prologue": params16["prologue"][:pro_n],
            "body": body}


def test_jamba_body_repeats_match_prologue_reference():
    arch = "jamba-1.5-large-398b"
    jcfg, _ = _cfgs(arch, prologue_layers=16)
    _, tcfg = _cfgs(arch)
    assert tcfg.n_layers == 16 and tlm._layer_plan(tcfg)[2] == 1
    assert jlm._layer_plan(jcfg)[2] == 0
    params = jlm.init(jcfg, jax.random.PRNGKey(2))
    pro_n, period = tcfg.prologue(), tcfg.period()
    tparams = params_from_jax(jax.tree.map(
        np.asarray, _restack(params, pro_n, period)), "cpu")
    prompts = [np.random.RandomState(3).randint(2, jcfg.vocab_size, n)
               for n in LENS]
    j = _serve(_engine(False, jcfg, params, real_codec=True), prompts)
    t = _serve(_engine(True, tcfg, tparams, real_codec=True), prompts)
    _same(t, j)


@pytest.fixture
def mrope_positions_in_reference_round(monkeypatch):
    """The reference's round with the token's position in all three
    M-RoPE streams (ROADMAP C15), as its ``gqa_decode`` passes it."""
    from repro.models import attention as jattn
    own = jattn._qkv

    def qkv(p, cfg, x, pos):
        if cfg.rope == "mrope" and jnp.ndim(pos) == 2:
            pos = jnp.broadcast_to(pos[None], (3,) + tuple(jnp.shape(pos)))
        return own(p, cfg, x, pos)

    monkeypatch.setattr(jattn, "_qkv", qkv)


@pytest.mark.usefixtures("mrope_positions_in_reference_round")
def test_qwen2_vl_engine_matches_reference():
    _same(*_both("qwen", "sync", real_codec=True))


def test_unservable_stacks_refused():
    cfg, tcfg = _cfgs("seamless-m4t-large-v2")
    with pytest.raises(ValueError) as je:
        JEngine(cfg, None, JCfg(max_len=MAX_LEN))
    with pytest.raises(ValueError) as te:
        TEngine(tcfg, None, TCfg(max_len=MAX_LEN), device="cpu")
    assert str(te.value) == str(je.value)
    _, xcfg = _cfgs("xlstm-125m")
    with pytest.raises(ValueError, match="no attention layer"):
        TEngine(xcfg, None, TCfg(max_len=MAX_LEN), device="cpu")
