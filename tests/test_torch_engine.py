"""The port's serving engine against ``repro.serving.engine``: 3 ragged
prompts (48, 64, 57), 6 new tokens, identical greedy token streams and an
identical TrafficLog (bytes and ops) — for the default EngineCfg and for
the real transit codec with and without the prefetch pipeline, directly
and through both packages' ContinuousBatcher.  θ comes from wall-clock
costs, so it is pinned on both engines."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serving.engine import BatchedLeoAMEngine as JEngine
from repro.serving.engine import EngineCfg as JCfg
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerCfg as JSched
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import BatchedLeoAMEngine as TEngine
from repro_torch.serving.engine import EngineCfg as TCfg
from repro_torch.serving.engine import LeoAMEngine as TSingle
from repro_torch.serving.scheduler import ContinuousBatcher as TBatcher
from repro_torch.serving.scheduler import Request as TRequest
from repro_torch.serving.scheduler import SchedulerCfg as TSched

LENS, N_NEW, THETA = (48, 64, 57), 6, 0.5


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


def _engine(port: bool, setup, **kw):
    cfg, tcfg, params, tparams, _ = setup
    if port:
        eng = TEngine(tcfg, tparams, TCfg(max_len=128, selection="tree", **kw),
                      max_seqs=len(LENS), device="cpu")
    else:
        eng = JEngine(cfg, params, JCfg(max_len=128, selection="tree", **kw),
                      max_seqs=len(LENS))
    eng._theta = lambda li: THETA
    return eng


@pytest.mark.parametrize("length,budget,chunk", [(57, 23, 16), (64, 26, 16),
                                                 (300, 40, 8), (5, 64, 16)])
def test_selection_copy_matches_reference(length, budget, chunk):
    """The copied numpy selection: chunk-level fast paths equal to the
    reference's and to the per-token forms they stand in for."""
    from repro.core import adaptive as ja
    from repro_torch.core import adaptive as ta
    rng = np.random.RandomState(length)
    nc = -(-length // chunk)
    ub = rng.randn(nc).astype(np.float32)
    ub[-1] = ub[0]                                  # a tie, broken by lo
    for name in ("tree_select_chunks", "flat_select_chunks"):
        assert getattr(ta, name)(ub, length, budget, chunk) == \
            getattr(ja, name)(ub, length, budget, chunk)
    tok = np.repeat(ub, chunk)[:length]
    sel, evals = ta.tree_select_chunks(ub, length, budget, chunk)
    res = ta.tree_select(tok, budget, chunk)
    assert sel == sorted({int(t) // chunk for t in res.selected})
    assert evals == res.evaluations
    ref = ja.tree_select(tok, budget, chunk)
    assert np.array_equal(res.selected, ref.selected)
    assert res.partition == ref.partition
    flat = ta.flat_chunk_select(tok, budget, chunk)
    assert np.array_equal(flat.selected,
                          ja.flat_chunk_select(tok, budget, chunk).selected)


def _log(store):
    return dict(store.log.bytes), dict(store.log.ops)


def _run_direct(port, setup, **kw):
    eng = _engine(port, setup, **kw)
    toks, streams = {}, {}
    for p in setup[4]:
        sid, tok = eng.add_sequence(p)
        toks[sid], streams[sid] = tok, [tok]
    for _ in range(N_NEW - 1):
        toks = eng.decode_round(toks)
        for sid, tok in toks.items():
            streams[sid].append(tok)
    out = ([streams[s] for s in sorted(streams)], _log(eng.store),
           eng.store.pool_stats())
    eng.store.close()
    return out


@pytest.mark.parametrize("kw", [
    {}, {"real_codec": True, "pipeline": True},
    {"real_codec": True, "pipeline": False}], ids=["default", "codec-pipe",
                                                    "codec-serial"])
def test_engine_matches_reference(setup, kw):
    streams_j, log_j, pool_j = _run_direct(False, setup, **kw)
    streams_t, log_t, pool_t = _run_direct(True, setup, **kw)
    assert streams_t == streams_j
    assert log_t == log_j
    assert pool_t == pool_j


def _run_batcher(port, setup, **kw):
    eng = _engine(port, setup, **kw)
    Batcher, Request, Sched = (TBatcher, TRequest, TSched) if port else \
        (JBatcher, JRequest, JSched)
    b = Batcher(engine=eng, cfg=Sched(max_active=3, chunk=16))
    for i, p in enumerate(setup[4]):
        b.submit(Request(rid=i, prompt=p, max_new=N_NEW))
    done = sorted(b.run(), key=lambda r: r.rid)
    out = ([r.out for r in done], [r.error for r in done], _log(eng.store))
    eng.store.close()
    return out


def test_batcher_matches_reference(setup):
    out_j = _run_batcher(False, setup, real_codec=True)
    out_t = _run_batcher(True, setup, real_codec=True)
    assert out_t == out_j
    assert all(len(s) == N_NEW for s in out_t[0])


def test_codec_uploads_run_the_dequant_path(setup):
    """θ = 0.5 sends half of every upload packed through kv_dequant's
    plain version (no launch counted on the CPU)."""
    from repro_torch.kernels.kv_quant import ops as kq
    eng = _engine(True, setup, real_codec=True)
    before = kq.launches
    toks = {}
    for p in setup[4]:
        sid, tok = eng.add_sequence(p)
        toks[sid] = tok
    eng.decode_round(toks)
    assert eng.store.codec_uploads > 0 and eng.store.plain_uploads > 0
    assert kq.launches == before
    eng.store.close()


def test_single_sequence_wrapper_and_release(setup):
    cfg, tcfg, _, tparams, prompts = setup
    eng = TSingle(tcfg, tparams, TCfg(max_len=128), device="cpu")
    out = eng.generate(prompts[0], 4)
    assert len(out) == 4 and all(0 <= t < tcfg.vocab_size for t in out)
    assert eng.length == LENS[0] + 3
    assert len(eng.store.retired_logs) == 0
    eng.prefill(prompts[1])                      # re-prefill releases
    assert len(eng.store.retired_logs) == 1
    eng.store.close()


@pytest.mark.parametrize("opt", [
    {"prefix_cache": True, "config": "deepseek-v2-lite-16b"},
    {"debug_sync": True}])
def test_unported_engine_options_raise(setup, opt):
    """Options the port once refused, each now held to the reference: the
    shared-prefix cache on an MLA model (A7b; deepseek-v2-lite's smoke
    config with its own weights, three prompts of one 32-token head, the
    later two adopting it) and the sync sanitizer (A13a).  Token streams,
    TrafficLogs and pool stats equal ``repro``'s engine with the same
    option."""
    opt = dict(opt)
    if "config" in opt:
        arch = opt.pop("config")
        cfg, tcfg = (get(arch, smoke=True)
                     for get in (get_config, t_get_config))
        cfg, tcfg = (dataclasses.replace(c, leoam=dataclasses.replace(
            c.leoam, chunk_size=16, min_seq_for_sparse=32))
            for c in (cfg, tcfg))
        params = jlm.init(cfg, jax.random.PRNGKey(3))
        tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
        rng = np.random.RandomState(4)
        head = rng.randint(2, cfg.vocab_size, 32)
        prompts = [np.concatenate([head, rng.randint(2, cfg.vocab_size, n)])
                   for n in (20, 9, 30)]
        setup = (cfg, tcfg, params, tparams, prompts)
        opt.update(prefill_chunk_tokens=32, prefix_arena_rows=2)
    outs = [_run_direct(port, setup, **opt) for port in (False, True)]
    assert outs[1] == outs[0]
    if "prefix_cache" in opt:
        assert ("host", "disk", "prefix_ref") in outs[1][1][1]


@pytest.mark.parametrize("kw", [{}, {"real_codec": True},
                                {"pooled": False, "pipeline": False}],
                         ids=["default", "codec", "legacy"])
def test_moe_gqa_engine_matches_reference(kw):
    """moonshot-v1-16b-a3b (GQA with no-drop MoE; smoke: 4 experts top-2)
    through the engine: token streams, TrafficLogs and pool stats equal to
    ``repro``'s, pooled (with and without the real codec) and legacy."""
    cfg, tcfg = (dataclasses.replace(c, leoam=dataclasses.replace(
        c.leoam, chunk_size=16, importance_rate=0.4, early_rate=0.6,
        min_seq_for_sparse=32))
        for c in (get("moonshot-v1-16b-a3b", smoke=True)
                  for get in (get_config, t_get_config)))
    params = jlm.init(cfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    prompts = [np.random.RandomState(6).randint(2, cfg.vocab_size, n)
               for n in LENS]
    setup = (cfg, tcfg, params, tparams, prompts)
    outs = [_run_direct(port, setup, **kw) for port in (False, True)]
    assert outs[1] == outs[0]


def test_params_on_another_device_are_refused(setup):
    _, tcfg, _, tparams, _ = setup
    meta = {**tparams, "embed": torch.empty(tparams["embed"].shape,
                                            device="meta")}
    with pytest.raises(ValueError, match="device"):
        TEngine(tcfg, meta, TCfg(max_len=128), device="cpu")
