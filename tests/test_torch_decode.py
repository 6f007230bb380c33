"""The port's ``lm.decode_step`` (the in-model LeoAM sparse decode) against
``repro.models.lm.decode_step`` on the seven attention-only configs without
M-RoPE, at their smoke sizes, with the same weights (a JAX ``lm.init`` tree
carried across with ``params_from_jax``) and the same numpy prompts.

What must hold (f32 smoke configs; the two frameworks sum in different
orders):

- prefill's decode cache, its abstract pyramid leaves included, within
  1e-5 of the reference's (the sentinel ∓1e30 rows past the length equal);
- every decode step's logits within 1e-4, the pyramid leaves after it
  within 1e-5, the chunk ids each sparse layer selects equal, and 6-step
  greedy token streams equal;
- dense decode (``min_seq_for_sparse`` out of reach) gives full prefill's
  logits (the reference's own bar: rtol 2e-2, atol 2e-4);
- a full-budget flat-selection engine's stream equals ``decode_step``'s
  (the port of ``tests/test_serving.py``'s full-budget test).

The chunk ids of the reference's body layers are read inside its layer
scan with ``jax.debug.callback``; the port's are recorded by wrapping its
selection function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adaptive as jadaptive
from repro.core import sparse_attention as jsa
from repro.models import lm as jlm
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import sparse_attention as tsa
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import EngineCfg, LeoAMEngine

ARCHS = ["deepseek-v2-lite-16b", "gemma2-2b", "longchat-7b-32k",
         "moonshot-v1-16b-a3b", "nemotron-4-340b", "phi4-mini-3.8b",
         "qwen3-1.7b"]
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
B, MAX_LEN, STEPS = 2, 64, 6

_SETUP = {}


def _setup(arch):
    if arch not in _SETUP:
        cfg = get_config(arch, smoke=True)
        tcfg = t_get_config(arch, smoke=True)
        params = jlm.init(cfg, jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
        _SETUP[arch] = (cfg, tcfg, params, tparams)
    return _SETUP[arch]


def _leaves(cache):
    """(part, index, name) -> numpy leaf, over a cache of either
    package."""
    out = {}
    for part in ("prologue", "body"):
        for i, d in enumerate(cache[part]):
            for name, leaf in d.items():
                out[(part, i, name)] = np.asarray(
                    leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf)
    return out


def _cache_close(tc, jc):
    t, j = _leaves(tc), _leaves(jc)
    assert t.keys() == j.keys()
    for key in j:
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_allclose(t[key], j[key], rtol=CACHE_TOL,
                                   atol=CACHE_TOL, err_msg=str(key))


class _Ids:
    """Records the chunk ids every sparse layer selects, in both packages:
    the port's selection functions are wrapped in place, the reference's
    report through ``jax.debug.callback`` (its body layers run in a
    scan)."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        for mod, name in ((tsa, "pyramid_select_gqa"),
                          (tsa, "flat_select_gqa"),
                          (tattn, "pyramid_select_mla")):
            monkeypatch.setattr(mod, name, self._port(getattr(mod, name)))
        for mod, name in ((jsa, "pyramid_select_gqa"),
                          (jsa, "flat_select_gqa"),
                          (jadaptive, "pyramid_select_mla")):
            monkeypatch.setattr(mod, name, self._ref(getattr(mod, name)))

    def _port(self, fn):
        def spy(*a, **kw):
            ids = fn(*a, **kw)
            self.port.append(ids.numpy().copy())
            return ids
        return spy

    def _ref(self, fn):
        def spy(*a, **kw):
            ids = fn(*a, **kw)
            jax.debug.callback(lambda x: self.ref.append(np.asarray(x)), ids,
                               ordered=True)
            return ids
        return spy

    def take(self):
        jax.effects_barrier()
        out = (self.port, self.ref)
        self.port, self.ref = [], []
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_sparse_decode_matches_reference(arch, monkeypatch):
    """Prefill 56 tokens into a 64-token cache (sparse: the smoke
    configs' ``min_seq_for_sparse`` is 32), then 6 greedy decode steps in
    both packages: caches, logits, selected ids and streams agree."""
    cfg, tcfg, params, tparams = _setup(arch)
    spy = _Ids(monkeypatch)
    S0 = MAX_LEN - 8
    prompt = np.random.RandomState(1).randint(2, cfg.vocab_size, (B, S0))
    jl, jc = jlm.prefill(params, cfg,
                         {"tokens": jnp.asarray(prompt, jnp.int32)},
                         max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tlm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(
            prompt)}, max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _cache_close(tc, jc)
    assert any(name.startswith(("kmax", "cmax"))
               for (_, _, name) in _leaves(tc))
    jtok = ttok = np.asarray(jl).argmax(-1)
    jstream, tstream = [jtok], [ttok]
    jdecode = jax.jit(lambda p, c, t, n: jlm.decode_step(
        p, cfg, c, {"token": t}, n))
    for step in range(STEPS):
        length = S0 + step
        jl, jc = jdecode(params, jc, jnp.asarray(jtok, jnp.int32),
                         jnp.int32(length))
        with torch.no_grad():
            tl, tc = tlm.decode_step(tparams, tcfg, tc, {
                "token": torch.from_numpy(ttok)}, length)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        _cache_close(tc, jc)
        tids, jids = spy.take()
        assert tids and len(tids) == len(jids), (len(tids), len(jids))
        for t, j in zip(tids, jids):
            np.testing.assert_array_equal(t, j)
        jtok, ttok = np.asarray(jl).argmax(-1), tl.numpy().argmax(-1)
        jstream.append(jtok)
        tstream.append(ttok)
    assert np.array_equal(np.stack(tstream), np.stack(jstream))


def _dense(cfg):
    cfg = dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, min_seq_for_sparse=10**9))
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Greedy decode logits equal full-forward logits (dense mode): the
    reference's bar, and the reference's decode logits within 1e-4."""
    cfg, tcfg, params, tparams = _setup(arch)
    cfg, tcfg = _dense(cfg), _dense(tcfg)
    S = 32
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, (B, S))
    with torch.no_grad():
        _, tc = tlm.prefill(tparams, tcfg, {
            "tokens": torch.from_numpy(toks[:, :S - 1])}, max_len=S)
        dec, _ = tlm.decode_step(tparams, tcfg, tc, {
            "token": torch.from_numpy(toks[:, S - 1])}, S - 1)
        full, _ = tlm.prefill(tparams, tcfg, {
            "tokens": torch.from_numpy(toks)}, max_len=S)
    assert dec.shape == (B, cfg.vocab_size)
    assert torch.isfinite(dec).all()
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-4)
    _, jc = jlm.prefill(params, cfg, {
        "tokens": jnp.asarray(toks[:, :S - 1], jnp.int32)}, max_len=S)
    jdec, _ = jlm.decode_step(params, cfg, jc, {
        "token": jnp.asarray(toks[:, S - 1], jnp.int32)}, jnp.int32(S - 1))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sparse_decode_path_runs(arch):
    """LeoAM sparse selection active in decode: finite logits, and the
    cache updated in place at position S - 1 (the port of the reference's
    test of the same name, over the seven configs)."""
    _, tcfg, _, tparams = _setup(arch)
    S = 64
    toks = np.random.RandomState(0).randint(1, tcfg.vocab_size, (B, S))
    with torch.no_grad():
        _, cache = tlm.prefill(tparams, tcfg, {
            "tokens": torch.from_numpy(toks[:, :S - 1])}, max_len=S)
        logits, cache2 = tlm.decode_step(tparams, tcfg, cache, {
            "token": torch.from_numpy(toks[:, S - 1])}, S - 1)
    assert torch.isfinite(logits).all()
    lk = cache2["prologue"][0].get("k")
    if lk is None:
        lk = cache2["prologue"][0]["ckv"]
    assert (lk[:, S - 1].abs() > 0).any()


def test_decode_step_impl_ref_is_the_plain_path():
    """``impl="ref"`` asks for the plain versions: on the CPU it is the
    default path, bit for bit."""
    _, tcfg, _, tparams = _setup("longchat-7b-32k")
    toks = np.random.RandomState(2).randint(1, tcfg.vocab_size, (B, 48))
    outs = []
    for impl in (None, "ref"):
        with torch.no_grad():
            _, c = tlm.prefill(tparams, tcfg, {
                "tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
            outs.append(tlm.decode_step(tparams, tcfg, c, {
                "token": torch.from_numpy(toks[:, -1])}, 48, impl=impl)[0])
    assert torch.equal(outs[0], outs[1])


def test_unported_decode_contexts_raise():
    """A sequence-sharded decode context without its mesh raises a
    ``ValueError`` naming the mesh, in ``DecodeCtx`` and in
    ``combine_partials`` (the sequence-sharded decode itself is ported,
    ROADMAP A12b, and held in ``tests/test_torch_mesh.py``).  The test
    kept its name from when both were refused, and cross-attention decode
    too (ROADMAP A11, ported): ``gqa_decode`` over a cross K/V cache
    equals the reference's within 1e-5 and writes nothing."""
    with pytest.raises(ValueError, match="mesh"):
        tattn.DecodeCtx(seq_axes=("data",))
    from repro.models import attention as jattn
    cfg, tcfg, params, tparams = _setup("longchat-7b-32k")
    rng = np.random.RandomState(5)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    ck = rng.randn(B, 24, cfg.n_kv_heads, cfg.hd).astype(np.float32)
    cv = rng.randn(B, 24, cfg.n_kv_heads, cfg.hd).astype(np.float32)
    yj, _ = jattn.gqa_decode(params["prologue"][0]["core"], cfg, "attn",
                             jnp.asarray(x), {}, jnp.int32(7), layer_idx=0,
                             cross_kv_cache=(jnp.asarray(ck),
                                             jnp.asarray(cv)))
    empty = {}
    yt, out = tattn.gqa_decode(tparams["prologue"][0]["core"], tcfg, "attn",
                               torch.from_numpy(x), empty, 7, layer_idx=0,
                               cross_kv_cache=(torch.from_numpy(ck),
                                               torch.from_numpy(cv)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    assert out is empty and not empty
    with pytest.raises(ValueError, match="mesh"):
        tsa.combine_partials(tsa.Partials(*[torch.zeros(1)] * 3), ("data",))


def _serving_cfg(get):
    cfg = get("longchat-7b-32k", smoke=True)
    return dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=16,
                                       importance_rate=1.0, early_rate=1.0,
                                       min_seq_for_sparse=32))


def test_engine_matches_untiered_decode_at_full_budget():
    """With budget ~= all chunks + flat selection, the port's engine token
    stream equals the port's plain ``lm.decode_step`` stream, and the
    reference's engine stream (``tests/test_serving.py``'s test, through
    the port)."""
    from repro.serving.engine import EngineCfg as JCfg
    from repro.serving.engine import LeoAMEngine as JEngine
    cfg, tcfg = _serving_cfg(get_config), _serving_cfg(t_get_config)
    params = jlm.init(cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, 64)
    eng = LeoAMEngine(tcfg, tparams, EngineCfg(
        max_len=128, selection="flat", transit_codec=None), device="cpu")
    got = eng.generate(prompt, 6)
    eng.store.close()
    with torch.no_grad():
        logits, cache = tlm.prefill(tparams, tcfg, {
            "tokens": torch.from_numpy(prompt[None])}, max_len=128)
        tok = int(logits[0].argmax())
        ref, length = [tok], len(prompt)
        for _ in range(5):
            logits, cache = tlm.decode_step(tparams, tcfg, cache, {
                "token": torch.tensor([tok])}, length)
            tok = int(logits[0].argmax())
            ref.append(tok)
            length += 1
    assert got == ref, (got, ref)
    jeng = JEngine(cfg, params, JCfg(max_len=128, selection="flat",
                                     transit_codec=None))
    assert jeng.generate(prompt, 6) == got
    jeng.store.close()


def test_quickstart_runs_on_the_cpu():
    """``python -m repro_torch.launch.quickstart --device cpu`` runs and
    prints the cache leaf names that ``examples/quickstart.py`` prints
    (the reference's prefill cache at the same config)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart", "--device",
         "cpu"], env={**os.environ, "PYTHONPATH": str(src)},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = next(x for x in res.stdout.splitlines()
                if x.startswith("cache leaves:"))
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, chunk_size=16, importance_rate=0.15,
        min_seq_for_sparse=64))
    jc = jax.eval_shape(lambda: jlm.prefill(
        jlm.init(cfg, jax.random.PRNGKey(0)), cfg,
        {"tokens": jnp.zeros((1, 255), jnp.int32)}, max_len=256))[1]
    assert line == f"cache leaves: {sorted(jc['prologue'][0].keys())}"
    assert "sparse-vs-dense logits: cos=" in res.stdout
