"""The port's dense decoder against ``repro.models``: the same weights (a
JAX ``lm.init`` tree carried across with ``params_from_jax``) and the same
numpy prompts give prefill logits within 1e-4 and K/V caches within 1e-5
(f32 smoke config; the two frameworks sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.params import params_from_jax


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
    return cfg, tcfg, params, tparams


def test_config_copy_resolves_inside_the_port():
    """get_config loads modules by string: the copy must load its own."""
    import sys
    tcfg = t_get_config("longchat-7b-32k")
    assert type(tcfg).__module__ == "repro_torch.configs.base"
    assert "repro_torch.configs.longchat_7b_32k" in sys.modules
    jcfg = get_config("longchat-7b-32k")
    for f in dataclasses.fields(jcfg):
        if f.name not in ("leoam", "runtime", "moe", "mla", "mamba"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(tcfg.leoam) == dataclasses.asdict(jcfg.leoam)


def test_params_carry_over_leaf_for_leaf(setup):
    cfg, tcfg, params, tparams = setup
    jl = jax.tree.leaves(params)
    assert len(tparams["prologue"]) == len(params["prologue"])
    body = tparams["body"][0]["core"]["wq"]
    assert body.shape == params["body"][0]["core"]["wq"].shape
    np.testing.assert_array_equal(body.numpy(),
                                  np.asarray(params["body"][0]["core"]["wq"]))
    n = sum(1 for _ in _leaves(tparams))
    assert n == len(jl)
    # the port's own init draws the same tree of shapes on the device
    own = tlm.init(tcfg, seed=3, device="cpu")
    assert [tuple(t.shape) for t in _leaves(own)] == \
        [tuple(a.shape) for a in _leaves(tparams)]


def _leaves(tree):
    if isinstance(tree, dict):                 # JAX's order: sorted keys
        for _, v in sorted(tree.items()):
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_common_blocks_match(rng):
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 700
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10_000.0).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10_000.0)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcommon.softcap(torch.from_numpy(x * 40), 30.0).numpy(),
        np.asarray(jcommon.softcap(jnp.asarray(x * 40), 30.0)),
        rtol=1e-5, atol=1e-5)
    for name in ("silu", "gelu", "relu", "relu2"):
        np.testing.assert_allclose(
            tcommon.activation(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jcommon.activation(name)(jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,bucket", [(57, None), (57, 64), (64, None),
                                      (20, 32)])
def test_prefill_matches_jax(setup, rng, S, bucket):
    cfg, tcfg, params, tparams = setup
    toks = rng.randint(2, cfg.vocab_size, S)
    if bucket is None:
        bj = {"tokens": jnp.asarray(toks[None], jnp.int32)}
        bt = {"tokens": torch.from_numpy(toks[None])}
    else:
        pad = np.zeros(bucket, np.int64)
        pad[:S] = toks
        bj = {"tokens": jnp.asarray(pad[None], jnp.int32),
              "length": jnp.int32(S)}
        bt = {"tokens": torch.from_numpy(pad[None]), "length": S}
    lj, cj = jlm.prefill(params, cfg, bj, max_len=128)
    lt, ct = tlm.prefill(tparams, tcfg, bt, max_len=128)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    for part in ("prologue", "body"):
        for cjj, ctt in zip(cj[part], ct[part]):
            assert sorted(ctt) == sorted(cjj)       # K/V and the pyramid
            for name in cjj:
                np.testing.assert_allclose(ctt[name].numpy(),
                                           np.asarray(cjj[name]),
                                           rtol=1e-5, atol=1e-5)
    # rows past the true length are zero, as ingest expects
    assert not ct["prologue"][0]["k"][0, S:].any()


def test_bucketed_prefill_equals_exact_length(setup, rng):
    _, tcfg, _, tparams = setup
    toks = rng.randint(2, tcfg.vocab_size, 40)
    pad = np.zeros(64, np.int64)
    pad[:40] = toks
    le, ce = tlm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(
        toks[None])}, max_len=128)
    lb, cb = tlm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(
        pad[None]), "length": 40}, max_len=128)
    assert int(le.argmax()) == int(lb.argmax())
    torch.testing.assert_close(lb, le, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cb["body"][0]["k"], ce["body"][0]["k"],
                               rtol=1e-5, atol=1e-6)


def test_unported_architectures_raise():
    """The test kept its name from when encoder-decoder and recurrent
    stacks were refused (ROADMAP A11, ported now): the four A11 configs'
    parameter trees equal the reference's in shapes and dtypes, leaf for
    leaf — Mamba's f32 ``a_log`` / ``d_skip``, the xLSTM gates, the
    encoder tree, ``cross`` and ``ln_x`` included."""
    from repro.models.params import ParamDef as JDef
    from repro_torch.models.params import is_def

    def flat(tree, is_leaf, prefix=()):
        if is_leaf(tree):
            return {prefix: (tuple(tree.shape), tree.dtype)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flat(v, is_leaf, prefix + (k,)))
        return out

    for arch in ("seamless-m4t-large-v2", "xlstm-125m",
                 "jamba-1.5-large-398b", "qwen2-vl-2b"):
        want = flat(jlm.param_defs(get_config(arch, smoke=True)),
                    lambda d: isinstance(d, JDef))
        got = flat(tlm.param_defs(t_get_config(arch, smoke=True)), is_def)
        assert got == want, arch
