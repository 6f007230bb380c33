"""The trainer's pieces in the port against the reference (ROADMAP A12a):
``common.cross_entropy``, the schedules, AdamW, the synthetic data and
the checkpointer — the same numpy inputs through ``repro`` and
``repro_torch``.

What must hold:

- ``cross_entropy``'s loss and metrics within 1e-6 (relative; f32 sums in
  another order) with ignored targets, a ``valid`` mask and ``z_weight``,
  and its gradient within 1e-6 of ``jax.grad``'s;
- the schedules within 1 f32 ulp-scale (rtol 1e-6) at every step;
- ``apply_updates`` with f32 and bf16 moments, clipping active and not,
  ``grad_scale`` 0.5: parameters, moments and metrics within 1e-6
  (relative to each leaf's scale; bf16 leaves within one bf16 ulp), the
  step equal;
- batches bitwise the reference's (the port's corpus looks the Zipf draw
  up in a cdf built once, as ``rng.choice`` does each call);
- checkpoints: the reference's layout and keys, a bf16 round trip bit for
  bit, an f32 checkpoint of either package restoring in the other, GC and
  the atomic rename.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.data import synthetic as jdata
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
from repro_torch.data import synthetic as tdata
from repro_torch.models import common as tcommon
from repro_torch.models.params import leaves, params_from_jax, requires_grad
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched

TOL = 1e-6


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _pairs(got, want):
    """(got, want) leaves matched by key (JAX rebuilds dicts in sorted key
    order; the port keeps insertion order)."""
    g, w = dict(_flatten(got)), dict(_flatten(want))
    assert set(g) == set(w), (sorted(g), sorted(w))
    return [(g[k], w[k]) for k in sorted(w)]


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_weight", [0.0, 1e-3])
@pytest.mark.parametrize("with_valid", [False, True])
def test_cross_entropy_matches_reference(z_weight, with_valid):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 17, 50) * 3).astype(np.float32)
    targets = rng.randint(0, 50, (3, 17)).astype(np.int32)
    targets[rng.rand(3, 17) < 0.3] = -1                  # ignored
    valid = rng.rand(3, 17) < 0.8 if with_valid else None

    def jf(lg):
        return jcommon.cross_entropy(
            lg, jnp.asarray(targets),
            None if valid is None else jnp.asarray(valid), z_weight)

    (jl, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    tlg = torch.from_numpy(logits).requires_grad_(True)
    tl, tm = tcommon.cross_entropy(
        tlg, torch.from_numpy(targets),
        None if valid is None else torch.from_numpy(valid), z_weight)
    (tg,) = torch.autograd.grad(tl, [tlg])
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL * float(np.abs(jg).max()))


def test_cross_entropy_all_ignored_is_zero_not_nan():
    tl, tm = tcommon.cross_entropy(torch.randn(2, 4, 8),
                                   torch.full((2, 4), -1))
    jl, _ = jcommon.cross_entropy(jnp.zeros((2, 4, 8)),
                                  jnp.full((2, 4), -1))
    assert float(tl) == float(jl) == 0.0 and int(tm["tokens"]) == 1


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("warmup_cosine", dict(warmup_steps=10, total_steps=100)),
    ("warmup_cosine", dict(warmup_steps=0, total_steps=7)),
    ("constant", dict(warmup_steps=5)),
    ("constant", dict(warmup_steps=0)),
])
def test_schedules_match_reference(name, kw):
    for step in range(0, 120, 3):
        want = jsched.SCHEDULES[name](jnp.asarray(step, jnp.int32),
                                      peak_lr=3e-4, **kw)
        got = tsched.SCHEDULES[name](torch.tensor(step, dtype=torch.int32),
                                     peak_lr=3e-4, **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                                   err_msg=f"{name} step {step}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(rng, dt):
    return {"w": rng.randn(6, 5).astype(np.float32),
            "blocks": [{"b": rng.randn(7).astype(np.float32)},
                       {"b": rng.randn(3, 2).astype(np.float32)}],
            "s": rng.randn(4, 3).astype(np.float32)}


def _jx(tree, dt):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dt), tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [None, 1.0, 100.0])
def test_apply_updates_matches_reference(state_dtype, clip_norm):
    """Three steps from fresh state; ``clip_norm`` 1.0 clips (gradient
    norm ≈ 9), 100.0 does not; ``grad_scale`` 0.5."""
    rng = np.random.RandomState(1)
    cfg_j = jadamw.AdamWCfg(state_dtype=state_dtype, clip_norm=clip_norm)
    cfg_t = tadamw.AdamWCfg(state_dtype=state_dtype, clip_norm=clip_norm)
    p_np = _tree(rng, np.float32)
    jp = _jx(p_np, jnp.float32)
    jst = jadamw.init_opt_state(jp, cfg_j)
    tp = params_from_jax(p_np, "cpu")
    tst = tadamw.init_opt_state(tp, cfg_t)
    assert tst["step"].dtype == torch.int32 and tst["step"].shape == ()
    assert leaves(tst["m"])[0].dtype == {"float32": torch.float32,
                                         "bfloat16": torch.bfloat16}[
        state_dtype]
    for i in range(3):
        g_np = jax.tree.map(lambda a: (a * 1.5).astype(np.float32),
                            _tree(rng, np.float32))
        lr = 1e-2 * (i + 1)
        jp, jst, jm = jadamw.apply_updates(jp, _jx(g_np, jnp.float32), jst,
                                           cfg_j, jnp.float32(lr),
                                           grad_scale=0.5)
        tp, tst, tm = tadamw.apply_updates(tp, params_from_jax(g_np, "cpu"),
                                           tst, cfg_t, torch.tensor(lr),
                                           grad_scale=0.5)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]),
                                       rtol=TOL, err_msg=k)
    if clip_norm == 1.0:
        assert float(jm["grad_norm"]) > clip_norm
    assert int(tst["step"]) == int(jst["step"]) == 3
    pairs = _pairs({"m": tst["m"], "v": tst["v"], "p": tp},
                   {"m": jst["m"], "v": jst["v"], "p": jp})
    for t, j in pairs:
        j = np.asarray(j, np.float32)
        bf16 = t.dtype == torch.bfloat16
        # a bf16 moment may round to the neighbouring bf16 value
        rtol = 2 ** -7 if bf16 else 1e-5
        np.testing.assert_allclose(_np(t), j, rtol=rtol,
                                   atol=rtol * float(np.abs(j).max()))


def test_clip_by_global_norm_matches_reference():
    rng = np.random.RandomState(2)
    g = _tree(rng, np.float32)
    jg, jn = jadamw.clip_by_global_norm(_jx(g, jnp.float32), 0.5)
    tg, tn = tadamw.clip_by_global_norm(params_from_jax(g, "cpu"), 0.5)
    np.testing.assert_allclose(_np(tn), np.asarray(jn), rtol=TOL)
    for t, j in _pairs(tg, jg):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


def test_train_state_crosses_from_jax_and_requires_grad():
    """A whole JAX train state crosses through ``params_from_jax``: the
    moments keep their dtype (bf16 too), ``step`` an int32 0-d tensor;
    ``requires_grad`` makes new leaves sharing the storage."""
    p = {"w": jnp.ones((3, 2), jnp.float32)}
    st = {"params": p, "opt": jadamw.init_opt_state(
        p, jadamw.AdamWCfg(state_dtype="bfloat16"))}
    t = params_from_jax(jax.tree.map(np.asarray, st), "cpu")
    assert t["opt"]["m"]["w"].dtype == torch.bfloat16
    assert t["opt"]["step"].dtype == torch.int32
    assert t["opt"]["step"].shape == ()
    r = requires_grad(t["params"])
    assert r["w"].requires_grad and not t["params"]["w"].requires_grad
    assert r["w"].data_ptr() == t["params"]["w"].data_ptr()


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [512, 151_936])
def test_batches_bitwise_the_reference(vocab):
    """``pack_documents`` at the smoke vocabulary and at qwen3's: the
    same tokens and the same next document."""
    jc = jdata.SyntheticCorpus(jdata.DataCfg(vocab_size=vocab, seq_len=64,
                                             global_batch=4))
    tc = tdata.SyntheticCorpus(tdata.DataCfg(vocab_size=vocab, seq_len=64,
                                             global_batch=4))
    for start in (0, 5):
        a, da = jdata.pack_documents(jc, 64, start, 4)
        b, db = tdata.pack_documents(tc, 64, start, 4)
        np.testing.assert_array_equal(a, b)
        assert da == db


def test_loader_batches_bitwise_the_reference():
    cfg = dict(vocab_size=512, seq_len=32, global_batch=4)
    jl = jdata.ShardedLoader(jdata.DataCfg(**cfg), host_id=1, n_hosts=2)
    tl = tdata.ShardedLoader(tdata.DataCfg(**cfg), host_id=1, n_hosts=2)
    try:
        for _ in range(4):
            a, b = next(jl), next(tl)
            assert set(a) == set(b) == {"tokens", "targets"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        jl.close()
        tl.close()


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------


def _state():
    g = torch.Generator().manual_seed(0)
    p = {"embed": torch.randn(5, 4, generator=g).bfloat16(),
         "prologue": [{"w": torch.randn(4, 3, generator=g)}],
         "body": [{"w": torch.randn(2, 4, 3, generator=g).bfloat16()}]}
    return {"params": p,
            "opt": tadamw.init_opt_state(p, tadamw.AdamWCfg())}


def test_checkpoint_layout_and_bf16_round_trip(tmp_path):
    st = _state()
    st["opt"]["step"] += 7
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(7, st)
    ck.close()
    d = tmp_path / "step_00000007"
    meta = json.loads((d / "meta.json").read_text())
    assert meta["step"] == 7
    info = meta["leaves"]["params/body/0/w"]
    assert info == {"file": "params__body__0__w.npy", "shape": [2, 4, 3],
                    "dtype": "bfloat16"}
    assert np.load(d / info["file"]).dtype == np.uint16
    assert meta["leaves"]["opt/step"]["dtype"] == "int32"
    assert set(meta["leaves"]) == {
        "params/embed", "params/prologue/0/w", "params/body/0/w",
        "opt/m/embed", "opt/m/prologue/0/w", "opt/m/body/0/w",
        "opt/v/embed", "opt/v/prologue/0/w", "opt/v/body/0/w", "opt/step"}
    tpl = _state()
    got, at = Checkpointer(str(tmp_path)).restore(tpl)
    assert at == 7
    for a, b in zip(leaves(got), leaves(st)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = _state()
        bad["params"]["embed"] = torch.zeros(6, 4, dtype=torch.bfloat16)
        Checkpointer(str(tmp_path)).restore(bad)


def _f32_tree(rng):
    return {"params": {"a": rng.randn(3, 4).astype(np.float32),
                       "l": [{"b": rng.randn(2).astype(np.float32)}]},
            "opt": {"step": np.asarray(4, np.int32)}}


def test_f32_checkpoints_cross_between_the_packages(tmp_path):
    rng = np.random.RandomState(3)
    src = _f32_tree(rng)
    # the reference writes, the port restores (onto torch templates)
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(2, src)
    tpl = params_from_jax(jax.tree.map(np.zeros_like, src), "cpu")
    got, at = Checkpointer(str(tmp_path / "j")).restore(tpl)
    assert at == 2
    for a, b in _pairs(got, src):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)
    # the port writes torch tensors, the reference restores
    ck = Checkpointer(str(tmp_path / "t"), async_save=False)
    ck.save(5, params_from_jax(src, "cpu"))
    ck.close()
    back, at = JCheckpointer(str(tmp_path / "t")).restore(
        jax.tree.map(np.zeros_like, src))
    assert at == 5
    for a, b in _pairs(back, src):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_gc_and_atomicity(tmp_path):
    """As the reference's test: ``keep=2`` leaves the last two steps and
    no ``.tmp`` directory."""
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = {"w": torch.arange(10, dtype=torch.float32)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree, block=True)
    ck.close()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)
