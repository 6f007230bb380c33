"""The port's train step and entry point (ROADMAP A12a) against the
reference: ``launch.steps.make_train_step`` for three steps from a JAX train state
carried across (``params_from_jax``), at 1 and 2 microbatches, on the
reference's own batches; then the port's copies of
``tests/test_train_integration.py`` (the loss falls, a resume is bitwise,
``run_with_restarts`` survives injected failures) and the CLI.

What must hold (f32 smoke configs, f32 moments):

- every metric (``loss``, ``accuracy``, ``grad_norm``, ``param_norm``,
  ``lr``) within ``METRIC_TOL`` (relative) at every step, ``step`` equal;
- after three steps every moment within ``MOMENT_TOL`` of its leaf's
  largest reference magnitude; every parameter within 1e-5 of its leaf's
  scale plus ``ADAM_TOL`` x the learning rates summed, and at most
  ``ADAM_FRAC`` of a leaf's elements beyond 1e-5 of its scale.  Adam
  divides by the gradient's own scale: where a gradient lies within a few
  eps of zero, a 1e-7 relative difference moves its update by a fair part
  of lr (measured: at most 0.024 x the summed lr on 1 element in 4 000);
- deepseek's own bf16 ``adam_dtype`` (bf16 moments and a bf16 gradient
  sum over its 2 microbatches): one step, the metrics within
  ``METRIC_TOL`` and the moments within ``BF16_TOL`` (relative): the bf16
  gradient sum may round one bf16 ulp (2^-7) apart, m = 0.1 g carries
  that and its own rounding (2 ulps), v = 0.05 g^2 twice that (4 ulps);
  and where the 2 microbatches' gradients cancel, the sum is off by up to
  a bf16 ulp of the leaf's largest magnitude (the absolute part).
  Over more steps bf16 rounding flips near-zero moments' signs, which
  moves an update by up to lr on a third of the elements, so three bf16
  steps are held by the f32 run above.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.synthetic import DataCfg as JDataCfg
from repro.data.synthetic import ShardedLoader as JLoader
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
from repro_torch.configs import get_config as t_get_config
from repro_torch.data.synthetic import DataCfg, ShardedLoader
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.params import leaves, params_from_jax
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 run_with_restarts)

METRIC_TOL, MOMENT_TOL = 1e-5, 1e-4
BF16_TOL = {"m": 2 * 2 ** -7, "v": 4 * 2 ** -7}
ADAM_TOL, ADAM_FRAC = 0.05, 2e-3


def _cfgs(arch, nm, adam_dtype=None):
    def one(get):
        cfg = get(arch, smoke=True)
        return dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, microbatches=nm,
            adam_dtype=adam_dtype or cfg.runtime.adam_dtype))
    return one(get_config), one(t_get_config)


def _batches(vocab, n, seq=32, batch=4):
    loader = JLoader(JDataCfg(vocab_size=vocab, seq_len=seq,
                              global_batch=batch))
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _run_both(cfg, tcfg, n_steps):
    """``n_steps`` of both packages' train steps from one JAX state on the
    reference's batches; the metrics held at every step.  Returns (JAX
    state, port state, the learning rates)."""
    adam = dict(state_dtype=cfg.runtime.adam_dtype)
    jt = jsteps.TrainCfg(lr=3e-3, warmup_steps=1, total_steps=10,
                         adam=jadamw.AdamWCfg(**adam))
    tt = tsteps.TrainCfg(lr=3e-3, warmup_steps=1, total_steps=10,
                         adam=tadamw.AdamWCfg(**adam))
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    jstate = {"params": params,
              "opt": jadamw.init_opt_state(params, jt.adam)}
    tstate = params_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jsteps.make_train_step(cfg, jt))
    tstep = tsteps.make_train_step(tcfg, tt)
    lrs = []
    for i, b in enumerate(_batches(cfg.vocab_size, n_steps)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=METRIC_TOL,
                                       err_msg=f"step {i} {k}")
        lrs.append(float(jm["lr"]))
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) \
        == n_steps
    want = dict(_flatten(jax.tree.map(np.asarray, jstate)))
    got = {k: v.float().numpy() for k, v in _flatten(tstate)}
    assert set(got) == set(want)
    return want, got, lrs


@pytest.mark.parametrize("arch,nm", [("qwen3-1.7b", 1), ("qwen3-1.7b", 2),
                                     ("deepseek-v2-lite-16b", 2)])
def test_train_step_matches_reference(arch, nm):
    cfg, tcfg = _cfgs(arch, nm, adam_dtype="float32")
    want, got, lrs = _run_both(cfg, tcfg, 3)
    for k, j in want.items():
        j = np.asarray(j, np.float32)
        scale = max(float(np.abs(j).max()), 1e-30)
        err = np.abs(got[k] - j)
        if k.startswith("opt/"):
            assert err.max() <= MOMENT_TOL * scale, (k, err.max(), scale)
            continue
        bar = 1e-5 * scale + ADAM_TOL * sum(lrs)
        assert err.max() <= bar, (k, err.max(), bar)
        assert (err > 1e-5 * scale).mean() <= ADAM_FRAC, k


def test_train_step_with_bf16_moments_matches_reference():
    """deepseek-v2-lite's ``adam_dtype`` bfloat16, 2 microbatches: one
    step (lr 0 at the first warmup step, so the parameters stay)."""
    cfg, tcfg = _cfgs("deepseek-v2-lite-16b", 2)
    assert cfg.runtime.adam_dtype == "bfloat16"
    want, got, _ = _run_both(cfg, tcfg, 1)
    for k, j in want.items():
        j = np.asarray(j, np.float32)
        if k.startswith("params/"):
            np.testing.assert_array_equal(got[k], j, err_msg=k)
        elif k != "opt/step":
            tol = BF16_TOL[k.split("/")[1]]
            np.testing.assert_allclose(
                got[k], j, rtol=tol,
                atol=2 ** -7 * max(float(np.abs(j).max()), 1e-30),
                err_msg=k)


# ---------------------------------------------------------------------------
# The reference's integration checks, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = t_get_config("qwen3-1.7b", smoke=True)
    tcfg = tsteps.TrainCfg(lr=3e-3, warmup_steps=5, total_steps=200,
                           schedule="warmup_cosine")
    params = tlm.init(cfg, seed=0, device="cpu")
    state = {"params": params,
             "opt": tadamw.init_opt_state(params, tcfg.adam)}
    step = tsteps.make_train_step(cfg, tcfg)
    loader = ShardedLoader(DataCfg(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=8))
    yield cfg, tcfg, state, step, loader
    loader.close()


def _same_bits(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def test_loss_decreases(tiny_setup):
    cfg, tcfg, state, step, loader = tiny_setup
    losses = []
    for _, batch in zip(range(30), loader):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def test_checkpoint_resume_exact(tmp_path, tiny_setup):
    cfg, tcfg, state, step, loader = tiny_setup
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    batches = [next(loader) for _ in range(6)]
    s = state
    for b in batches[:3]:
        s, _ = step(s, b)
    ck.save(3, s, block=True)
    s_a = s
    for b in batches[3:]:
        s_a, _ = step(s_a, b)
    restored, at = ck.restore(s)
    ck.close()
    assert at == 3
    s_b = restored
    for b in batches[3:]:
        s_b, _ = step(s_b, b)
    for a, b in zip(leaves(s_a), leaves(s_b)):
        assert _same_bits(a, b)


def test_fault_tolerant_restarts(tmp_path, tiny_setup):
    cfg, tcfg, state, step, loader = tiny_setup
    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    batches = [next(loader) for _ in range(12)]
    fail_at = {5: True, 8: True}

    def step_fn(i, s):
        if fail_at.pop(i, False):
            raise RuntimeError("injected worker failure")
        return step(s, batches[i])[0]

    ck.save(0, state, block=True)
    mon = StragglerMonitor()
    final, stats = run_with_restarts(
        step_fn, state, n_steps=12, checkpointer=ck, save_every=2,
        restore_fn=ck.restore, max_restarts=5, monitor=mon)
    ck.close()
    assert stats.restarts == 2 and stats.failed_steps == [5, 8]
    assert int(final["opt"]["step"]) == 12


def test_run_with_restarts_gives_up_after_max_restarts(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, {"w": torch.zeros(2)}, block=True)

    def always_fails(i, s):
        raise RuntimeError("injected")

    with pytest.raises(RuntimeError, match="injected"):
        run_with_restarts(always_fails, {"w": torch.zeros(2)}, n_steps=3,
                          checkpointer=ck, save_every=0,
                          restore_fn=ck.restore, max_restarts=2)
    ck.close()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_trains_on_the_cpu_when_asked(tmp_path, caplog):
    """``--device cpu --smoke``: the loss falls; with ``--ckpt`` the run
    saves, and ``--resume`` goes on from the last step."""
    caplog.set_level(logging.INFO, logger="repro_torch.train")
    hist = ttrain.main(["--smoke", "--device", "cpu", "--steps", "12",
                        "--seq", "32", "--log-every", "1", "--lr", "3e-3",
                        "--microbatches", "2"])
    assert [i for i, _ in hist] == list(range(12))
    assert hist[-1][1] < hist[0][1]
    ck = str(tmp_path / "ck")
    ttrain.main(["--smoke", "--device", "cpu", "--steps", "4", "--seq",
                 "32", "--ckpt", ck, "--save-every", "2"])
    assert Checkpointer(ck).all_steps() == [2, 4]
    hist = ttrain.main(["--smoke", "--device", "cpu", "--steps", "6",
                        "--seq", "32", "--ckpt", ck, "--save-every", "2",
                        "--resume", "--log-every", "1"])
    assert [i for i, _ in hist] == [4, 5]
    assert "resumed from step 4" in caplog.text


def test_cli_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--smoke", "--steps", "1"])
