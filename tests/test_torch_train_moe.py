"""The capacity-drop MoE dispatch (``mlp.moe_apply(no_drop=False)``, the
training one) against ``repro.models.mlp.moe_apply`` on each MoE smoke
config (deepseek-v2-lite: 4 experts top-2 + a shared expert; moonshot;
jamba), at capacity factors that drop pairs and one that drops none,
with the same weights and inputs.

What must hold (f32):

- ``_capacity`` equal to the reference's for every token count;
- the drop fraction exactly equal (the same (token, k) pairs keep their
  slot: one stable argsort over all T·K pairs, ranks below C), the output
  and the aux losses within ``TOL``;
- the gradients of ``sum(y * w) + moe_loss(aux)`` with respect to x, the
  router and every expert and shared weight within ``GRAD_TOL`` of each
  leaf's largest reference magnitude (``jax.grad``): the router's reach
  it through top_p and the softmax, as in the reference;
- over ``ROUTER_STEPS`` train steps of deepseek's smoke config at its own
  routing (64 experts, top 6), from one state on the reference's batches,
  ``forward_train``'s ``moe_lb_loss``, ``moe_z_loss`` and
  ``moe_drop_frac`` before each step within ``ROUTER_TOL`` (relative) of
  the reference's (ROADMAP C17: the router's trajectory is the
  reference's at smoke width).
"""

import dataclasses

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
from repro.models import mlp as jmlp
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models.params import params_from_jax
from repro_torch.optim import adamw as tadamw

TOL, GRAD_TOL = 1e-5, 1e-5
# ROADMAP C17: the router's trajectory over training steps, the two
# packages from one state, f32 moments (relative, per metric and step)
ROUTER_TOL, ROUTER_STEPS = 1e-4, 8
ARCHS = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b",
         "jamba-1.5-large-398b"]


def _cfgs(arch, capacity_factor):
    def one(get):
        cfg = get(arch, smoke=True)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return one(get_config), one(t_get_config)


def _moe_block(params):
    """The first block with a MoE MLP: its ``mlp`` subtree."""
    for blk in params["prologue"]:
        if "router" in blk.get("mlp", {}):
            return blk["mlp"]
    for blk in params["body"]:
        if "router" in blk.get("mlp", {}):
            return jax.tree.map(lambda a: a[0], blk["mlp"])
    raise AssertionError("no MoE block")


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch):
    cfg, tcfg = _cfgs(arch, 1.25)
    for T in (1, 7, 64, 1000, 8192):
        assert tmlp._capacity(T, tcfg.moe) == jmlp._capacity(T, cfg.moe)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 8.0])
def test_capacity_dispatch_and_gradients_match_reference(arch,
                                                         capacity_factor):
    cfg, tcfg = _cfgs(arch, capacity_factor)
    jp = _moe_block(jlm.init(cfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, cfg.d_model).astype(np.float32)
    w = rng.randn(2, 24, cfg.d_model).astype(np.float32)

    def jloss(p, x):
        y, aux = jmlp.moe_apply(p, cfg, x)
        return jnp.sum(y * w) + jmlp.moe_loss(aux, cfg), (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmlp.moe_apply(tp, tcfg, tx)
    tloss = (ty * torch.from_numpy(w)).sum() + tmlp.moe_loss(taux, tcfg)
    names = sorted(tp)
    grads = torch.autograd.grad(tloss, [tp[k] for k in names] + [tx])

    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    drop = float(jaux["moe_drop_frac"])
    assert float(taux["moe_drop_frac"]) == drop
    # 48 tokens x top-2: factor 0.5 and 1.0 drop pairs, 8.0 none
    assert (drop > 0) == (capacity_factor < 8.0), drop
    want = {**{k: np.asarray(v) for k, v in jgp.items()},
            "x": np.asarray(jgx)}
    for name, g in zip(names + ["x"], grads):
        ref = want[name]
        bar = GRAD_TOL * max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= bar, f"{name}: {err} > {bar}"
    assert float(np.abs(want["router"]).max()) > 0


def test_inference_dispatch_is_unchanged_by_the_training_one():
    """``no_drop=True`` still returns the output alone, equal to the
    reference's no-drop output; the training dispatch at a capacity that
    drops nothing gives the same rows."""
    cfg, tcfg = _cfgs("deepseek-v2-lite-16b", 64.0)
    jp = _moe_block(jlm.init(cfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(5).randn(1, 9, cfg.d_model).astype(np.float32)
    want, _ = jmlp.moe_apply(jp, cfg, jnp.asarray(x), no_drop=True)
    got = tmlp.moe_apply(tp, tcfg, torch.from_numpy(x), no_drop=True)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    train, aux = tmlp.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert float(aux["moe_drop_frac"]) == 0.0
    np.testing.assert_allclose(train.numpy(), got.numpy(), rtol=TOL,
                               atol=TOL)


def _router_cfgs():
    """deepseek-v2-lite's smoke config with its published routing (64
    experts, top 6), 2 microbatches, f32 moments."""
    def one(get):
        cfg = get("deepseek-v2-lite-16b", smoke=True)
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, n_experts=64, top_k=6),
            runtime=dataclasses.replace(cfg.runtime, microbatches=2,
                                        adam_dtype="float32"))
    return one(get_config), one(t_get_config)


def test_router_trajectory_matches_reference_over_training():
    """ROADMAP C17: the two packages' routers train alike — the aux
    metrics of ``forward_train`` before each of 8 steps (lr 1e-3, warmup
    2), the same drop fractions and balance losses."""
    cfg, tcfg = _router_cfgs()
    adam = dict(state_dtype="float32")
    sched = dict(lr=1e-3, warmup_steps=2, total_steps=ROUTER_STEPS)
    jt = jsteps.TrainCfg(adam=jadamw.AdamWCfg(**adam), **sched)
    tt = tsteps.TrainCfg(adam=tadamw.AdamWCfg(**adam), **sched)
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    jstate = {"params": params,
              "opt": jadamw.init_opt_state(params, jt.adam)}
    tstate = params_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jsteps.make_train_step(cfg, jt))
    tstep = tsteps.make_train_step(tcfg, tt)
    jaux = jax.jit(lambda p, b: jlm.forward_train(p, cfg, b)[1])
    loader = JLoader(JDataCfg(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=4))
    try:
        batches = [next(loader) for _ in range(ROUTER_STEPS)]
    finally:
        loader.close()
    keys = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
    traj = []
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        want = jaux(jstate["params"], jb)
        with torch.no_grad():
            _, got = tlm.forward_train(
                tstate["params"], tcfg,
                {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
        for k in keys:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=ROUTER_TOL,
                                       err_msg=f"step {i} {k}")
        traj.append(float(want["moe_drop_frac"]))
        jstate, _ = jstep(jstate, jb)
        tstate, _ = tstep(tstate, b)
    # 6 of 64 experts at capacity factor 1.25 drop pairs from the start
    assert traj[0] > 0.0
