"""``lm.forward_train`` of the port against ``repro.models.lm.
forward_train`` under autograd (ROADMAP A12a), for every smoke config of
``list_configs()``, with the same weights (a JAX ``lm.init`` tree carried
across with ``params_from_jax``) and the same numpy batch, built as
``tests/test_models_smoke.py:make_batch`` builds it; half of the configs
here, the rest in ``tests/test_torch_train_models_more.py``.

What must hold (f32):

- the loss within ``LOSS_TOL`` (relative) of ``jax.value_and_grad``'s,
  every metric (``nll``, ``tokens``, ``accuracy``, the MoE aux losses,
  ``loss``) the same set of keys and within ``LOSS_TOL``;
- every parameter's gradient within ``GRAD_TOL`` of that leaf's largest
  reference magnitude: 1e-4, since jamba's 16 random layers (Mamba, MoE)
  reach 6.4e-5 on the rounding of ``exp`` and ``tanh`` (ROADMAP C: XLA's
  and torch's round one ulp apart), while the attention-only configs
  stay within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.models import lm as tlm
from repro_torch.models.params import leaves, params_from_jax, requires_grad

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# split over the two files so that each runs in about a minute (the JAX
# gradients of deepseek's and jamba's compile slowest: one in each)
FIRST_HALF = ["deepseek-v2-lite-16b", "longchat-7b-32k", "nemotron-4-340b",
              "phi4-mini-3.8b", "qwen2-vl-2b", "qwen3-1.7b"]
SECOND_HALF = [a for a in list_configs() if a not in FIRST_HALF]


def make_batch(cfg, rng, B=2, S=32):
    """numpy: ``tests/test_models_smoke.py:make_batch``'s batch."""
    batch = {}
    toks = rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.embed_inputs and not cfg.is_encdec:
        batch["embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
        if cfg.rope == "mrope":
            batch["positions"] = np.broadcast_to(
                np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    else:
        batch["tokens"] = toks
    if cfg.is_encdec:
        batch["embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
        batch["tokens"] = toks
    batch["targets"] = toks
    return batch


def jax_value_and_grad(cfg, params, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p, b: jlm.forward_train(p, cfg, b), has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, metrics, grads


def torch_value_and_grad(tcfg, tparams, batch):
    ptree = requires_grad(tparams)
    loss, metrics = tlm.forward_train(
        ptree, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(ptree), allow_unused=True)
    return loss, metrics, grads


def assert_grads_close(tgrads, jgrads, tol=GRAD_TOL):
    jl = leaves(jax.tree.map(np.asarray, jgrads))
    assert len(tgrads) == len(jl)
    for i, (t, j) in enumerate(zip(tgrads, jl)):
        t = np.zeros_like(j) if t is None else t.numpy()
        assert t.shape == j.shape, (i, t.shape, j.shape)
        bar = tol * max(float(np.abs(j).max()), 1e-30)
        err = float(np.abs(t - j).max())
        assert err <= bar, f"leaf {i} {j.shape}: {err} > {bar}"


def check_forward_train(arch):
    """The port's loss, metrics and gradients against ``jax.value_and_grad``
    of the reference on one smoke config."""
    cfg, tcfg = get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    batch = make_batch(cfg, np.random.RandomState(0))
    jl, jm, jg = jax_value_and_grad(cfg, params, batch)
    tl, tm, tg = torch_value_and_grad(tcfg, tparams, batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    assert set(tm) == set(jm), (sorted(tm), sorted(jm))
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    assert_grads_close(tg, jg)


@pytest.mark.parametrize("arch", FIRST_HALF)
def test_forward_train_matches_reference(arch):
    check_forward_train(arch)


def test_every_config_is_held():
    """The two files' halves together cover ``list_configs()``."""
    assert sorted(FIRST_HALF + SECOND_HALF) == sorted(list_configs())
    assert len(list_configs()) == 11
