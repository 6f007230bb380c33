"""The second half of ``tests/test_torch_train_models.py``'s configs
(``forward_train`` and its gradients against ``jax.value_and_grad``, the
same tolerances), and the port's activation checkpointing:
``runtime.remat == "block"`` and the two-level ``remat_groups`` give the
loss and gradients of ``remat == "none"`` (the same torch ops run again,
so bitwise on the CPU), on the body's stacked leaves too."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.models import lm as tlm
from repro_torch.models.params import leaves, requires_grad
from test_torch_train_models import (SECOND_HALF, check_forward_train,
                                     make_batch, torch_value_and_grad)


@pytest.mark.parametrize("arch", SECOND_HALF)
def test_forward_train_matches_reference(arch):
    check_forward_train(arch)


def _runtime(cfg, **kw):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, **kw))


@pytest.mark.parametrize("arch,layers,groups", [
    ("qwen3-1.7b", 6, None),             # prologue 2, 4 body repeats
    ("qwen3-1.7b", 6, 2),                # two groups of 2 repeats
    ("deepseek-v2-lite-16b", 6, 2),      # MLA + capacity MoE, aux in remat
    ("jamba-1.5-large-398b", None, None),  # Mamba + MoE period
    ("seamless-m4t-large-v2", None, None),  # encoder blocks rematted
])
def test_remat_gives_the_plain_loss_and_gradients(arch, layers, groups):
    cfg = t_get_config(arch, smoke=True)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    assert tlm._layer_plan(cfg)[2] >= 1
    tparams = tlm.init(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, np.random.RandomState(1))
    plain = torch_value_and_grad(_runtime(cfg, remat="none"), tparams,
                                 batch)
    remat = torch_value_and_grad(
        _runtime(cfg, remat="block", remat_groups=groups), tparams, batch)
    assert torch.equal(plain[0], remat[0])
    assert set(plain[1]) == set(remat[1])
    for k in plain[1]:
        assert torch.equal(plain[1][k], remat[1][k]), k
    assert len(plain[2]) == len(leaves(tparams))
    for a, b in zip(plain[2], remat[2]):
        assert torch.equal(a, b)


def _saved_bytes(cfg, params, batch):
    """Bytes of the tensors the forward leaves for the backward outside
    any activation checkpoint (a checkpoint keeps its own inputs only)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tlm.forward_train(requires_grad(params), cfg, batch)
    return total[0]


def test_remat_drops_the_blocks_activations():
    """Block remat keeps what a block is given, not what it computes:
    qwen3's smoke config at 10 layers (8 body repeats) saves ≥ 10x fewer
    bytes for the backward with ``remat="block"``, and fewer again with
    two groups (measured: 17.0 MB, 0.92 MB, 0.72 MB)."""
    cfg = dataclasses.replace(t_get_config("qwen3-1.7b", smoke=True),
                              n_layers=10)
    params = tlm.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(1, 512, (2, 64)).astype(np.int32))
    batch = {"tokens": toks, "targets": toks}
    plain = _saved_bytes(_runtime(cfg, remat="none"), params, batch)
    block = _saved_bytes(_runtime(cfg, remat="block"), params, batch)
    grouped = _saved_bytes(_runtime(cfg, remat="block", remat_groups=2),
                           params, batch)
    assert block * 10 <= plain and grouped < block, (plain, block, grouped)
