"""The train step, ported from the train half of ``repro.launch.steps``:
``TrainCfg`` and ``make_train_step(cfg, tcfg)`` on one device.

The reference's mesh and dry-run half (``input_specs``, ``param_specs``,
the ``make_jitted_*`` functions, ``abstract_state``) waits for the port's
device mesh (ROADMAP A12b) and its dry-run analysers (A12c).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.models import lm
from repro_torch.models.params import (leaves, requires_grad, torch_dtype,
                                       tree_map)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import SCHEDULES


@dataclass(frozen=True)
class TrainCfg:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "warmup_cosine"
    adam: adamw.AdamWCfg = dataclasses.field(default_factory=adamw.AdamWCfg)


def _microbatches(batch: Dict[str, Any], nm: int, device) -> list:
    """The batch split into ``nm`` microbatches of consecutive rows, as
    the reference splits it (``positions`` (3, B, S) along its B)."""
    out = [{} for _ in range(nm)]
    for k, v in batch.items():
        v = torch.as_tensor(v).to(device)
        axis = 1 if k == "positions" else 0
        if v.shape[axis] % nm:
            raise ValueError(f"batch[{k!r}] has {v.shape[axis]} rows, not a "
                             f"multiple of {nm} microbatches")
        for i, part in enumerate(v.chunk(nm, dim=axis)):
            out[i][k] = part
    return out


def make_train_step(cfg, tcfg: TrainCfg):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params", "opt"}`` (:func:`adamw.init_opt_state`);
    ``batch`` holds numpy arrays or tensors (``tokens``/``embeds``,
    ``targets``, optional ``positions``).  The batch is split into
    ``cfg.runtime.microbatches`` microbatches; each one's gradients come
    from ``torch.autograd.grad`` of :func:`lm.forward_train` and are
    summed into a tree in the reference's ``gzero`` dtype (the config's
    ``adam_dtype``), never into a bf16 ``.grad``.  Then the schedule's
    learning rate at the state's step and :func:`adamw.apply_updates`
    with ``grad_scale=1/nm``.  Metrics: the microbatches' mean ``loss``
    and ``accuracy``, ``grad_norm``, ``param_norm`` and ``lr``.  The
    input state is not written."""
    sched = SCHEDULES[tcfg.schedule]
    nm = max(1, cfg.runtime.microbatches)
    gdt = torch_dtype(cfg.runtime.adam_dtype)

    def train_step(state, batch):
        params = state["params"]
        dev = state["opt"]["step"].device
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt,
                                              device=p.device), params)
        gleaves = leaves(gsum)
        msum = {k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in ("loss", "accuracy")}
        for mb in _microbatches(batch, nm, dev):
            ptree = requires_grad(params)
            loss, metrics = lm.forward_train(ptree, cfg, mb)
            grads = torch.autograd.grad(loss, leaves(ptree),
                                        allow_unused=True)
            with torch.no_grad():
                for a, g in zip(gleaves, grads):
                    if g is not None:
                        a.add_(g)
                for k in msum:
                    msum[k] = msum[k] + metrics[k].detach().float()
            del ptree, loss, metrics, grads
        lr = sched(state["opt"]["step"], peak_lr=tcfg.lr,
                   warmup_steps=tcfg.warmup_steps,
                   total_steps=tcfg.total_steps)
        params_new, opt_new, om = adamw.apply_updates(
            params, gsum, state["opt"], tcfg.adam, lr, grad_scale=1.0 / nm)
        metrics = {k: v / nm for k, v in msum.items()}
        metrics.update(om)
        metrics["lr"] = lr
        return {"params": params_new, "opt": opt_new}, metrics

    return train_step
