"""AdamW with dtype-configurable moment states and global-norm clipping,
ported from ``repro.optim.adamw``: plain functions over the tensor tree
(not ``torch.optim.AdamW``, whose eps and decay order round otherwise),
with the reference's state tree ``{"m", "v", "step"}`` (``step`` an int32
0-d tensor), so a checkpoint of either package restores in the other.

Moments are stored in ``state_dtype`` (bf16 for the configs whose
``runtime.adam_dtype`` asks for it); the arithmetic is in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.params import leaves, torch_dtype, tree_map, tree_zip


@dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"


def init_opt_state(params: Any, cfg: AdamWCfg) -> Dict[str, Any]:
    dt = torch_dtype(cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def abstract_opt_state(params: Any, cfg: AdamWCfg) -> Dict[str, Any]:
    """:func:`init_opt_state`'s tree as meta tensors (no allocation)."""
    dt = torch_dtype(cfg.state_dtype)
    sd = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
    return {"m": tree_map(sd, params), "v": tree_map(sd, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict[str, Any],
                  cfg: AdamWCfg, lr: torch.Tensor, grad_scale=1.0,
                  norm=global_norm
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  ``lr`` is the scheduled learning rate (0-d).

    ``grad_scale`` (e.g. 1/num_microbatches) and the clip rescale fold
    into each leaf's update, so no f32 copy of the whole gradient tree is
    made.  ``norm`` gives a tree's global norm: on a mesh, where the trees
    hold this rank's shards, the norm of the whole trees, the same on
    every rank.  Returns (new params, new state, {"grad_norm",
    "param_norm"}); the inputs are not written."""
    metrics: Dict[str, torch.Tensor] = {}
    dev = state["step"].device
    scale = torch.tensor(grad_scale, dtype=torch.float32, device=dev)
    if cfg.clip_norm is not None:
        gnorm = norm(grads) * grad_scale
        scale = scale * torch.clamp(
            cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        metrics["grad_norm"] = gnorm
    step = state["step"] + 1
    sdt = torch_dtype(cfg.state_dtype)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32.square()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m32.to(sdt), v32.to(sdt)

    out = tree_zip(upd, params, grads, state["m"], state["v"])
    params_new, m_new, v_new = (tree_zip(lambda t, i=i: t[i], out)
                                for i in range(3))
    metrics["param_norm"] = norm(params_new)
    return params_new, {"m": m_new, "v": v_new, "step": step}, metrics
