"""Dense feed-forward blocks (SwiGLU / GeGLU / squared-ReLU / ReLU), ported
from ``repro.models.mlp``.  Mixture-of-experts is a later slice (ROADMAP
A7)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation
from repro_torch.models.params import ParamDef


def _gated(act: str) -> bool:
    return act in ("swiglu", "geglu")


def _act_fn(act: str):
    return {"swiglu": F.silu, "geglu":
            lambda x: F.gelu(x, approximate="tanh")}.get(act) \
        or activation(act)


def dense_params(cfg, ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    ff = ff or cfg.d_ff
    p = {"w_up": ParamDef((d, ff), ("embed", "ffn")),
         "w_down": ParamDef((ff, d), ("ffn", "embed"))}
    if _gated(cfg.act):
        p["w_gate"] = ParamDef((d, ff), ("embed", "ffn"))
    return p


def dense_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_up"]
    if _gated(cfg.act):
        h = _act_fn(cfg.act)(x @ p["w_gate"]) * h
    else:
        h = _act_fn(cfg.act)(h)
    return h @ p["w_down"]
