"""Feed-forward blocks, ported from ``repro.models.mlp``: dense (SwiGLU /
GeGLU / squared-ReLU / ReLU) and mixture-of-experts with the reference's
INFERENCE dispatch (``no_drop``: no capacity drops, so each token's output
depends on that token alone).  The training dispatch with its capacity
drops and aux losses waits for the training side (ROADMAP A12)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def moe_params(cfg) -> Dict[str, ParamDef]:
    m, d = cfg.moe, cfg.d_model
    ff = m.d_ff_expert
    p = {
        "router": ParamDef((d, m.n_experts), ("embed", None),
                           dtype="float32"),
        "w_up": ParamDef((m.n_experts, d, ff), ("expert", "embed", None)),
        "w_down": ParamDef((m.n_experts, ff, d), ("expert", None, "embed")),
    }
    if _gated(cfg.act):
        p["w_gate"] = ParamDef((m.n_experts, d, ff),
                               ("expert", "embed", None))
    if m.n_shared:
        sp = dense_params(cfg, ff=m.n_shared * ff)
        p.update({f"shared_{k}": v for k, v in sp.items()})
    return p


def moe_route(p, cfg, xf: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router of (T, d) tokens: f32 logits, softmax, the top-k in the
    reference's order (``jax.lax.top_k``: descending, ties to the lower
    expert index — a stable descending sort) and the renormalized weights.
    Returns (top_p (T, K) f32, top_e (T, K) int64)."""
    K = cfg.moe.top_k
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_e


def moe_apply(p, cfg, x: torch.Tensor, *, no_drop: bool = False
              ) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), the reference's ``moe_apply`` with
    ``no_drop=True`` (its aux losses are training metrics, left out).

    The reference scatters the routed rows into a zero-padded (E, T, d)
    buffer (capacity T, so nothing drops) and runs every expert over all T
    rows.  Without drops each token's output depends on that token alone,
    so the same function is computed here expert by expert over the rows
    routed to it: sort the (token, k) pairs by expert (stable), one SwiGLU
    per expert with rows, scatter back, combine in f32 in k order, then add
    the shared experts.  At T = 4096 this skips the padded form's 1 GiB
    buffer and its T·E rows of expert work.  One host read a call (the
    per-expert row counts)."""
    if not no_drop:
        raise NotImplementedError(
            "moe_apply(no_drop=False) is the training dispatch with "
            "capacity drops; not ported yet (ROADMAP A12)")
    m = cfg.moe
    B, S, d = x.shape
    T, K = B * S, m.top_k
    xf = x.reshape(T, d)
    top_p, top_e = moe_route(p, cfg, xf)
    flat_e = top_e.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=m.n_experts).tolist()
    xs = xf[order // K]                                      # rows by expert
    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        seg = xs[start:start + n]
        h = seg @ p["w_up"][e]
        if _gated(cfg.act):
            h = _act_fn(cfg.act)(seg @ p["w_gate"][e]) * h
        else:
            h = _act_fn(cfg.act)(h)
        ys[start:start + n] = h @ p["w_down"][e]
        start += n
    y_tk = torch.empty_like(ys)
    y_tk[order] = ys
    y_tk = y_tk.reshape(T, K, d).float()
    y = y_tk[:, 0] * top_p[:, :1]
    for k in range(1, K):
        y = y + y_tk[:, k] * top_p[:, k:k + 1]
    y = y.to(x.dtype)
    if m.n_shared:
        sp = {k[len("shared_"):]: v for k, v in p.items()
              if k.startswith("shared_")}
        y = y + dense_apply(sp, cfg, xf)
    return y.reshape(B, S, d)
