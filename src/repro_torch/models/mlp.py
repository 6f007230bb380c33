"""Feed-forward blocks, ported from ``repro.models.mlp``: dense (SwiGLU /
GeGLU / squared-ReLU / ReLU) and mixture-of-experts with both of the
reference's dispatches: the INFERENCE one (``no_drop=True``: no capacity
drops, so each token's output depends on that token alone) and the
TRAINING one (capacity drops, static (E, C, d) expert products, the
load-balance and router z aux losses)."""

from __future__ import annotations

import math
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


def _route(p, cfg, xf: torch.Tensor):
    """(router logits (T, E) f32, probs, top_p (T, K) renormalized, top_e
    (T, K) int64); the top-k in ``jax.lax.top_k``'s order."""
    K = cfg.moe.top_k
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    return logits, probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def moe_route(p, cfg, xf: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router of (T, d) tokens: f32 logits, softmax, the top-k in the
    reference's order (``jax.lax.top_k``: descending, ties to the lower
    expert index — a stable descending sort) and the renormalized weights.
    Returns (top_p (T, K) f32, top_e (T, K) int64)."""
    return _route(p, cfg, xf)[2:]


def _capacity(tokens: int, m) -> int:
    c = int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(4, c)


def _combine(y_tk: torch.Tensor, top_p: torch.Tensor, dtype) -> torch.Tensor:
    """(T, K, d) expert rows weighted by top_p (T, K), added in f32 in k
    order."""
    y_tk = y_tk.float()
    y = y_tk[:, 0] * top_p[:, :1]
    for k in range(1, y_tk.shape[1]):
        y = y + y_tk[:, k] * top_p[:, k:k + 1]
    return y.to(dtype)


def _shared(p, cfg, xf: torch.Tensor) -> torch.Tensor:
    sp = {k[len("shared_"):]: v for k, v in p.items()
          if k.startswith("shared_")}
    return dense_apply(sp, cfg, xf)


def _moe_capacity(p, cfg, x: torch.Tensor, shards=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training dispatch, as the reference's code (not its docstring):
    ONE stable argsort of all T·K (token, k) pairs by expert; a pair keeps
    its slot if its rank within its expert is below
    ``C = _capacity(T, moe)``, else it is dropped (into a sink row that is
    cut off).  The experts run as (E, C, d) batched products; the combine
    is the inverse permutation.  Gradients reach the router through top_p
    and probs (the one-hot of top_e carries none, as in the reference).

    With ``shards`` (a ``sharding.ctx.BatchShards``) ``x`` is this rank's
    block of a batch cut over mesh axes, and the dispatch is the whole
    batch's: C is the whole batch's, a pair's rank counts its expert's
    pairs in the blocks before this one (they come first in the whole
    batch's order), and each aux value is this block's term of the whole
    batch's mean (``frac_tokens`` reduced over the blocks), so the blocks'
    aux, and their gradients, sum to the whole batch's."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, K = B * S, m.n_experts, m.top_k
    dev = x.device
    xf = x.reshape(T, d)
    logits, probs, top_p, top_e = _route(p, cfg, xf)
    Tg = T if shards is None else T * shards.n
    C = _capacity(Tg, m)
    e_flat = top_e.reshape(-1)                                # (T*K,)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                side="left")
    rank = torch.arange(T * K, device=dev) - starts[sorted_e]
    if shards is None:
        keep = rank < C
    else:
        # each expert's pairs in this block (bincount's counts, from the
        # sorted ids: an output of E entries whatever the data)
        counts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                    side="right") - starts
        before = shards.before(counts)
        keep = rank + before[sorted_e] < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)      # sink: E*C
    # the tokens into (E*C + 1, d) slots, the last row the overflow sink
    xe = xf.new_zeros((E * C + 1, d)).index_put(
        (slot,), xf.index_select(0, order // K))
    xe = xe[:-1].reshape(E, C, d)
    h = torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    if _gated(cfg.act):
        h = _act_fn(cfg.act)(torch.einsum("ecd,edf->ecf", xe,
                                          p["w_gate"])) * h
    else:
        h = _act_fn(cfg.act)(h)
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(E * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    # combine: each (token, k) pair reads its slot back (the sink row: 0)
    slot_tk = torch.empty_like(slot)
    slot_tk[order] = slot
    y = _combine(ye.index_select(0, slot_tk).reshape(T, K, d), top_p,
                 x.dtype)
    if m.n_shared:
        y = y + _shared(p, cfg, xf)
    onehot = torch.nn.functional.one_hot(top_e, E).float()    # (T, K, E)
    if shards is None:
        frac_tokens = onehot.sum(dim=1).mean(dim=0)
        frac_probs = probs.mean(dim=0)
        aux = {"moe_lb_loss": E * (frac_tokens * frac_probs).sum(),
               "moe_z_loss": torch.logsumexp(logits,
                                             dim=-1).square().mean(),
               "moe_drop_frac": 1.0 - keep.float().mean()}
    else:
        frac_tokens = shards.sum(onehot.sum(dim=1).sum(dim=0)) / Tg
        aux = {"moe_lb_loss": E * (frac_tokens * probs.sum(dim=0)
                                   / Tg).sum(),
               "moe_z_loss": torch.logsumexp(logits,
                                             dim=-1).square().sum() / Tg,
               "moe_drop_frac": (~keep).float().sum() / (Tg * K)}
    return y.reshape(B, S, d), aux


def moe_loss(aux: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    m = cfg.moe
    return (m.aux_loss_weight * aux["moe_lb_loss"]
            + m.router_z_weight * aux["moe_z_loss"])


def expert_counts(flat_e: torch.Tensor, n_experts: int) -> list:
    """The rows routed to each expert, read on the host (``bincount``).
    A fake tensor (the dry run's trace) holds no values: its counts are a
    balanced router's, ``T·K // E`` rows an expert and the remainder one
    each to the first experts.  The expert FLOPs are then exact for any
    routing, since the rows always sum to T·K; only the per-expert split
    (and so the launches' shapes) is a stand-in."""
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(flat_e, FakeTensor):
        base, rem = divmod(flat_e.numel(), n_experts)
        return [base + (e < rem) for e in range(n_experts)]
    return torch.bincount(flat_e, minlength=n_experts).tolist()


def moe_apply(p, cfg, x: torch.Tensor, *, no_drop: bool = False,
              shards=None):
    """x: (B, S, d) -> the reference's ``moe_apply``.

    ``no_drop=False`` (training): the capacity dispatch
    (:func:`_moe_capacity`), returning ``(y, aux)`` with the reference's
    aux dict (``moe_lb_loss``, ``moe_z_loss``, ``moe_drop_frac``); with
    ``shards``, over the whole batch that ``x`` is this rank's block of.

    ``no_drop=True`` (inference) returns ``y`` alone (the aux losses are
    training metrics, left out).

    The reference scatters the routed rows into a zero-padded (E, T, d)
    buffer (capacity T, so nothing drops) and runs every expert over all T
    rows.  Without drops each token's output depends on that token alone,
    so the same function is computed here expert by expert over the rows
    routed to it: sort the (token, k) pairs by expert (stable), one SwiGLU
    per expert with rows, scatter back, combine in f32 in k order, then add
    the shared experts.  At T = 4096 this skips the padded form's 1 GiB
    buffer and its T·E rows of expert work.  One host read a call (the
    per-expert row counts, :func:`expert_counts`)."""
    if not no_drop:
        return _moe_capacity(p, cfg, x, shards)
    m = cfg.moe
    B, S, d = x.shape
    T, K = B * S, m.top_k
    xf = x.reshape(T, d)
    top_p, top_e = moe_route(p, cfg, xf)
    flat_e = top_e.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    counts = expert_counts(flat_e, m.n_experts)
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
    y = _combine(y_tk.reshape(T, K, d), top_p, x.dtype)
    if m.n_shared:
        y = y + _shared(p, cfg, xf)
    return y.reshape(B, S, d)
