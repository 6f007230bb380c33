"""Model assembly for dense decoder-only LMs, ported from
``repro.models.lm``.

Layer organisation as in the JAX package: ``prologue`` layers (the first
``cfg.prologue()``) are kept one block each, and the remaining layers form
a pattern-periodic ``body`` whose parameters are stacked on a leading
repeat axis — so a JAX parameter tree carries over leaf for leaf
(:func:`repro_torch.models.params.params_from_jax`).  PyTorch runs eagerly:
the body is a Python loop over the repeat axis.

Entry points: ``param_defs(cfg)``, ``init(cfg, seed, device)``,
``prefill(params, cfg, batch, max_len)``, and chunked prefill:
``init_decode_cache(cfg, batch, max_len, device)`` then
``prefill_chunk(params, cfg, batch, cache, max_len)`` per chunk.
Recurrent, MoE, MLA and encoder-decoder stacks raise
``NotImplementedError`` (ROADMAP A7, A11); ``decode_step`` with its
in-model sparse path is a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (positions_for, rms_norm, scale_like,
                                       softcap)
from repro_torch.models.params import (ParamDef, init_tree, is_def,
                                       torch_dtype, tree_map)

Params = Any


def _layer_plan(cfg):
    """(prologue [(idx, kind, mlp)], body period [(kind, mlp)], repeats)."""
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    pro_n = cfg.prologue()
    period = cfg.period()
    body = list(zip(kinds, mlps))[pro_n:]
    repeats = len(body) // period if body else 0
    assert repeats * period == len(body), (cfg.name, pro_n, period, len(body))
    prologue = [(i, kinds[i], mlps[i]) for i in range(pro_n)]
    return prologue, body[:period], repeats


def check_supported(cfg) -> None:
    """Raise for what this slice of the port leaves out."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"'{cfg.name}' is encoder-decoder; not ported yet (ROADMAP A11)")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"'{cfg.name}' uses MLA attention; not ported yet (ROADMAP A7)")
    bad = sorted({k for k in cfg.layer_kinds() if not k.startswith("attn")})
    if bad:
        raise NotImplementedError(
            f"'{cfg.name}' has non-attention layers {bad}; not ported yet "
            f"(ROADMAP A11)")
    if any(m == "moe" for m in cfg.mlp_kinds()):
        raise NotImplementedError(
            f"'{cfg.name}' has MoE layers; not ported yet (ROADMAP A7)")


def _block_defs(cfg, kind: str, mlp_kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    blk: Dict[str, Any] = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "core": attn.gqa_params(cfg),
    }
    if mlp_kind == "dense":
        ff = cfg.d_ff_dense if cfg.d_ff_dense else None
        blk["ln2"] = ParamDef((d,), (None,), init="ones")
        blk["mlp"] = mlp_mod.dense_params(cfg, ff=ff)
    return blk


def _stack_defs(defs: Dict[str, Any], n: int) -> Dict[str, Any]:
    return tree_map(
        lambda d: ParamDef((n, *d.shape), ("layer", *d.axes), d.init, d.dtype),
        defs, is_leaf=is_def)


def param_defs(cfg) -> Dict[str, Any]:
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    prologue, period, repeats = _layer_plan(cfg)
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed"), init="embed"),
        "final_norm": ParamDef((d,), (None,), init="ones"),
        "prologue": [_block_defs(cfg, k, m) for (_, k, m) in prologue],
        "body": [_stack_defs(_block_defs(cfg, k, m), repeats)
                 for (k, m) in period] if repeats else [],
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    return defs


def init(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return init_tree(param_defs(cfg), gen, torch_dtype(cfg.dtype), dev)


def body_block(params, pi: int, r: int) -> Dict[str, Any]:
    """Repeat ``r`` of body position ``pi``: views into the stacked leaves."""
    return tree_map(lambda a: a[r], params["body"][pi])


# ---------------------------------------------------------------------------
# Cache structure
# ---------------------------------------------------------------------------


def cache_defs(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """The decode cache's leaves, as :func:`prefill` returns them: K and V
    (batch, max_len, Hkv, hd) per attention layer, body layers stacked on
    the repeat axis.  The JAX cache's abstract pyramid is left out: the
    serving engine never reads it."""
    check_supported(cfg)
    prologue, period, repeats = _layer_plan(cfg)
    kv = ParamDef((batch, max_len, cfg.n_kv_heads, cfg.hd),
                  ("batch", None, "kv", None), init="zeros")
    blk = {"k": kv, "v": kv}
    return {"prologue": [dict(blk) for _ in prologue],
            "body": [_stack_defs(blk, repeats) for _ in period]
            if repeats else []}


def init_decode_cache(cfg, batch: int, max_len: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """A zeroed decode cache on ``device``: the starting state of chunked
    prefill, with the structure :func:`prefill` returns."""
    dev = resolve_device(device)
    return init_tree(cache_defs(cfg, batch, max_len), None,
                     torch_dtype(cfg.dtype), dev)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_mlp(blk, cfg, mlp_kind: str, x: torch.Tensor) -> torch.Tensor:
    if mlp_kind == "none" or "mlp" not in blk:
        return x
    if mlp_kind == "moe":
        raise NotImplementedError("MoE is not ported yet (ROADMAP A7)")
    h = rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + mlp_mod.dense_apply(blk["mlp"], cfg, h)


def _embed_in(params, cfg, batch: Dict[str, Any]
              ) -> Tuple[torch.Tensor, int, int]:
    tokens = batch["tokens"]
    B, S = tokens.shape
    return params["embed"][tokens.long()], B, S


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = x @ params["lm_head"]
    return softcap(logits.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Prefill: run the full prompt, build the decode cache
# ---------------------------------------------------------------------------


def prefill(params, cfg, batch: Dict[str, Any], max_len: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (last-position logits (B, V) f32, cache).

    ``batch["length"]`` (optional int) marks the prompt's true length when
    the token row is right-padded to a BUCKET size: the logits come from
    position ``length - 1`` and K/V cache rows past ``length`` are zeroed,
    so one bucket serves every prompt length in it, token-identical to
    exact-length prefill.  The cache is ``{"prologue": [{"k", "v"}...],
    "body": [{"k", "v"} stacked on the repeat axis]}`` with K/V
    (B, max_len, Hkv, hd)."""
    check_supported(cfg)
    prologue, period, repeats = _layer_plan(cfg)
    x, B, S = _embed_in(params, cfg, batch)
    pos = positions_for(cfg, B, S, device=x.device)
    length = int(batch.get("length", S))

    def block_prefill(blk, kind, mlpk, x):
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(blk["core"], cfg, h, pos)
        window = cfg.window if kind == "attn_local" else None
        o = attn.blocked_attention(
            scale_like(q, 1.0 / math.sqrt(cfg.hd)), k, v, causal=True,
            window=window, attn_softcap=cfg.attn_softcap,
            block_kv=cfg.runtime.attn_block_kv)
        y = o.reshape(B, S, -1) @ blk["core"]["wo"]
        cache = attn.gqa_prefill_cache(cfg, k, v, max_len, length)
        return _apply_mlp(blk, cfg, mlpk, x + y), cache

    caches_pro = []
    for blk, (_idx, kind, mlpk) in zip(params["prologue"], prologue):
        x, c = block_prefill(blk, kind, mlpk, x)
        caches_pro.append(c)

    per_pos = [[] for _ in period]
    for r in range(repeats):
        for pi, (kind, mlpk) in enumerate(period):
            x, c = block_prefill(body_block(params, pi, r), kind, mlpk, x)
            per_pos[pi].append(c)
    caches_body = [{name: torch.stack([c[name] for c in cs])
                    for name in ("k", "v")} for cs in per_pos] \
        if repeats else []

    if "length" in batch:
        idx = min(max(length - 1, 0), S - 1)
        x_last = x[:, idx:idx + 1]
    else:
        x_last = x[:, -1:]
    logits_last = _logits(params, cfg, x_last)[:, 0]
    return logits_last, {"prologue": caches_pro, "body": caches_body}


# ---------------------------------------------------------------------------
# Chunked prefill: advance admission one fixed-size token chunk at a time
# ---------------------------------------------------------------------------


def prefill_chunk(params, cfg, batch: Dict[str, Any], cache: Dict[str, Any],
                  max_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One chunk of a chunked prefill.

    batch: ``{"tokens": (B, C), "start": int, "length": int}`` — the chunk
    occupies global positions ``[start, start + C)``; rows at positions
    >= ``length`` are padding (last chunk only).  ``cache`` is the decode
    cache (:func:`init_decode_cache` to start).  Each layer writes the
    chunk's K/V into it at ``start``, padding rows zeroed first, and
    attends the chunk's queries over the whole cache with an offset causal
    mask: rows not yet written sit at later positions, so the mask alone
    keeps them out.  The cache is updated IN PLACE and returned.

    Returns (logits (B, V) f32 at position ``min(length, start + C) - 1``,
    cache); the final chunk's logits give the prompt's first token."""
    check_supported(cfg)
    prologue, period, repeats = _layer_plan(cfg)
    tokens = batch["tokens"]
    B, C = tokens.shape
    start, length = int(batch["start"]), int(batch["length"])
    if start + C > max_len:
        raise ValueError(f"chunk [{start}, {start + C}) runs past "
                         f"max_len={max_len}")
    x = params["embed"][tokens.long()]
    pos = positions_for(cfg, B, C, device=x.device, offset=start)
    valid = (torch.arange(C, device=x.device) + start < length)[
        None, :, None, None]

    def attn_chunk(blk, kind, mlpk, x, c):
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(blk["core"], cfg, h, pos)
        c["k"][:, start:start + C] = torch.where(valid, k, 0).to(c["k"].dtype)
        c["v"][:, start:start + C] = torch.where(valid, v, 0).to(c["v"].dtype)
        window = cfg.window if kind == "attn_local" else None
        o = attn.blocked_attention(
            scale_like(q, 1.0 / math.sqrt(cfg.hd)), c["k"], c["v"],
            causal=True, window=window, attn_softcap=cfg.attn_softcap,
            block_kv=cfg.runtime.attn_block_kv, q_offset=start)
        y = o.reshape(B, C, -1) @ blk["core"]["wo"]
        return _apply_mlp(blk, cfg, mlpk, x + y)

    for blk, (_idx, kind, mlpk), c in zip(params["prologue"], prologue,
                                          cache["prologue"]):
        x = attn_chunk(blk, kind, mlpk, x, c)
    for r in range(repeats):
        for pi, (kind, mlpk) in enumerate(period):
            c = {name: leaf[r] for name, leaf in cache["body"][pi].items()}
            x = attn_chunk(body_block(params, pi, r), kind, mlpk, x, c)

    # last valid row of THIS chunk (earlier chunks' logits are discarded)
    idx = min(max(min(length, start + C) - 1 - start, 0), C - 1)
    return _logits(params, cfg, x[:, idx:idx + 1])[:, 0], cache
