"""Model assembly for dense decoder-only LMs, ported from
``repro.models.lm``.

Layer organisation as in the JAX package: ``prologue`` layers (the first
``cfg.prologue()``) are kept one block each, and the remaining layers form
a pattern-periodic ``body`` whose parameters are stacked on a leading
repeat axis — so a JAX parameter tree carries over leaf for leaf
(:func:`repro_torch.models.params.params_from_jax`).  PyTorch runs eagerly:
the body is a Python loop over the repeat axis.

Entry points: ``param_defs(cfg)``, ``init(cfg, seed, device)``,
``prefill(params, cfg, batch, max_len)``.  Recurrent, MoE, MLA and
encoder-decoder stacks raise ``NotImplementedError`` (ROADMAP A7, A11);
``decode_step`` with its in-model sparse path is a later slice.
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
