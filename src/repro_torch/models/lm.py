"""Model assembly, ported from ``repro.models.lm``: decoder-only LMs,
hybrids, recurrent stacks and encoder-decoder.

Layer organisation as in the JAX package: ``prologue`` layers (the first
``cfg.prologue()``) are kept one block each, and the remaining layers form
a pattern-periodic ``body`` whose parameters are stacked on a leading
repeat axis — so a JAX parameter tree carries over leaf for leaf
(:func:`repro_torch.models.params.params_from_jax`).  PyTorch runs eagerly:
the body is a Python loop over the repeat axis.

A block's core is attention — GQA/MHA or DeepSeek's MLA (whose decode
cache is the latent ``ckv`` / ``krope`` pair) — or a recurrent layer:
Mamba (``models/ssm.py``, Jamba's) or xLSTM's mLSTM / sLSTM
(``models/xlstm.py``), whose decode cache is their fixed-size state.
Feed-forward blocks are dense or mixture-of-experts, the latter with the
inference dispatch (no capacity drops) everywhere but ``forward_train``.
An encoder-decoder stack (seamless) runs a non-causal encoder over
``batch["embeds"]`` and gives every decoder attention layer a
cross-attention over the encoder's K/V,
kept in the cache as ``cross_k`` / ``cross_v``; M-RoPE (qwen2-vl) takes
``batch["positions"]`` (3, B, S) at prefill.

Entry points: ``param_defs(cfg)``, ``init(cfg, seed, device)``,
``forward_train(params, cfg, batch)`` (the training loss, under autograd,
with the capacity-drop MoE dispatch and block remat),
``prefill(params, cfg, batch, max_len)``, chunked prefill (decoder-only):
``init_decode_cache(cfg, batch, max_len, device)`` then
``prefill_chunk(params, cfg, batch, cache, max_len)`` per chunk, after
``load_prefix_rows(cfg, cache, rows, n)`` for a warm shared prefix, and
``decode_step(params, cfg, cache, batch, length)``: one token for every
sequence with the in-model LeoAM sparse decode on attention layers (the
abstract pyramid the cache carries, kernels B1 and B2 on the card;
``impl="ref"`` runs their plain versions there) and the exact recurrence
on recurrent ones.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import LOCAL_CTX, DecodeCtx
from repro_torch.models.common import (cross_entropy, positions_for,
                                       rms_norm, scale_like, softcap)
from repro_torch.models.params import (ParamDef, abstract_tree, init_tree,
                                       is_def, torch_dtype, tree_map)

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


def _core_params(cfg, kind: str) -> Dict[str, ParamDef]:
    if kind.startswith("attn"):
        return attn.attn_params(cfg)
    if kind == "mamba":
        return ssm_mod.mamba_params(cfg)
    if kind == "mlstm":
        return xlstm_mod.mlstm_params(cfg)
    if kind == "slstm":
        return xlstm_mod.slstm_params(cfg)
    raise ValueError(kind)


def _block_defs(cfg, kind: str, mlp_kind: str, cross: bool = False
                ) -> Dict[str, Any]:
    d = cfg.d_model
    blk: Dict[str, Any] = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "core": _core_params(cfg, kind),
    }
    if mlp_kind == "dense":
        ff = cfg.d_ff_dense if cfg.d_ff_dense else None
        blk["ln2"] = ParamDef((d,), (None,), init="ones")
        blk["mlp"] = mlp_mod.dense_params(cfg, ff=ff)
    elif mlp_kind == "moe":
        blk["ln2"] = ParamDef((d,), (None,), init="ones")
        blk["mlp"] = mlp_mod.moe_params(cfg)
    if cross:
        blk["ln_x"] = ParamDef((d,), (None,), init="ones")
        blk["cross"] = attn.gqa_params(cfg)
    return blk


def _stack_defs(defs: Dict[str, Any], n: int) -> Dict[str, Any]:
    return tree_map(
        lambda d: ParamDef((n, *d.shape), ("layer", *d.axes), d.init, d.dtype),
        defs, is_leaf=is_def)


def _cross(cfg) -> bool:
    return cfg.is_encdec and cfg.cross_attn


def param_defs(cfg) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab_size
    prologue, period, repeats = _layer_plan(cfg)
    cross = _cross(cfg)
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed"), init="embed"),
        "final_norm": ParamDef((d,), (None,), init="ones"),
        "prologue": [_block_defs(cfg, k, m, cross) for (_, k, m) in prologue],
        "body": [_stack_defs(_block_defs(cfg, k, m, cross), repeats)
                 for (k, m) in period] if repeats else [],
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    if cfg.is_encdec:
        defs["encoder"] = {
            "body": _stack_defs(_block_defs(cfg, "attn", "dense"),
                                cfg.enc_layers),
            "final_norm": ParamDef((d,), (None,), init="ones"),
        }
    return defs


def init(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return init_tree(param_defs(cfg), gen, torch_dtype(cfg.dtype), dev)


def abstract_params(cfg) -> Params:
    """The parameter tree as meta tensors (no allocation)."""
    return abstract_tree(param_defs(cfg), cfg.dtype)


def body_block(params, pi: int, r: int) -> Dict[str, Any]:
    """Repeat ``r`` of body position ``pi``: views into the stacked leaves."""
    return tree_map(lambda a: a[r], params["body"][pi])


# ---------------------------------------------------------------------------
# Cache structure
# ---------------------------------------------------------------------------


def encoder_len(cfg, dec_len: int) -> int:
    """The static encoder length of an encoder-decoder decode cache."""
    return min(4096, max(256, dec_len // 8))


def _block_cache_defs(cfg, kind: str, batch: int, max_len: int,
                      cross: bool = False) -> Optional[Dict[str, ParamDef]]:
    c: Dict[str, ParamDef] = {}
    if kind.startswith("attn"):
        c.update(attn.cache_defs(cfg, kind, batch, max_len) or {})
        if cross:
            Hkv, hd = cfg.n_kv_heads, cfg.hd
            enc = encoder_len(cfg, max_len)
            for name in ("cross_k", "cross_v"):
                c[name] = ParamDef((batch, enc, Hkv, hd),
                                   ("batch", None, "kv", None), init="zeros")
    elif kind == "mamba":
        c.update(ssm_mod.mamba_cache_defs(cfg, batch))
    elif kind == "mlstm":
        c.update(xlstm_mod.mlstm_cache_defs(cfg, batch))
    elif kind == "slstm":
        c.update(xlstm_mod.slstm_cache_defs(cfg, batch))
    return c or None


def cache_defs(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """The decode cache's leaves, as :func:`prefill` returns them: per
    attention layer K and V (batch, max_len, Hkv, hd) — for MLA the latent
    ``ckv`` (batch, max_len, r) and ``krope`` (batch, max_len, rope) — and,
    with ``cfg.leoam.enabled``, the f32 abstract pyramid leaves
    (``attention.gqa_cache_defs`` / ``mla_cache_defs``), beside an
    encoder-decoder's ``cross_k`` / ``cross_v``; per recurrent layer its
    state (``ssm.mamba_cache_defs``, ``xlstm.*_cache_defs``); body layers
    stacked on the repeat axis."""
    prologue, period, repeats = _layer_plan(cfg)
    cross = _cross(cfg)
    return {"prologue": [_block_cache_defs(cfg, k, batch, max_len, cross)
                         for (_, k, _m) in prologue],
            "body": [_stack_defs(_block_cache_defs(cfg, k, batch, max_len,
                                                   cross), repeats)
                     for (k, _m) in period] if repeats else []}


def abstract_cache(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """The decode cache of :func:`cache_defs` as meta tensors."""
    return abstract_tree(cache_defs(cfg, batch, max_len), cfg.dtype)


def init_decode_cache(cfg, batch: int, max_len: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """A zeroed decode cache on ``device``: the starting state of chunked
    prefill, with the structure :func:`prefill` returns, each leaf in its
    ``ParamDef``'s dtype (the pyramid leaves f32, zeros as in the
    reference)."""
    dev = resolve_device(device)
    return init_tree(cache_defs(cfg, batch, max_len), None,
                     torch_dtype(cfg.dtype), dev)


def load_prefix_rows(cfg, cache: Dict[str, Any], kv_rows,
                     n_tokens: int) -> Dict[str, Any]:
    """Seed a chunked-prefill cache with shared-prefix K/V rows.

    ``kv_rows`` holds one ``(k_rows, v_rows)`` pair per attention layer
    (store layer order), each ``(n_tokens, Hkv, hd)`` (tensors or arrays,
    anywhere) — for MLA the latent plane ``(n_tokens, 1, r + rope)`` in
    the first position, split into ``ckv`` and ``krope``.  They are
    written into positions ``[0, n_tokens)`` of the batch-1 cache from
    :func:`init_decode_cache`, layer by layer, in the cache's dtype and IN
    PLACE, so chunked prefill resumes at ``start == n_tokens`` over the
    warm span without recomputing it.  Returns the cache."""
    prologue, period, repeats = _layer_plan(cfg)
    slots = [cache["prologue"][i] for i, (_, k, _m) in enumerate(prologue)
             if k.startswith("attn")]
    slots += [{name: leaf[r] for name, leaf in cache["body"][pi].items()}
              for r in range(repeats) for pi, (k, _m) in enumerate(period)
              if k.startswith("attn")]
    if len(kv_rows) != len(slots):
        raise ValueError(f"load_prefix_rows: {len(kv_rows)} layers of rows "
                         f"for a cache of {len(slots)} attention layers")
    for c, (k_rows, v_rows) in zip(slots, kv_rows):
        if cfg.mla is not None:
            lat = torch.as_tensor(k_rows)[:, 0]
            r = cfg.mla.kv_lora_rank
            pairs = (("ckv", lat[:, :r]), ("krope", lat[:, r:]))
        else:
            pairs = (("k", k_rows), ("v", v_rows))
        for name, rows in pairs:
            leaf = c[name]
            leaf[0, :n_tokens] = torch.as_tensor(rows).to(
                device=leaf.device, dtype=leaf.dtype)
    return cache


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_mlp(blk, cfg, mlp_kind: str, x: torch.Tensor) -> torch.Tensor:
    if mlp_kind == "none" or "mlp" not in blk:
        return x
    h = rms_norm(x, blk["ln2"], cfg.norm_eps)
    if mlp_kind == "moe":
        # the inference dispatch: a token's output never depends on the
        # rows around it, so bucketed and chunked prefill stay token-exact
        return x + mlp_mod.moe_apply(blk["mlp"], cfg, h, no_drop=True)
    return x + mlp_mod.dense_apply(blk["mlp"], cfg, h)


def _apply_mlp_train(blk, cfg, mlp_kind: str, x: torch.Tensor, aux,
                     shards=None):
    """The MLP with the training MoE dispatch (capacity drops, over the
    whole batch of ``shards``); a MoE block adds its aux losses into
    ``aux``."""
    if mlp_kind == "none" or "mlp" not in blk:
        return x, aux
    h = rms_norm(x, blk["ln2"], cfg.norm_eps)
    if mlp_kind == "moe":
        y, a = mlp_mod.moe_apply(blk["mlp"], cfg, h, shards=shards)
        aux = {k: aux.get(k, 0.0) + v for k, v in a.items()}
    else:
        y = mlp_mod.dense_apply(blk["mlp"], cfg, h)
    return x + y, aux


def _block_train(blk, cfg, kind: str, mlp_kind: str, x: torch.Tensor, pos,
                 enc_out: Optional[torch.Tensor], aux: Dict[str, Any],
                 causal: bool = True, shards=None):
    """One block over whole sequences: the core (attention or a
    recurrent layer), an encoder-decoder's cross-attention, the MLP.
    Returns (x, aux)."""
    h = rms_norm(x, blk["ln1"], cfg.norm_eps)
    if kind.startswith("attn"):
        if cfg.mla is not None:
            y = attn.mla_train(blk["core"], cfg, h, pos)
        else:
            y = attn.gqa_train(blk["core"], cfg, kind, h, pos, causal=causal)
    elif kind == "mamba":
        y = ssm_mod.mamba_train(blk["core"], cfg, h)
    elif kind == "mlstm":
        y = xlstm_mod.mlstm_train(blk["core"], cfg, h)
    elif kind == "slstm":
        y = xlstm_mod.slstm_train(blk["core"], cfg, h)
    else:
        raise ValueError(kind)
    x = x + y
    if enc_out is not None and "cross" in blk:
        hx = rms_norm(x, blk["ln_x"], cfg.norm_eps)
        ckv = attn.cross_kv(blk["cross"], cfg, enc_out)
        x = x + attn.gqa_train(blk["cross"], cfg, "attn", hx, pos,
                               cross_kv=ckv)
    return _apply_mlp_train(blk, cfg, mlp_kind, x, aux, shards)


def _remat(on: bool, fn, *args):
    """``fn(*args)``; with ``on``, under a non-reentrant activation
    checkpoint: the backward recomputes what ``fn`` saved, so only its
    inputs stay alive between the forward and the backward."""
    if not on:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _unstack(tree) -> list:
    """The per-repeat trees of a stacked tree, by one ``unbind`` of each
    leaf: the backward stacks the repeats' gradients once, where an index
    per repeat would write a zero-padded stacked-size gradient for each."""
    parts = {}
    tree_map(lambda a: parts.setdefault(id(a), a.unbind(0)), tree)
    n = len(next(iter(parts.values())))
    return [tree_map(lambda a, r=r: parts[id(a)][r], tree) for r in range(n)]


def _write_state(cache: Dict[str, torch.Tensor],
                 new: Dict[str, torch.Tensor]) -> None:
    """A recurrent layer's new state into its cache leaves IN PLACE (a
    body layer's leaves are views into the stacked repeat axis)."""
    for name, t in new.items():
        cache[name].copy_(t)


def _encode(params, cfg, embeds: torch.Tensor, remat: bool = False
            ) -> torch.Tensor:
    """The encoder over frame embeddings (B, S_enc, d): non-causal
    attention blocks with dense MLPs, then the encoder's final norm
    (``remat``: each block recomputed in the backward)."""
    enc = params["encoder"]
    B, S, _ = embeds.shape
    pos = positions_for(cfg, B, S, device=embeds.device)
    x = embeds.to(torch_dtype(cfg.dtype))
    for blk in _unstack(enc["body"]):
        x, _ = _remat(remat, _block_train, blk, cfg, "attn", "dense", x,
                      pos, None, {}, False)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _embed_in(params, cfg, batch: Dict[str, Any]
              ) -> Tuple[torch.Tensor, int, int]:
    """The decoder's input rows: ``batch["embeds"]`` (a modality stub's
    embeddings) for a decoder-only model that is given them, else the
    token embeddings (an encoder-decoder's embeds feed its encoder)."""
    if "embeds" in batch and not cfg.is_encdec:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
        return x, x.shape[0], x.shape[1]
    tokens = torch.as_tensor(batch["tokens"]).to(params["embed"].device)
    B, S = tokens.shape
    # F.embedding: the gradient of the lookup adds its rows in a fixed
    # order, where an index's scatter-add races across threads
    return torch.nn.functional.embedding(tokens.long(), params["embed"]), \
        B, S


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = x @ params["lm_head"]
    return softcap(logits.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Train forward
# ---------------------------------------------------------------------------


_MOE_AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def forward_train(params, cfg, batch: Dict[str, Any], shards=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of a batch and its metrics, as the reference's.

    ``batch``: ``tokens`` (B, S) (or a modality stub's ``embeds``; an
    encoder-decoder's ``embeds`` feed its encoder), ``targets`` (B, S)
    with -1 ignored, optional ``positions`` ((3, B, S) for M-RoPE).  MoE
    layers take the capacity dispatch; their aux losses are summed over
    the layers and ``moe_loss`` of them joins the loss.  With
    ``cfg.runtime.remat == "block"`` each block runs under an activation
    checkpoint; with ``remat_groups`` G (dividing the repeats) the body
    also checkpoints each group of repeats / G repeats around its blocks'
    checkpoints (the reference's two-level remat).  Gradients reach the
    stacked body leaves through one ``unbind`` each.

    ``shards`` (a ``sharding.ctx.BatchShards``): ``batch`` is this rank's
    block of a batch cut over mesh axes; the MoE layers dispatch over the
    whole batch and their aux losses are this block's terms of the whole
    batch's (see ``mlp._moe_capacity``).  The cross-entropy stays the
    block's own mean.

    Returns (loss, metrics): ``nll``, ``tokens``, ``accuracy``, the MoE
    aux losses where the model has MoE layers, and ``loss``."""
    prologue, period, repeats = _layer_plan(cfg)
    x, B, S = _embed_in(params, cfg, batch)
    pos = batch.get("positions")
    pos = positions_for(cfg, B, S, device=x.device) if pos is None \
        else torch.as_tensor(pos).to(x.device)
    remat = cfg.runtime.remat == "block"
    enc_out = _encode(params, cfg, batch["embeds"].to(x.device), remat) \
        if cfg.is_encdec else None
    aux: Dict[str, torch.Tensor] = {}
    for blk, (_idx, kind, mlpk) in zip(params["prologue"], prologue):
        x, aux = _remat(remat, _block_train, blk, cfg, kind, mlpk, x, pos,
                        enc_out, aux, True, shards)

    if repeats:
        def repeat(blks, x, aux):
            for blk, (kind, mlpk) in zip(blks, period):
                x, aux = _block_train(blk, cfg, kind, mlpk, x, pos,
                                      enc_out, aux, shards=shards)
            return x, aux

        def group(layers, x, aux):
            for blks in layers:
                x, aux = _remat(remat, repeat, blks, x, aux)
            return x, aux

        if any(mk == "moe" for _, mk in period):
            aux = {**{k: torch.zeros((), device=x.device) for k in _MOE_AUX},
                   **aux}
        per_pos = [_unstack(t) for t in params["body"]]
        layers = [[pp[r] for pp in per_pos] for r in range(repeats)]
        G = cfg.runtime.remat_groups
        if remat and G and G > 1 and repeats % G == 0:
            k_in = repeats // G
            for g in range(G):
                x, aux = _remat(True, group, layers[g * k_in:(g + 1) * k_in],
                                x, aux)
        else:
            x, aux = group(layers, x, aux)

    logits = _logits(params, cfg, x)
    loss, metrics = cross_entropy(logits, torch.as_tensor(
        batch["targets"]).to(x.device))
    if cfg.moe is not None and "moe_lb_loss" in aux:
        loss = loss + mlp_mod.moe_loss(aux, cfg)
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Recurrent layers over a prompt
# ---------------------------------------------------------------------------


def _masked_state_scan(step_fn, cache, x: torch.Tensor,
                       length: Optional[int]):
    """Step a per-token state update over ``x`` (B, S, ...) —
    ``step_fn(cache, x_t) -> cache'`` — and return the state.  With
    ``length`` the state stops updating there: rows at ``t >= length``
    (bucket padding, a chunk's tail) leave it as it was, so the state
    equals an exact-length scan's."""
    for t in range(x.shape[1]):
        if length is not None and t >= int(length):
            break
        cache = step_fn(cache, x[:, t])
    return cache


# a recurrent layer over prompt rows from a state (zeros to start) AND its
# decode state after ``length`` of them, in one pass (the reference's
# ``_mamba_prefill`` / ``_scan_prefill`` run the layer, then step its decode
# over the prompt again; its chunked prefill steps the decode); one step
_PREFILL = {"mamba": ssm_mod.mamba_prefill,
            "mlstm": xlstm_mod.mlstm_prefill,
            "slstm": xlstm_mod.slstm_prefill}
_DECODE = {"mamba": ssm_mod.mamba_decode, "mlstm": xlstm_mod.mlstm_decode,
           "slstm": xlstm_mod.slstm_decode}


# ---------------------------------------------------------------------------
# Prefill: run the full prompt, build the decode cache
# ---------------------------------------------------------------------------


def prefill(params, cfg, batch: Dict[str, Any], max_len: int,
            ctx: DecodeCtx = LOCAL_CTX) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (last-position logits (B, V) f32, cache).

    ``batch``: ``{"tokens": (B, S)}`` or, for a decoder-only model fed by
    a modality stub, ``{"embeds": (B, S, d)}``; an encoder-decoder model
    takes its decoder ``tokens`` and its encoder's frame ``embeds``
    (B, S_enc, d).  ``batch["positions"]`` (optional) overrides the
    default position ids ((3, B, S) t/h/w streams for M-RoPE).

    ``batch["length"]`` (optional int) marks the prompt's true length when
    the row is right-padded to a BUCKET size: the logits come from
    position ``length - 1``, K/V cache rows past ``length`` are zeroed
    and recurrent states stop at ``length``, so one bucket serves every
    prompt length in it, token-identical to exact-length prefill.  The
    cache is ``{"prologue": [per layer], "body": [per period position,
    stacked on the repeat axis]}`` with the leaves of :func:`cache_defs`
    (the cross K/V at the encoder's own length).  Under a ``ctx`` with
    ``seq_axes`` the batch holds this rank's rows and the cache returned
    is this rank's block of their cache rows (:func:`shard_cache`)."""
    prologue, period, repeats = _layer_plan(cfg)
    x, B, S = _embed_in(params, cfg, batch)
    pos = batch.get("positions")
    if pos is None:
        pos = positions_for(cfg, B, S, device=x.device)
    else:
        pos = torch.as_tensor(pos).to(x.device)
    length = int(batch.get("length", S))
    mask_len = batch.get("length")       # None: no bucket padding
    enc_out = _encode(params, cfg, batch["embeds"].to(x.device)) \
        if cfg.is_encdec else None
    cross = _cross(cfg)

    def attn_prefill(blk, kind, h):
        if cfg.mla is not None:
            # mla_train and mla_prefill_cache share their latent rows
            p = blk["core"]
            q_nope, q_rope = attn._mla_q(p, cfg, h, pos)
            ckv, krope = attn.mla_latent(p, cfg, h, pos)
            y = attn.mla_attend(p, cfg, q_nope, q_rope, ckv, krope)
            return y, attn.mla_latent_cache(cfg, ckv, krope, max_len, length)
        q, k, v = attn._qkv(blk["core"], cfg, h, pos)
        window = cfg.window if kind == "attn_local" else None
        o = attn.blocked_attention(
            scale_like(q, 1.0 / math.sqrt(cfg.hd)), k, v, causal=True,
            window=window, attn_softcap=cfg.attn_softcap,
            block_kv=cfg.runtime.attn_block_kv)
        y = o.reshape(B, S, -1) @ blk["core"]["wo"]
        return y, attn.gqa_prefill_cache(cfg, k, v, max_len, length)

    def block_prefill(blk, kind, mlpk, x):
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        if kind.startswith("attn"):
            y, cache = attn_prefill(blk, kind, h)
            x = x + y
            if cross:
                hx = rms_norm(x, blk["ln_x"], cfg.norm_eps)
                ckv = attn.cross_kv(blk["cross"], cfg, enc_out)
                x = x + attn.gqa_train(blk["cross"], cfg, "attn", hx, pos,
                                       cross_kv=ckv)
                cache["cross_k"], cache["cross_v"] = ckv
        else:
            y, cache = _PREFILL[kind](blk["core"], cfg, h, length=mask_len)
            x = x + y
        return _apply_mlp(blk, cfg, mlpk, x), cache

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
                    for name in cs[0]} for cs in per_pos] \
        if repeats else []

    if "length" in batch:
        idx = min(max(length - 1, 0), S - 1)
        x_last = x[:, idx:idx + 1]
    else:
        x_last = x[:, -1:]
    logits_last = _logits(params, cfg, x_last)[:, 0]
    cache = {"prologue": caches_pro, "body": caches_body}
    if ctx.seq_axes:
        cache = shard_cache(cache, DecodeCtx(ctx.mesh, ctx.seq_axes))
    return logits_last, cache


# ---------------------------------------------------------------------------
# A rank's block of a decode cache
# ---------------------------------------------------------------------------


def cache_block_specs(cache: Dict[str, Any], ctx: DecodeCtx
                      ) -> Dict[str, Any]:
    """The spec of each leaf of a decode cache under ``ctx``: batch rows
    over ``ctx.batch_axes``; the rows of an attention layer's leaves (K/V
    or the latent rows and their pyramid levels) over ``ctx.seq_axes``, in
    the reference's order (``launch.steps.cache_specs``).  Cross K/V and
    recurrent states keep every head: cross-attention and the recurrences
    run on the rank's rows whole."""
    from repro_torch.sharding import partition as pt

    def one(layer, lead):
        if layer is None:
            return None
        seq = "k" in layer or "ckv" in layer
        out = {}
        for name, leaf in layer.items():
            sharded = seq and not name.startswith("cross_")
            entries = lead + (pt.axes_entry(ctx.batch_axes),) + (
                (pt.axes_entry(ctx.seq_axes),) if sharded else ())
            out[name] = entries + (None,) * (leaf.dim() - len(entries))
        return out
    return {"prologue": [one(c, ()) for c in cache["prologue"]],
            "body": [one(c, (None,)) for c in cache["body"]]}


def _map_cache(fn, cache, specs):
    return {part: [None if c is None else
                   {k: fn(v, sp[k]) for k, v in c.items()}
                   for c, sp in zip(cache[part], specs[part])]
            for part in ("prologue", "body")}


def shard_cache(cache: Dict[str, Any], ctx: DecodeCtx) -> Dict[str, Any]:
    """This rank's block of a whole decode cache (every batch row, every
    cache row): its batch rows by ``ctx.batch_axes`` and its cache rows by
    ``ctx.seq_axes`` (:func:`cache_block_specs`), as contiguous copies.
    A ``ctx`` without a mesh returns the cache as it is."""
    if ctx.mesh is None:
        return cache
    from repro_torch.sharding import partition as pt
    from repro_torch.sharding.ctx import mesh_coords
    coords = mesh_coords(ctx.mesh)
    return _map_cache(
        lambda t, spec: pt.local_block(t, spec, ctx.mesh,
                                       coords).contiguous(),
        cache, cache_block_specs(cache, ctx))


def unshard_cache(cache: Dict[str, Any], ctx: DecodeCtx) -> Dict[str, Any]:
    """The inverse of :func:`shard_cache`: the whole cache on every rank,
    gathered from every rank's block (an all-gather a leaf)."""
    if ctx.mesh is None:
        return cache
    from repro_torch.sharding.ctx import gather_block
    return _map_cache(lambda t, spec: gather_block(t, spec, ctx.mesh),
                      cache, cache_block_specs(cache, ctx))


# ---------------------------------------------------------------------------
# Chunked prefill: advance admission one fixed-size token chunk at a time
# ---------------------------------------------------------------------------


def prefill_chunk(params, cfg, batch: Dict[str, Any], cache: Dict[str, Any],
                  max_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One chunk of a chunked prefill (decoder-only models).

    batch: ``{"tokens": (B, C), "start": int, "length": int}`` — the chunk
    occupies global positions ``[start, start + C)``; rows at positions
    >= ``length`` are padding (last chunk only).  ``cache`` is the decode
    cache (:func:`init_decode_cache` to start).  Each attention layer
    writes the chunk's K/V into it at ``start``, padding rows zeroed
    first, and attends the chunk's queries over the whole cache with an
    offset causal mask: rows not yet written sit at later positions, so
    the mask alone keeps them out.  Each recurrent layer runs its one-pass
    prefill over the chunk from the state the cache holds, the state
    stopping at the chunk's last valid row.  The cache is updated IN PLACE and returned.  Only K/V are
    written: the pyramid leaves stay as they are (zeros from
    :func:`init_decode_cache`), as in the reference.

    MLA chunks write the latent rows (``ckv`` / ``krope``, the same
    zeroing) and attend non-absorbed over the whole latent cache, per-head
    K/V re-expanded as in whole-prompt prefill.

    Returns (logits (B, V) f32 at position ``min(length, start + C) - 1``,
    cache); the final chunk's logits give the prompt's first token."""
    if cfg.is_encdec:
        raise ValueError("chunked prefill drives decoder-only models; "
                         f"'{cfg.name}' is an encoder-decoder architecture")
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

    def mla_attn_chunk(blk, x, c):
        p = blk["core"]
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        q_nope, q_rope = attn._mla_q(p, cfg, h, pos)
        ckv, krope = attn.mla_latent(p, cfg, h, pos)
        c["ckv"][:, start:start + C] = torch.where(
            valid[..., 0], ckv, 0).to(c["ckv"].dtype)
        c["krope"][:, start:start + C] = torch.where(
            valid[..., 0], krope, 0).to(c["krope"].dtype)
        return x + attn.mla_attend(p, cfg, q_nope, q_rope, c["ckv"],
                                   c["krope"], q_offset=start)

    def attn_chunk(blk, kind, x, c):
        if cfg.mla is not None:
            return mla_attn_chunk(blk, x, c)
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(blk["core"], cfg, h, pos)
        c["k"][:, start:start + C] = torch.where(valid, k, 0).to(c["k"].dtype)
        c["v"][:, start:start + C] = torch.where(valid, v, 0).to(c["v"].dtype)
        window = cfg.window if kind == "attn_local" else None
        o = attn.blocked_attention(
            scale_like(q, 1.0 / math.sqrt(cfg.hd)), c["k"], c["v"],
            causal=True, window=window, attn_softcap=cfg.attn_softcap,
            block_kv=cfg.runtime.attn_block_kv, q_offset=start)
        return x + o.reshape(B, C, -1) @ blk["core"]["wo"]

    def other_chunk(blk, kind, x, c):
        """The layer over the chunk from the state the cache holds; the
        state stops at the chunk's last valid row (padding rows feed no
        valid row)."""
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        y, new = _PREFILL[kind](blk["core"], cfg, h,
                                length=min(C, length - start), state=c)
        _write_state(c, new)
        return x + y

    def block_chunk(blk, kind, mlpk, x, c):
        if kind.startswith("attn"):
            x = attn_chunk(blk, kind, x, c)
        else:
            x = other_chunk(blk, kind, x, c)
        return _apply_mlp(blk, cfg, mlpk, x)

    for blk, (_idx, kind, mlpk), c in zip(params["prologue"], prologue,
                                          cache["prologue"]):
        x = block_chunk(blk, kind, mlpk, x, c)
    for r in range(repeats):
        for pi, (kind, mlpk) in enumerate(period):
            c = {name: leaf[r] for name, leaf in cache["body"][pi].items()}
            x = block_chunk(body_block(params, pi, r), kind, mlpk, x, c)

    # last valid row of THIS chunk (earlier chunks' logits are discarded)
    idx = min(max(min(length, start + C) - 1 - start, 0), C - 1)
    return _logits(params, cfg, x[:, idx:idx + 1])[:, 0], cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def _block_decode(blk, cfg, kind: str, mlp_kind: str, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], length: int, *,
                  layer_idx: int, ctx: DecodeCtx,
                  impl=None) -> torch.Tensor:
    """One layer of one decode step; ``cache`` (the layer's leaves) is
    updated IN PLACE."""
    h = rms_norm(x, blk["ln1"], cfg.norm_eps)
    if kind.startswith("attn"):
        sub = {k: v for k, v in cache.items() if not k.startswith("cross_")}
        if cfg.mla is not None:
            y, _ = attn.mla_decode(blk["core"], cfg, kind, h, sub, length,
                                   layer_idx=layer_idx, ctx=ctx, impl=impl)
        else:
            y, _ = attn.gqa_decode(blk["core"], cfg, kind, h, sub, length,
                                   layer_idx=layer_idx, ctx=ctx, impl=impl)
    else:
        y, new = _DECODE[kind](blk["core"], cfg, h, cache)
        _write_state(cache, new)
    x = x + y
    if "cross" in blk and "cross_k" in cache:
        hx = rms_norm(x, blk["ln_x"], cfg.norm_eps)
        y, _ = attn.gqa_decode(blk["cross"], cfg, "attn", hx, {}, length,
                               layer_idx=layer_idx,
                               cross_kv_cache=(cache["cross_k"],
                                               cache["cross_v"]))
        x = x + y
    return _apply_mlp(blk, cfg, mlp_kind, x)


def decode_step(params, cfg, cache: Dict[str, Any], batch: Dict[str, Any],
                length: int, ctx: DecodeCtx = LOCAL_CTX, *, impl=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence.  batch: ``{"token": (B,)}`` or
    ``{"embeds": (B, 1, d)}``; length: the current cache fill (an int, one
    for the batch).  Every attention layer writes the token's row into
    ``cache`` IN PLACE (and folds its key into the pyramid on the sparse
    path) and attends sparse or dense as :func:`attention.gqa_decode`
    decides; an encoder-decoder's layers then attend densely over their
    cross K/V.  Every recurrent layer steps its state IN PLACE.  The
    prologue layers decode with their own index (the early budget), the
    body layers with index 10**6 (the standard budget), as in the
    reference.  ``impl="ref"`` runs the plain versions of kernels B1 and
    B2 on the card.  Under a ``ctx`` with ``seq_axes`` (a mesh) the batch
    and ``cache`` are this rank's rows and block (:func:`shard_cache`);
    each attention layer combines its shards' partial softmax over the
    mesh.  Returns (logits (B, V) f32, cache)."""
    prologue, period, repeats = _layer_plan(cfg)
    if "token" in batch:
        x = params["embed"][torch.as_tensor(batch["token"]).long().to(
            params["embed"].device)][:, None]
    else:
        x = batch["embeds"].to(params["embed"].dtype)
    length = int(length)
    for blk, (idx, kind, mlpk), c in zip(params["prologue"], prologue,
                                         cache["prologue"]):
        x = _block_decode(blk, cfg, kind, mlpk, x, c, length, layer_idx=idx,
                          ctx=ctx, impl=impl)
    for r in range(repeats):
        for pi, (kind, mlpk) in enumerate(period):
            c = {name: leaf[r] for name, leaf in cache["body"][pi].items()}
            x = _block_decode(body_block(params, pi, r), cfg, kind, mlpk, x,
                              c, length, layer_idx=10**6, ctx=ctx, impl=impl)
    return _logits(params, cfg, x)[:, 0], cache
