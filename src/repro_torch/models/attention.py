"""GQA and MLA attention for prefill, ported from
``repro.models.attention``.

``blocked_attention`` is plain PyTorch (the JAX package wrote it in jnp,
outside any Pallas kernel): query rows against KV blocks with an online
softmax in f32.  MLA (DeepSeek) prefill is the reference's non-absorbed
form: per-head K/V re-expanded from the latent ``ckv`` through ``wk_b`` /
``wv_b`` (:func:`mla_train`), with the latent decode cache
(``ckv``, ``krope``) beside it (:func:`mla_prefill_cache`).  Decode
attention runs in the serving engine through kernel B2 (GQA) or its latent
variant (MLA, absorbed).  The in-model sparse decode with its abstract
pyramid is a later slice (ROADMAP A2).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.sparse_attention import NEG_INF
from repro_torch.models.common import rms_norm, rotate, scale_like
from repro_torch.models.params import ParamDef


def gqa_params(cfg) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": ParamDef((d, H * hd), ("embed", "heads")),
        "wk": ParamDef((d, Hkv * hd), ("embed", "kv")),
        "wv": ParamDef((d, Hkv * hd), ("embed", "kv")),
        "wo": ParamDef((H * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((hd,), (None,), init="ones")
        p["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return p


def mla_params(cfg) -> Dict[str, ParamDef]:
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    p = {
        "wkv_a": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones"),
        "wk_b": ParamDef((H, m.kv_lora_rank, m.qk_nope_head_dim),
                         ("heads", None, None)),
        "wv_b": ParamDef((H, m.kv_lora_rank, m.v_head_dim),
                         ("heads", None, None)),
        "wo": ParamDef((H * m.v_head_dim, d), ("heads", "embed")),
    }
    if m.q_lora_rank:
        p["wq_a"] = ParamDef((d, m.q_lora_rank), ("embed", None))
        p["q_norm_a"] = ParamDef((m.q_lora_rank,), (None,), init="ones")
        p["wq_b"] = ParamDef((m.q_lora_rank, H * qk), (None, "heads"))
    else:
        p["wq"] = ParamDef((d, H * qk), ("embed", "heads"))
    return p


def attn_params(cfg) -> Dict[str, ParamDef]:
    return mla_params(cfg) if cfg.mla is not None else gqa_params(cfg)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      attn_softcap: Optional[float] = None,
                      block_kv: int = 1024, q_offset: int = 0
                      ) -> torch.Tensor:
    """Flash-style attention: full query rows × KV blocks.

    q: (B, S, H, hd) pre-scaled; k/v: (B, Skv, Hkv, hd).  KV blocks are
    expanded to H heads per block; scores and the P·V product run in f32.
    ``q_offset`` places the query rows at global positions ``q_offset +
    [0, S)`` against the keys' absolute positions: a prefill chunk attends
    over the whole decode cache, and the causal mask alone keeps rows not
    yet written out of every valid query row.  Returns (B, S, H, vd) in
    q's dtype.
    """
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // Hkv
    bkv = min(block_kv, Skv)
    nkv = Skv // bkv
    assert Skv % bkv == 0, (Skv, bkv)
    dev = q.device
    qf = q.float()
    q_pos = torch.arange(S, device=dev) + int(q_offset)
    num = torch.zeros((B, H, S, vd), dtype=torch.float32, device=dev)
    den = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    for kj in range(nkv):
        kh = k[:, kj * bkv:(kj + 1) * bkv].repeat_interleave(G, dim=2)
        vh = v[:, kj * bkv:(kj + 1) * bkv].repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kh.float())
        if attn_softcap is not None:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        k_pos = kj * bkv + torch.arange(bkv, device=dev)
        mask = torch.ones((S, bkv), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= k_pos[None, :] > (q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        scale_old = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                torch.zeros_like(m))
        e = torch.exp(s - m_safe[..., None])
        e = torch.where(mask, e, torch.zeros_like(e))
        num = num * scale_old[..., None] + torch.einsum(
            "bhqk,bkhv->bhqv", e, vh.float())
        den = den * scale_old + e.sum(dim=-1)
        m = m_new
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    out = (num / den[..., None]).transpose(1, 2)        # (B, S, H, vd)
    return out.to(q.dtype)


def _qkv(p, cfg, x: torch.Tensor, pos
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotate(cfg, q, pos)
    k = rotate(cfg, k, pos)
    return q, k, v


def gqa_prefill_cache(cfg, k: torch.Tensor, v: torch.Tensor, max_len: int,
                      length) -> Dict[str, torch.Tensor]:
    """The decode cache after prefill: K/V padded to ``max_len``, with rows
    at positions >= ``length`` zeroed first (bucketed prefill pads the
    prompt, and the tier store ingests this cache — zeroing keeps stored
    chunks and their abstracts equal to exact-length prefill).  The
    abstract pyramid of the JAX cache is left out: the serving engine never
    reads it."""
    B, S, Hkv, hd = k.shape
    valid = (torch.arange(S, device=k.device) < int(length))[None, :, None,
                                                               None]
    k = torch.where(valid, k, torch.zeros_like(k))
    v = torch.where(valid, v, torch.zeros_like(v))
    pad = max_len - S
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return {"k": kp, "v": vp}


# ---------------------------------------------------------------------------
# MLA (DeepSeek): the latent cache and non-absorbed prefill attention
# ---------------------------------------------------------------------------


def mla_scale(cfg) -> float:
    """1/sqrt(qk_nope + qk_rope), the MLA softmax scale."""
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _mla_q(p, cfg, x: torch.Tensor, pos
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope) rotated)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        qa = rms_norm(x @ p["wq_a"], p["q_norm_a"], cfg.norm_eps)
        q = (qa @ p["wq_b"]).reshape(B, S, H, qk)
    else:
        q = (x @ p["wq"]).reshape(B, S, H, qk)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rotate(cfg, q[..., m.qk_nope_head_dim:], pos)
    return q_nope, q_rope


def mla_latent(p, cfg, x: torch.Tensor, pos
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tokens' latent cache rows: (ckv (B, S, r) normed, krope (B, S,
    rope) rotated), in the model dtype."""
    m = cfg.mla
    kv_a = x @ p["wkv_a"]
    ckv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    krope = rotate(cfg, kv_a[..., None, m.kv_lora_rank:], pos)[:, :, 0]
    return ckv, krope


def mla_attend(p, cfg, q_nope: torch.Tensor, q_rope: torch.Tensor,
               ckv: torch.Tensor, krope: torch.Tensor, *,
               q_offset: int = 0) -> torch.Tensor:
    """Non-absorbed MLA attention of the query rows over the latent rows
    ``ckv`` (B, Skv, r) / ``krope`` (B, Skv, rope): per-head K/V expanded
    through ``wk_b`` / ``wv_b`` (the reference's contraction order), causal
    at ``q_offset``, then the output projection.  Returns (B, S, d)."""
    m = cfg.mla
    B, S, H, _ = q_nope.shape
    Skv = ckv.shape[1]
    k_nope = torch.einsum("bsr,hrd->bshd", ckv, p["wk_b"])
    val = torch.einsum("bsr,hrd->bshd", ckv, p["wv_b"])
    k = torch.cat([k_nope, krope[:, :, None].expand(
        B, Skv, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = blocked_attention(scale_like(q, mla_scale(cfg)), k, val, causal=True,
                          block_kv=cfg.runtime.attn_block_kv,
                          q_offset=q_offset)
    return o.reshape(B, S, H * m.v_head_dim) @ p["wo"]


def mla_train(p, cfg, x: torch.Tensor, pos) -> torch.Tensor:
    """Non-absorbed MLA over the prompt (whole-prompt prefill)."""
    q_nope, q_rope = _mla_q(p, cfg, x, pos)
    ckv, krope = mla_latent(p, cfg, x, pos)
    return mla_attend(p, cfg, q_nope, q_rope, ckv, krope)


def mla_prefill_cache(p, cfg, x: torch.Tensor, pos, max_len: int,
                      length) -> Dict[str, torch.Tensor]:
    """The latent decode cache after prefill: ``ckv`` (B, max_len, r) and
    ``krope`` (B, max_len, rope), rows at positions >= ``length`` zeroed
    before the pad, as :func:`gqa_prefill_cache` does (the engine ingests
    concat(ckv, krope) per token into its one-plane store).  The abstract
    pyramid is left out, as for GQA."""
    ckv, krope = mla_latent(p, cfg, x, pos)
    return mla_latent_cache(ckv, krope, max_len, length)


def mla_latent_cache(ckv: torch.Tensor, krope: torch.Tensor, max_len: int,
                     length) -> Dict[str, torch.Tensor]:
    """:func:`mla_prefill_cache` from latent rows already computed."""
    S = ckv.shape[1]
    valid = (torch.arange(S, device=ckv.device) < int(length))[None, :, None]
    pad = max_len - S
    return {name: torch.nn.functional.pad(
        torch.where(valid, t, torch.zeros_like(t)), (0, 0, 0, pad))
        for name, t in (("ckv", ckv), ("krope", krope))}
