"""GQA attention for prefill, ported from ``repro.models.attention``.

``blocked_attention`` is plain PyTorch (the JAX package wrote it in jnp,
outside any Pallas kernel): query rows against KV blocks with an online
softmax in f32.  Decode attention runs in the serving engine through
kernel B2.  MLA (DeepSeek) and the in-model sparse decode with its
abstract pyramid are later slices (ROADMAP A7, A2).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.sparse_attention import NEG_INF
from repro_torch.models.common import rms_norm, rotate
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
