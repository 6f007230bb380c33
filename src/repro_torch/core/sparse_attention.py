"""Partial-softmax building blocks of the sparse decode attention.

The plain side of kernel B2 (``repro_torch.kernels.sparse_decode``) and of
its latent variant: masked scores become a stable partial-softmax triple
(num, den, m) and :func:`_finish` normalizes it — the same arithmetic as
``repro.core.sparse_attention``, whose absorbed-MLA decode
:func:`sparse_decode_mla` is here too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = float("-inf")


class Partials(NamedTuple):
    num: torch.Tensor    # (B, H, vd) un-normalized weighted values
    den: torch.Tensor    # (B, H) softmax denominator (relative to m)
    m: torch.Tensor      # (B, H) running max logit


def _finish(p: Partials) -> torch.Tensor:
    den = torch.where(p.den == 0.0, torch.ones_like(p.den), p.den)
    return p.num / den[..., None]


def _masked_softmax_partials(scores: torch.Tensor, v: torch.Tensor,
                             mask: torch.Tensor) -> Partials:
    """scores: (B,Hkv,G,T) f32; v: (B,Hkv,T,vd); mask: (B,Hkv,1,T) bool.

    The probabilities are rounded to v's dtype before the P·V product,
    which accumulates in f32 — the cast points of the JAX reference."""
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)                                      # (B,Hkv,G)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m_safe[..., None])
    e = torch.where(mask, e, torch.zeros_like(e))
    den = e.sum(dim=-1)
    num = torch.einsum("bkgt,bktv->bkgv", e.to(v.dtype).float(), v.float())
    B, Hkv, G = m.shape
    return Partials(num.reshape(B, Hkv * G, -1), den.reshape(B, Hkv * G),
                    m.reshape(B, Hkv * G))


def gather_chunk_tokens(ids: torch.Tensor, chunk: int) -> torch.Tensor:
    """(..., k) chunk ids -> (..., k * chunk) token positions."""
    tok = ids.long()[..., None] * chunk + torch.arange(chunk,
                                                       device=ids.device)
    return tok.reshape(*ids.shape[:-1], -1)


def sparse_decode_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      ckv: torch.Tensor, krope: torch.Tensor,
                      ids: torch.Tensor, chunk: int, *, length) -> Partials:
    """Absorbed-MLA sparse decode in latent space.  q_lat: (B, H, r);
    q_rope: (B, H, rope); ckv: (B, S, r); krope: (B, S, rope); ids: (B, 1,
    nsel).  Returns Partials with num in latent space (B, H, r) — the
    caller applies W_UV afterwards."""
    S = ckv.shape[1]
    tok = gather_chunk_tokens(ids[:, 0], chunk)                  # (B, T)
    tok_c = torch.clamp(tok, max=S - 1)
    cg = torch.gather(ckv, 1, tok_c[..., None].expand(-1, -1, ckv.shape[-1]))
    rg = torch.gather(krope, 1,
                      tok_c[..., None].expand(-1, -1, krope.shape[-1]))
    scores = (torch.einsum("bhr,btr->bht", q_lat.float(), cg.float())
              + torch.einsum("bhr,btr->bht", q_rope.float(), rg.float()))
    len_b = torch.as_tensor(length, device=tok.device).reshape(-1, 1)
    valid = ((tok < len_b) & (tok < S))[:, None, :]               # (B,1,T)
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(scores - m_safe[..., None]),
                    torch.zeros_like(scores))
    num = torch.einsum("bht,btr->bhr", e, cg.float())
    return Partials(num, e.sum(dim=-1), m)
