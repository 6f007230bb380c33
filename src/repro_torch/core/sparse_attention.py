"""Partial-softmax building blocks of the sparse decode attention.

The plain side of kernel B2 (``repro_torch.kernels.sparse_decode``):
masked scores become a stable partial-softmax triple (num, den, m) and
:func:`_finish` normalizes it — the same arithmetic as
``repro.core.sparse_attention``.
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
