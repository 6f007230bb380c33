"""Plain PyTorch versions of the sparse_decode kernel (both contracts)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import sparse_attention as sa


def sparse_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ids: torch.Tensor, length, *, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pallas contract.  q: (B, Hkv, G, hd) scaled; k/v: (B, S, Hkv, hd);
    ids: (B, Hkv, nsel); length: scalar valid token count.

    Returns the partial-softmax triple (num, den, m):
      num (B, Hkv, G, hd) f32; den/m (B, Hkv, G).
    """
    B, Hkv, G, hd = q.shape
    S = k.shape[1]
    tok = ids.long()[..., None] * chunk + torch.arange(chunk, device=q.device)
    tok = tok.reshape(B, Hkv, -1)                           # (B,Hkv,T)
    tok_c = torch.clamp(tok, max=S - 1)
    kt = k.transpose(1, 2)                                  # (B,Hkv,S,hd)
    vt = v.transpose(1, 2)
    idx = tok_c[..., None].expand(B, Hkv, tok.shape[-1], hd)
    kg = torch.gather(kt, 2, idx).float()
    vg = torch.gather(vt, 2, idx).float()
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), kg)
    length = torch.as_tensor(length, device=q.device)
    valid = (tok < length) & (tok < S)
    s = torch.where(valid[:, :, None], s, sa.NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(valid[:, :, None], torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    den = e.sum(dim=-1)
    num = torch.einsum("bkgt,bktd->bkgd", e, vg)
    return num, den, m


BF16_MAX_ULPS = 2           # bar on max |diff|, in bf16 ulps of max|ref|
BF16_MAX_MISMATCH = 0.05    # bar on the fraction of elements that differ


def bf16_agreement(out: torch.Tensor, ref: torch.Tensor
                   ) -> Tuple[float, float, float]:
    """How a bf16 result agrees with its plain version: (max |diff|, its
    bar of ``BF16_MAX_ULPS`` bf16 ulps of max|ref|, the fraction of
    elements that differ at all).  Two results of the same cast points
    agree bitwise except where f32 sums taken in another order straddle a
    rounding boundary, so the fraction stays small; skipping one cast
    point (probabilities, K/V or 1/sqrt(hd) not rounded to bf16) moves
    40-60 % of the elements by under an ulp of max|ref|, which only the
    fraction shows.  Hold the fraction to ``BF16_MAX_MISMATCH``."""
    d = (out.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return (d.max().item(), BF16_MAX_ULPS * ulp,
            (d > 0).float().mean().item())


def model_scale(hd: int, dtype: torch.dtype) -> float:
    """1/sqrt(hd) rounded to the model dtype — the JAX reference multiplies
    by a weakly-typed Python float, which takes the array's dtype."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=dtype))


def _pooled_operands(q, pool_kv, slots, chunk_ids, lengths, k_new, v_new,
                     attn_softcap):
    """Scores (B, Hkv, G, T) f32, V (B, Hkv, T, hd) in q's dtype and the
    live-row mask (B, 1, 1, T) of the engine contract, T = nmax * chunk +
    1 (the new token's row last)."""
    B, H, hd = q.shape
    kv = pool_kv[slots.long()]                     # (B, nmax, 2, c, Hkv, hd)
    nmax = slots.shape[1]
    chunk, Hkv = pool_kv.shape[2], pool_kv.shape[3]
    G = H // Hkv
    cid = chunk_ids.long()
    pos = (cid[..., None] * chunk
           + torch.arange(chunk, device=q.device)).reshape(B, nmax * chunk)
    ok = (cid[..., None] >= 0).expand(B, nmax, chunk).reshape(B, -1) \
        & (pos < lengths.long()[:, None])
    valid = torch.cat([ok, torch.ones((B, 1), dtype=torch.bool,
                                      device=q.device)], dim=1)[:, None, None]
    kg = kv[:, :, 0].reshape(B, nmax * chunk, Hkv, hd)
    vg = kv[:, :, 1].reshape(B, nmax * chunk, Hkv, hd)
    kg = torch.cat([kg.to(q.dtype), k_new.reshape(B, 1, Hkv, hd).to(q.dtype)],
                   dim=1)
    vg = torch.cat([vg.to(q.dtype), v_new.reshape(B, 1, Hkv, hd).to(q.dtype)],
                   dim=1)
    qs = q * torch.tensor(model_scale(hd, q.dtype), dtype=q.dtype)
    scores = torch.einsum("bkgd,bksd->bkgs",
                          qs.reshape(B, Hkv, G, hd).float(),
                          kg.transpose(1, 2).float())
    if attn_softcap is not None:
        scores = attn_softcap * torch.tanh(scores / attn_softcap)
    return scores, vg.transpose(1, 2), valid


def sparse_decode_pooled_ref(q: torch.Tensor, pool_kv: torch.Tensor,
                             slots: torch.Tensor, chunk_ids: torch.Tensor,
                             lengths: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor,
                             attn_softcap: Optional[float] = None
                             ) -> torch.Tensor:
    """Engine contract (``repro.serving.engine._attend_pooled`` without
    the output projection).

    q: (B, H, hd) model dtype; pool_kv: (n_slots + 1, 2, chunk, Hkv, hd)
    store dtype; slots / chunk_ids: (B, nmax) (chunk id -1 on padding);
    lengths: (B,); k_new / v_new: (B, 1, Hkv, hd) or (B, Hkv, hd).  The
    mask is STRICT (pos < length): this round's token rides in k_new /
    v_new and is always attended.  Returns (B, H, hd) in q's dtype."""
    scores, v, valid = _pooled_operands(q, pool_kv, slots, chunk_ids,
                                        lengths, k_new, v_new, attn_softcap)
    part = sa._masked_softmax_partials(scores, v, valid)
    return sa._finish(part).to(q.dtype)


def workingset_slab(kg: torch.Tensor, vg: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A legacy working set as a pool slab: kg/vg (B, nmax, chunk, Hkv,
    hd) -> the (B * nmax, 2, chunk, Hkv, hd) slab whose row b * nmax + j
    holds entry j of sequence b, and the (B, nmax) int32 slots that name
    those rows."""
    B, nmax = kg.shape[:2]
    slab = torch.stack((kg, vg), dim=2).reshape(B * nmax, 2, *kg.shape[2:])
    slots = torch.arange(B * nmax, dtype=torch.int32,
                         device=kg.device).reshape(B, nmax)
    return slab, slots


def sparse_decode_workingset_ref(q: torch.Tensor, kg: torch.Tensor,
                                 vg: torch.Tensor, chunk_ids: torch.Tensor,
                                 lengths: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor,
                                 attn_softcap: Optional[float] = None
                                 ) -> torch.Tensor:
    """Legacy engine contract (``repro.serving.engine._attend_workingset``
    without the output projection): the round's padded working set kg/vg
    (B, nmax, chunk, Hkv, hd) in store dtype, entry j of sequence b holding
    chunk ``chunk_ids[b, j]`` (-1 on padding); otherwise as
    :func:`sparse_decode_pooled_ref`, which it is over the slab of
    :func:`workingset_slab`."""
    slab, slots = workingset_slab(kg, vg)
    return sparse_decode_pooled_ref(q, slab, slots, chunk_ids, lengths,
                                    k_new, v_new, attn_softcap)


def sparse_decode_pooled_split_ref(q: torch.Tensor, pool_kv: torch.Tensor,
                                   slots: torch.Tensor,
                                   chunk_ids: torch.Tensor,
                                   lengths: torch.Tensor, k_new: torch.Tensor,
                                   v_new: torch.Tensor,
                                   attn_softcap: Optional[float] = None, *,
                                   nsplit: int, chunks_per_split: int
                                   ) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch (used by the tests):
    rows split as ``ops.split_rows`` splits them, each split's maximum,
    the global maximum over the splits, per split p = exp(s - m) with p
    rounded to the model dtype for P.V, and the f32 num / den partials
    added in split order.  Same contract as
    :func:`sparse_decode_pooled_ref`."""
    scores, v, valid = _pooled_operands(q, pool_kv, slots, chunk_ids,
                                        lengths, k_new, v_new, attn_softcap)
    B, Hkv, G, T = scores.shape
    chunk = pool_kv.shape[2]
    sc = torch.where(valid, scores, sa.NEG_INF)
    spans = []
    for s in range(nsplit):
        lo = min(T - 1, s * chunks_per_split * chunk)
        hi = min(T - 1, (s + 1) * chunks_per_split * chunk)
        spans.append((lo, T if s == nsplit - 1 else hi))
    m = torch.stack([sc[..., lo:hi].amax(-1) for lo, hi in spans]).amax(0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = torch.zeros(B, Hkv, G, v.shape[-1], device=q.device)
    den = torch.zeros(B, Hkv, G, device=q.device)
    for lo, hi in spans:
        e = torch.exp(sc[..., lo:hi] - m_safe[..., None])
        e = torch.where(valid[..., lo:hi], e, torch.zeros_like(e))
        num = num + torch.einsum("bkgt,bktv->bkgv", e.to(v.dtype).float(),
                                 v[:, :, lo:hi].float())
        den = den + e.sum(-1)
    out = num / torch.where(den == 0, torch.ones_like(den), den)[..., None]
    return out.reshape(q.shape).to(q.dtype)
