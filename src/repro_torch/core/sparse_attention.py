"""LeoAM sparse decode attention, ported from ``repro.core.sparse_attention``.

The decode path of ``lm.decode_step``: score chunk abstracts → adaptive
(pyramid) selection → attention over the selected chunks.  Every function
returns the stable partial-softmax triple (num, den, m), which
:func:`_finish` normalizes; masked scores become the triple in
:func:`_masked_softmax_partials`, the plain side of kernel B2
(``repro_torch.kernels.sparse_decode``) and of its latent variant.

:func:`sparse_decode_gqa` runs kernel B2 through its Pallas-contract entry
on a CUDA tensor (the reference computes it in jnp); the dense and MLA
decodes stay torch ops, as the reference's are jnp.  The triples compose
across sequence shards: :func:`combine_partials` merges them over mesh
axes, the sequence-parallel decode of every decode shape on a mesh.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.abstracts import Pyramid
from repro_torch.core.adaptive import flat_select_gqa, pyramid_select_gqa
from repro_torch.sharding import ctx as shard_ctx

NEG_INF = float("-inf")


class Partials(NamedTuple):
    num: torch.Tensor    # (B, H, vd) un-normalized weighted values
    den: torch.Tensor    # (B, H) softmax denominator (relative to m)
    m: torch.Tensor      # (B, H) running max logit


def _finish(p: Partials) -> torch.Tensor:
    den = torch.where(p.den == 0.0, torch.ones_like(p.den), p.den)
    return p.num / den[..., None]


def _lens(length, device, ndim: int):
    """A length as a mask operand: a Python int as it is (no copy to the
    device, so no wait for the stream), a tensor or array as (-1, 1, ...)
    with ``ndim`` dims."""
    if isinstance(length, int):
        return length
    return torch.as_tensor(length, device=device).reshape(-1,
                                                          *[1] * (ndim - 1))


def combine_partials(p: Partials, axes: Sequence[str], mesh=None
                     ) -> torch.Tensor:
    """Merge per-shard partial softmax over the ``axes`` of ``mesh`` (a
    ``DeviceMesh``); with no axes, the local normalization :func:`_finish`.

    ``m`` is max-reduced over each axis in turn; each shard weights its
    ``num`` and ``den`` by ``exp(m - gm)`` (0 where its ``m`` is not
    finite: a shard that holds no valid token) and both are sum-reduced.
    Over one rank the weight is ``exp(0) = 1`` and the result is
    :func:`_finish`'s bit for bit."""
    if not axes:
        return _finish(p)
    if mesh is None:
        raise ValueError(f"combine_partials over mesh axes {tuple(axes)} "
                         f"needs the mesh, and none was given")
    gm = shard_ctx.all_reduce(p.m, mesh, axes, "max")
    gm_safe = torch.where(torch.isfinite(gm), gm, torch.zeros_like(gm))
    w = torch.where(torch.isfinite(p.m), torch.exp(p.m - gm_safe),
                    torch.zeros_like(p.m))
    num = p.num * w[..., None]
    den = p.den * w
    both = shard_ctx.all_reduce(torch.cat([num.reshape(-1),
                                           den.reshape(-1)]),
                                mesh, axes, "sum")
    num = both[:num.numel()].reshape(num.shape)
    den = both[num.numel():].reshape(den.shape)
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return num / den[..., None]


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
    valid = ((tok < _lens(length, tok.device, 2))
             & (tok < S))[:, None, :]                             # (B,1,T)
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(scores - m_safe[..., None]),
                    torch.zeros_like(scores))
    num = torch.einsum("bht,btr->bhr", e, cg.float())
    return Partials(num, e.sum(dim=-1), m)


def sparse_decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ids: torch.Tensor, chunk: int, *, length,
                      attn_softcap: Optional[float] = None,
                      impl: Optional[str] = None) -> Partials:
    """Attention over selected chunks.

    q: (B, H, hd) scaled and roped; k/v: (B, S, Hkv, hd); ids: (B, Hkv,
    nsel) base-chunk ids; length: the valid token count (an int).  q is
    rounded to the cache dtype before the product, the scores accumulate
    in f32 and the probabilities are rounded to the cache dtype for P·V
    (the reference's cast points).  Kernel B2 on a CUDA tensor; the
    wrapper's plain version on the CPU or with ``impl="ref"``."""
    from repro_torch.kernels.sparse_decode import ops as b2
    B, H, hd = q.shape
    Hkv = k.shape[2]
    q4 = q.reshape(B, Hkv, H // Hkv, hd).to(k.dtype)
    num, den, m = b2.sparse_decode(q4, k, v, ids, length, chunk=chunk,
                                   attn_softcap=attn_softcap, impl=impl)
    return Partials(num.reshape(B, H, hd), den.reshape(B, H),
                    m.reshape(B, H))


def dense_decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length, attn_softcap: Optional[float] = None,
                     window: Optional[int] = None, base_pos: int = 0,
                     query_pos=None) -> Partials:
    """Full (or sliding-window) decode attention over a local KV shard (q
    and K in f32, probabilities rounded to v's dtype for P·V).  ``length``
    counts the shard's valid rows; ``base_pos`` is the shard's first global
    position, which the window compares with ``query_pos``."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                          k.transpose(1, 2).float())
    if attn_softcap is not None:
        scores = attn_softcap * torch.tanh(scores / attn_softcap)
    local_pos = torch.arange(S, device=q.device)[None, None, :]
    valid = local_pos < _lens(length, q.device, 3)
    if window is not None:
        qp = _lens(query_pos if query_pos is not None else length, q.device,
                   3)
        valid = valid & ((local_pos + base_pos) > (qp - window))
    return _masked_softmax_partials(scores, v.transpose(1, 2), valid)


def dense_decode_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv: torch.Tensor, krope: torch.Tensor, *,
                     length) -> Partials:
    """Absorbed-MLA decode over the whole latent cache (f32)."""
    S = ckv.shape[1]
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
              + torch.einsum("bhr,bsr->bhs", q_rope.float(), krope.float()))
    valid = (torch.arange(S, device=ckv.device)[None, :]
             < _lens(length, ckv.device, 2))
    valid = valid[:, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(scores - m_safe[..., None]),
                    torch.zeros_like(scores))
    num = torch.einsum("bhs,bsr->bhr", e, ckv.float())
    return Partials(num, e.sum(dim=-1), m)


# ---------------------------------------------------------------------------
# High-level entry: select + attend
# ---------------------------------------------------------------------------


def leoam_decode_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pyr: Pyramid, *, chunk: int, budget: int, length,
                       attn_softcap: Optional[float] = None,
                       sink_chunks: int = 1, recent_chunks: int = 2,
                       rf: int = 2, n_valid_chunks=None,
                       chunk_offset: int = 0,
                       impl: Optional[str] = None) -> Partials:
    """One shard's worth of LeoAM decode: pyramid-select (a one-level
    pyramid: score every base chunk), then attend.  ``n_valid_chunks`` /
    ``chunk_offset`` are global base-chunk coordinates (sink/recent
    forcing is global under sequence sharding); ``length`` counts the
    shard's valid rows."""
    n_valid = n_valid_chunks if n_valid_chunks is not None \
        else pyr.base_chunks
    if pyr.levels > 1:
        ids = pyramid_select_gqa(q, pyr, budget, rf=rf,
                                 sink_chunks=sink_chunks,
                                 recent_chunks=recent_chunks,
                                 n_valid0=n_valid,
                                 chunk_offset=chunk_offset, impl=impl)
    else:
        ids = flat_select_gqa(q, pyr.kmax[0], pyr.kmin[0], budget,
                              sink_chunks=sink_chunks,
                              recent_chunks=recent_chunks, n_valid0=n_valid,
                              chunk_offset=chunk_offset, impl=impl)
    return sparse_decode_gqa(q, k, v, ids, chunk, length=length,
                             attn_softcap=attn_softcap, impl=impl)


def decode_budget_chunks(seq_len: int, chunk: int, rate: float,
                         sink_chunks: int, recent_chunks: int) -> int:
    nc = seq_len // chunk
    return max(1, min(nc, int(math.ceil(nc * rate)) + sink_chunks
                      + recent_chunks))
