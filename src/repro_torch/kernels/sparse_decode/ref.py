"""Plain PyTorch versions of the sparse_decode kernel (both contracts) and
of its latent (MLA) variant."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import sparse_attention as sa


def sparse_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ids: torch.Tensor, length, *, chunk: int,
                      attn_softcap: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pallas contract.  q: (B, Hkv, G, hd) scaled; k/v: (B, S, Hkv, hd);
    ids: (B, Hkv, nsel); length: scalar valid token count.

    Returns the partial-softmax triple (num, den, m):
      num (B, Hkv, G, hd) f32; den/m (B, Hkv, G).

    The model dtype TM is q's dtype when it is the cache's, else f32 (the
    Pallas kernel's case, where every rounding below is exact): each
    probability is rounded to TM before the P·V product, which
    accumulates in f32, and the denominator sums the unrounded values —
    ``repro.core.sparse_attention.sparse_decode_gqa``'s cast points, its
    q having been rounded to the cache dtype.  ``attn_softcap`` caps the
    f32 scores (``cap * tanh(s / cap)``) before the mask."""
    B, Hkv, G, hd = q.shape
    S = k.shape[1]
    tm = q.dtype if q.dtype == k.dtype else torch.float32
    tok = ids.long()[..., None] * chunk + torch.arange(chunk, device=q.device)
    tok = tok.reshape(B, Hkv, -1)                           # (B,Hkv,T)
    tok_c = torch.clamp(tok, max=S - 1)
    kt = k.transpose(1, 2)                                  # (B,Hkv,S,hd)
    vt = v.transpose(1, 2)
    idx = tok_c[..., None].expand(B, Hkv, tok.shape[-1], hd)
    kg = torch.gather(kt, 2, idx).float()
    vg = torch.gather(vt, 2, idx).float()
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), kg)
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    if isinstance(length, torch.Tensor):
        length = length.to(q.device)
    valid = (tok < length) & (tok < S)
    s = torch.where(valid[:, :, None], s, sa.NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(valid[:, :, None], torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    den = e.sum(dim=-1)
    num = torch.einsum("bkgt,bktd->bkgd", e.to(tm).float(), vg)
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


CONTRACT_FLIPS = 2          # bar on the contract entry's output, in
                            # probabilities rounded the other way
_ULP_AT_ONE = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
               torch.float16: 2.0 ** -11}


def contract_agreement(out: torch.Tensor, ref: torch.Tensor, v: torch.Tensor,
                       den: torch.Tensor, dtype: torch.dtype
                       ) -> Tuple[float, float]:
    """How the contract entry's output num/den agrees with its plain
    version's: (max |diff|, its bar).  At the model dtype ``dtype`` both
    round each probability p <= 1 to it for P.V; where their f32 scores
    differ in the last bits a p may round the other way, moving num by one
    ulp of ``dtype`` at 1 times a value of V.  The bar is
    ``CONTRACT_FLIPS`` such flips at max|v| over the smallest denominator
    ``den``, plus 1e-5 for f32 sums in another order."""
    d = (out.float() - ref.float()).abs().max().item()
    bar = (CONTRACT_FLIPS * _ULP_AT_ONE[dtype] * v.float().abs().max().item()
           / den.min().item() + 1e-5)
    return d, bar


def tied_contract_case(device, B: int = 2, Hkv: int = 4, G: int = 4,
                       hd: int = 128, S: int = 1024, chunk: int = 64,
                       nsel: int = 4, seed: int = 0):
    """Inputs (q, k, v, ids, length) of the contract entry at bf16 on which
    :func:`contract_agreement`'s bar sees whether P.V rounds each
    probability to bf16.  Column 0 of every key is 1, except one key of
    each (batch, kv head) — the first row of its first selected chunk —
    where it is 2; column 0 of every value is 1; the rest is in [-1, 1).
    q head h is delta_h at column 0 and 0 elsewhere, so its scores are
    delta_h exactly (2 delta_h at the one key), and every other
    probability is the one value p = exp(-delta_h) in [0.5, 1); delta_h (a
    bf16 multiple of 2^-7) puts p at least a quarter bf16 ulp from bf16
    and 0.05 ulp from a rounding midpoint.  Two versions that round p
    agree to f32 sums; one that leaves p unrounded moves out[..., 0] by
    2^-10 / p or more, against a bar of CONTRACT_FLIPS x 2^-8 / (N p + 1)
    + 1e-5 for the N = nsel x chunk live keys."""
    u = 2.0 ** -8
    deltas = [k / 128 for k in range(1, 89)
              if 0.05 <= abs((math.exp(-k / 128) / u) % 1.0 - 0.5) <= 0.25]
    H = Hkv * G
    if len(deltas) < H:
        raise ValueError(f"tied_contract_case: {len(deltas)} usable deltas "
                         f"for {H} heads")
    g = torch.Generator().manual_seed(seed)
    k = torch.rand(B, S, Hkv, hd, generator=g) * 2 - 1
    v = torch.rand(B, S, Hkv, hd, generator=g) * 2 - 1
    k[..., 0] = 1
    v[..., 0] = 1
    ids = torch.stack([torch.stack([
        torch.randperm(S // chunk, generator=g)[:nsel] for _ in range(Hkv)])
        for _ in range(B)])                                 # (B, Hkv, nsel)
    for b in range(B):
        for h in range(Hkv):
            k[b, int(ids[b, h, 0]) * chunk, h, 0] = 2
    q = torch.zeros(B, Hkv, G, hd)
    q[..., 0] = torch.tensor(deltas[:H]).reshape(Hkv, G)
    return (q.bfloat16().to(device), k.bfloat16().to(device),
            v.bfloat16().to(device), ids.int().to(device), S)


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


# ---------------------------------------------------------------------------
# The latent (MLA) variant
# ---------------------------------------------------------------------------


LATENT_FLIPS = 2            # bar on max |diff| of out_lat, in probabilities
                            # that round to fp16 the other way


def latent_agreement(out: torch.Tensor, ref: torch.Tensor, rows,
                     den: torch.Tensor) -> Tuple[float, float]:
    """How the latent kernel's out_lat agrees with its plain version: (max
    |diff|, its bar).  Both round each probability p = exp(s - max) to
    fp16 against the same global max; where their f32 scores differ in the
    last bits, a p may round the other way.  p = 1 (the max row) is exact,
    so a flipped p < 1 moves num by one fp16 ulp of p, at most 2^-11,
    times a row value, and out_lat by that over den (>= 1).  The bar is
    ``LATENT_FLIPS`` such flips at the largest row value (``rows``: a
    tensor or a tuple of them, the rows read) over the smallest
    denominator ``den`` (B, H), as :func:`latent_pooled_den` gives it."""
    d = (out.float() - ref.float()).abs().max().item()
    rows = rows if isinstance(rows, (tuple, list)) else (rows,)
    top = max(x.float().abs().max().item() for x in rows)
    return d, LATENT_FLIPS * 2.0 ** -11 * top / den.min().item()


def tied_latent_case(device, B: int = 2, H: int = 16, D: int = 576,
                     chunk: int = 64, nsel: int = 4, seed: int = 0):
    """Inputs (q, pool_kv, slots, chunk_ids, lengths, lat_new) of the
    pooled latent call on which :func:`latent_agreement`'s bar sees whether
    P.V rounds each probability to fp16.  Every pool row is 1 at column 0
    and in [-1, 1) elsewhere; the round's row is 2 at column 0 and 0
    elsewhere; head h's query is delta_h at column 0 and 0 elsewhere.  So
    a head's scores are delta_h exactly (the round's 2 delta_h), every
    probability is the one value p = exp(-delta_h) in [0.5, 1), and
    delta_h (a bf16 multiple of 2^-7) puts p at least a quarter fp16 ulp
    from fp16 and 0.05 ulp from a rounding midpoint: two versions that
    round p agree to f32 sums, and one that leaves p unrounded moves
    out_lat[..., 0] by 2^-13 / p or more, against a bar of LATENT_FLIPS x
    2^-11 x 2 / (N p + 1) for the N = nsel x chunk live rows."""
    u = 2.0 ** -11
    deltas = [k / 128 for k in range(1, 89)
              if 0.05 <= abs((math.exp(-k / 128) / u) % 1.0 - 0.5) <= 0.25]
    if len(deltas) < H:
        raise ValueError(f"tied_latent_case: {len(deltas)} usable deltas "
                         f"for {H} heads")
    g = torch.Generator().manual_seed(seed)
    pool = (torch.rand(B * nsel + 1, 1, chunk, 1, D, generator=g) * 2
            - 1).half()
    pool[..., 0] = 1
    q = torch.zeros(B, H, D)
    q[..., 0] = torch.tensor(deltas[:H])
    lat_new = torch.zeros(B, D)
    lat_new[:, 0] = 2
    slots = torch.randperm(B * nsel, generator=g).reshape(B, nsel)
    cids = torch.arange(nsel).repeat(B, 1)
    lengths = torch.full((B,), nsel * chunk)
    return (q.bfloat16().to(device), pool.to(device),
            slots.int().to(device), cids.int().to(device),
            lengths.int().to(device), lat_new.bfloat16().to(device))


def _latent_rows(pool_kv: torch.Tensor, slots: torch.Tensor,
                 chunk_ids: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered latent rows (B, nmax * chunk, D) in the pool's dtype
    and the live-row mask (B, nmax * chunk): chunk id >= 0 and the STRICT
    pos < length (this round's row rides in separately)."""
    lat = pool_kv[slots.long()][:, :, 0]           # (B, nmax, c, 1, D)
    B, nmax, chunk = lat.shape[:3]
    lat = lat.reshape(B, nmax * chunk, -1)
    cid = chunk_ids.long()
    pos = (cid[..., None] * chunk
           + torch.arange(chunk, device=lat.device)).reshape(B, -1)
    ok = (cid[..., None] >= 0).expand(B, nmax, chunk).reshape(B, -1) \
        & (pos < lengths.long()[:, None])
    return lat, ok


def sparse_decode_latent_pooled_ref(q: torch.Tensor, pool_kv: torch.Tensor,
                                    slots: torch.Tensor,
                                    chunk_ids: torch.Tensor,
                                    lengths: torch.Tensor,
                                    lat_new: torch.Tensor, r: int
                                    ) -> torch.Tensor:
    """Engine contract of the MLA round (``repro.serving.engine.
    _attend_pooled_mla`` up to its ``_finish``: before W_UV and ``wo``).

    q: (B, H, D) = concat(q_lat, q_rope), pre-scaled, model dtype;
    pool_kv: (n_slots + 1, 1, chunk, 1, D) store dtype (one latent plane);
    slots / chunk_ids: (B, nmax) (chunk id -1 on padding); lengths: (B,);
    lat_new: (B, D) or (B, 1, D), the round's latent row, rounded to the
    pool dtype before use; r: the value width (kv_lora_rank), the first r
    columns of each row.  Scores are q_lat.ckv + q_rope.krope in f32, the
    probabilities are rounded to the pool dtype for P.V, which accumulates
    in f32, and the denominator sums the unrounded values.  Returns the
    normalized out_lat (B, H, r) f32."""
    lat, ok = _latent_rows(pool_kv, slots, chunk_ids, lengths)
    return sa._finish(_latent_partials(q, lat, ok, lat_new, r))


def latent_pooled_den(q: torch.Tensor, pool_kv: torch.Tensor,
                      slots: torch.Tensor, chunk_ids: torch.Tensor,
                      lengths: torch.Tensor, lat_new: torch.Tensor, r: int
                      ) -> torch.Tensor:
    """The plain version's unrounded softmax denominators (B, H) f32 of
    :func:`sparse_decode_latent_pooled_ref` (same arguments): the divisor
    of out_lat that :func:`latent_agreement`'s bar needs."""
    lat, ok = _latent_rows(pool_kv, slots, chunk_ids, lengths)
    return _latent_partials(q, lat, ok, lat_new, r).den


def _latent_partials(q: torch.Tensor, lat: torch.Tensor, ok: torch.Tensor,
                     lat_new: torch.Tensor, r: int) -> sa.Partials:
    B = q.shape[0]
    lat = torch.cat([lat, lat_new.reshape(B, 1, -1).to(lat.dtype)], dim=1)
    valid = torch.cat([ok, torch.ones((B, 1), dtype=torch.bool,
                                      device=ok.device)], dim=1)
    ckv, krope = lat[..., :r], lat[..., r:]
    scores = (torch.einsum("bhr,bsr->bhs", q[..., :r].float(), ckv.float())
              + torch.einsum("bhr,bsr->bhs", q[..., r:].float(),
                             krope.float()))
    return sa._masked_softmax_partials(scores[:, None], ckv[:, None],
                                       valid[:, None, None])


def sparse_decode_latent_split_ref(q: torch.Tensor, pool_kv: torch.Tensor,
                                   slots: torch.Tensor,
                                   chunk_ids: torch.Tensor,
                                   lengths: torch.Tensor,
                                   lat_new: torch.Tensor, r: int, *,
                                   nsplit: int) -> torch.Tensor:
    """The latent CUDA kernel's arithmetic in plain PyTorch (used by the
    tests): the scores of every row (the new token's rounded to fp16) with
    an f32 q split as hi + lo TF32 terms (``cvt.rna``, as the kernel feeds
    the tensor cores; bf16 and fp16 q are exact in TF32); one global max
    over all live rows; each sequence's live rows in order (entries' live
    rows, then the new token's) cut into ``nsplit`` runs as
    ``ops.latent_split_rows`` cuts them, per run p = exp(s - max) summed
    unrounded into den and rounded to fp16 for P.V, num and den in f32;
    the runs' partials added in run order.  Same contract as
    :func:`sparse_decode_latent_pooled_ref`."""
    from repro_torch.kernels.pq.ref import tf32_round
    from repro_torch.kernels.sparse_decode.ops import latent_split_rows
    lat, ok = _latent_rows(pool_kv, slots, chunk_ids, lengths)
    B, S, D = lat.shape
    new = lat_new.reshape(B, D).to(lat.dtype)
    rows = torch.cat([lat, new[:, None]], dim=1).float()      # (B, T, D)
    if q.dtype == torch.float32:
        hi = tf32_round(q, "nearest")
        lo = tf32_round(q - hi, "nearest")
        sc = (torch.einsum("bhd,bsd->bhs", hi, rows)
              + torch.einsum("bhd,bsd->bhs", lo, rows))
    else:
        sc = torch.einsum("bhd,bsd->bhs", q.float(), rows)     # (B, H, T)
    valid = torch.cat([ok, torch.ones((B, 1), dtype=torch.bool,
                                      device=ok.device)], dim=1)
    out = torch.empty(B, q.shape[1], r, device=q.device)
    for b in range(B):
        live = valid[b].nonzero()[:, 0]          # entries' rows, new row last
        s_b, v_b = sc[b][:, live], rows[b, live, :r]
        e_all = torch.exp(s_b - s_b.amax(-1, keepdim=True))
        num = torch.zeros(q.shape[1], r, device=q.device)
        den = torch.zeros(q.shape[1], device=q.device)
        for lo_, hi_ in latent_split_rows(len(live), nsplit):
            e = e_all[:, lo_:hi_]
            num = num + e.to(lat.dtype).float() @ v_b[lo_:hi_]
            den = den + e.sum(-1)
        out[b] = num / torch.where(den == 0, torch.ones_like(den),
                                   den)[:, None]
    return out


def sparse_decode_latent_workingset_ref(q: torch.Tensor, latg: torch.Tensor,
                                        chunk_ids: torch.Tensor,
                                        lengths: torch.Tensor,
                                        lat_new: torch.Tensor, r: int
                                        ) -> torch.Tensor:
    """Legacy engine contract of the MLA round (``_attend_workingset_mla``
    up to its ``_finish``): the padded working set latg (B, nmax, chunk, 1,
    D) uploaded whole, entry j of sequence b holding chunk
    ``chunk_ids[b, j]``; otherwise as
    :func:`sparse_decode_latent_pooled_ref`, which it is over the slab of
    one chunk a row."""
    B, nmax = latg.shape[:2]
    slab = latg.reshape(B * nmax, 1, *latg.shape[2:])
    slots = torch.arange(B * nmax, dtype=torch.int32,
                         device=latg.device).reshape(B, nmax)
    return sparse_decode_latent_pooled_ref(q, slab, slots, chunk_ids,
                                           lengths, lat_new, r)
