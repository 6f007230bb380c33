"""GQA and MLA attention, ported from ``repro.models.attention``: prefill,
the decode cache with its abstract pyramid, and the in-model LeoAM sparse
decode of ``lm.decode_step``.

``blocked_attention`` is plain PyTorch (the JAX package wrote it in jnp,
outside any Pallas kernel): query rows against KV blocks with an online
softmax in f32.  MLA (DeepSeek) prefill is the reference's non-absorbed
form: per-head K/V re-expanded from the latent ``ckv`` through ``wk_b`` /
``wv_b`` (:func:`mla_train`), with the latent decode cache
(``ckv``, ``krope``) beside it (:func:`mla_prefill_cache`).

The decode cache carries the abstract pyramid whenever
``cfg.leoam.enabled``: f32 ``kmax{l}`` / ``kmin{l}`` (GQA) or ``cmax{l}``,
``cmin{l}``, ``rmax{l}``, ``rmin{l}`` (MLA) per level.  :func:`gqa_decode`
and :func:`mla_decode` write the new token's row and fold it into the
pyramid IN PLACE, then attend: sparse (pyramid descent, then attention
over the selected chunks) at a cache of ``min_seq_for_sparse`` or more,
dense otherwise.  The GQA sparse path runs kernels B1 and B2 on a CUDA
tensor; the MLA decode runs the reference's split bound and latent
attention in torch ops (the reference computes both in jnp).

Decode-path distribution: under a :class:`DecodeCtx` with ``seq_axes``
each rank holds one block of the cache's rows (``lm.shard_cache``) and
runs the reference's shard-local function on it: the row write on the
owner shard only, chunk selection with the global sink/recent forcing,
attention over the shard's rows; only the O(B·H) partial-softmax combine
(``sparse_attention.combine_partials``) crosses shards.

Encoder-decoder stacks use :func:`gqa_train` for the encoder's non-causal
self-attention and the decoder's cross-attention over :func:`cross_kv`;
the cross-attention decode is dense over the static encoder K/V
(``gqa_decode(cross_kv_cache=...)``), as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import sparse_attention as sa
from repro_torch.core.abstracts import (Pyramid, build_pyramid, num_levels,
                                        update_pyramid)
from repro_torch.core.adaptive import pyramid_select_mla
from repro_torch.core.sparse_attention import NEG_INF
from repro_torch.models.common import rms_norm, rotate, scale_like
from repro_torch.models.params import ParamDef
from repro_torch.sharding import partition as pt


# ---------------------------------------------------------------------------
# Decode context: how decode shards the cache
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecodeCtx:
    """How decode shards the cache: the mesh (a ``DeviceMesh``), the axes
    its cache rows shard over and the axes its batch rows shard over (no
    mesh: local execution)."""
    mesh: Any = None
    seq_axes: Tuple[str, ...] = ()
    batch_axes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.seq_axes and self.mesh is None:
            raise ValueError(f"DecodeCtx(seq_axes={self.seq_axes!r}) needs "
                             f"the mesh they name, and mesh is None")

    @property
    def n_seq_shards(self) -> int:
        if self.mesh is None or not self.seq_axes:
            return 1
        return pt.mesh_extent(self.mesh, self.seq_axes)

    def seq_index(self) -> int:
        """This rank's shard of the cache rows: its linear coordinate over
        ``seq_axes`` in that order, the first axis major."""
        if not self.seq_axes:
            return 0
        from repro_torch.sharding.ctx import mesh_coords
        return pt.shard_index(self.seq_axes, self.mesh,
                              mesh_coords(self.mesh))


LOCAL_CTX = DecodeCtx()


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


# ---------------------------------------------------------------------------
# Cache definitions
# ---------------------------------------------------------------------------


def gqa_cache_defs(cfg, batch: int, max_len: int) -> Dict[str, ParamDef]:
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    defs = {
        "k": ParamDef((batch, max_len, Hkv, hd),
                      ("batch", "kv_seq", "kv", None), init="zeros"),
        "v": ParamDef((batch, max_len, Hkv, hd),
                      ("batch", "kv_seq", "kv", None), init="zeros"),
    }
    if cfg.leoam.enabled:
        nc0 = max_len // cfg.leoam.chunk_size
        for lvl in range(num_levels(nc0, cfg.leoam.pyramid_levels)):
            for nm in ("kmax", "kmin"):
                defs[f"{nm}{lvl}"] = ParamDef(
                    (batch, nc0 >> lvl, Hkv, hd),
                    ("batch", "kv_seq", "kv", None), init="zeros",
                    dtype="float32")
    return defs


def mla_cache_defs(cfg, batch: int, max_len: int) -> Dict[str, ParamDef]:
    m = cfg.mla
    defs = {
        "ckv": ParamDef((batch, max_len, m.kv_lora_rank),
                        ("batch", "kv_seq", None), init="zeros"),
        "krope": ParamDef((batch, max_len, m.qk_rope_head_dim),
                          ("batch", "kv_seq", None), init="zeros"),
    }
    if cfg.leoam.enabled:
        nc0 = max_len // cfg.leoam.chunk_size
        for lvl in range(num_levels(nc0, cfg.leoam.pyramid_levels)):
            for nm, dim in (("cmax", m.kv_lora_rank),
                            ("cmin", m.kv_lora_rank),
                            ("rmax", m.qk_rope_head_dim),
                            ("rmin", m.qk_rope_head_dim)):
                defs[f"{nm}{lvl}"] = ParamDef(
                    (batch, nc0 >> lvl, 1, dim),
                    ("batch", "kv_seq", None, None), init="zeros",
                    dtype="float32")
    return defs


def cache_defs(cfg, kind: str, batch: int, max_len: int):
    if not kind.startswith("attn"):
        return None
    if cfg.mla is not None:
        return mla_cache_defs(cfg, batch, max_len)
    return gqa_cache_defs(cfg, batch, max_len)


def _pyr_from_cache(cache: Dict[str, torch.Tensor], prefix: str = "k"
                    ) -> Pyramid:
    kmaxs, kmins, lvl = [], [], 0
    while f"{prefix}max{lvl}" in cache:
        kmaxs.append(cache[f"{prefix}max{lvl}"])
        kmins.append(cache[f"{prefix}min{lvl}"])
        lvl += 1
    return Pyramid(tuple(kmaxs), tuple(kmins))


def _pyramid_leaves(cfg, prefix_of, boxes, length
                    ) -> Dict[str, torch.Tensor]:
    """The pyramid leaves of a prefill cache: for each (box name, rows
    (B, S, Hkv, w)) in ``boxes``, its f32 (max, min) pyramid with rows at
    positions >= ``length`` as sentinels; ``prefix_of`` maps a box name to
    its (max, min) leaf prefixes."""
    out = {}
    if not cfg.leoam.enabled:
        return out
    for name, rows in boxes:
        pyr = build_pyramid(rows, cfg.leoam.chunk_size,
                            cfg.leoam.pyramid_levels, length=length)
        hi, lo = prefix_of[name]
        for lvl in range(pyr.levels):
            out[f"{hi}{lvl}"] = pyr.kmax[lvl]
            out[f"{lo}{lvl}"] = pyr.kmin[lvl]
    return out


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

    A key length that is not a multiple of ``block_kv`` ends in a shorter
    block (the reference asserts instead: its prefill cannot run an
    explicit bucket such as 1536 at its 1024-key blocks, ROADMAP C18);
    where the blocks divide the keys, the blocks and the arithmetic are
    the reference's.
    """
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // Hkv
    bkv = min(block_kv, Skv)
    nkv = -(-Skv // bkv)
    dev = q.device
    qf = q.float()
    q_pos = torch.arange(S, device=dev) + int(q_offset)
    num = torch.zeros((B, H, S, vd), dtype=torch.float32, device=dev)
    den = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)

    def heads(x):
        # each kv head repeated G times (repeat_interleave), as a broadcast:
        # its gradient is a sum over G, not an index_add_ with atomics
        x = x[:, :, :, None].expand(*x.shape[:3], G, x.shape[-1])
        return x.reshape(B, x.shape[1], H, x.shape[-1])

    for kj in range(nkv):
        kh = heads(k[:, kj * bkv:(kj + 1) * bkv])
        vh = heads(v[:, kj * bkv:(kj + 1) * bkv])
        n = kh.shape[1]                   # bkv, or the ragged last block
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kh.float())
        if attn_softcap is not None:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        k_pos = kj * bkv + torch.arange(n, device=dev)
        mask = torch.ones((S, n), dtype=torch.bool, device=dev)
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


def gqa_train(p, cfg, kind: str, x: torch.Tensor, pos,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (the encoder's, non-causal with
    ``causal=False``, or the decoder's cross-attention over ``cross_kv``:
    un-rotated queries, no mask).  x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    if cross_kv is not None:
        # keys are the encoder's un-rotated projections: no RoPE here
        q = (x @ p["wq"]).reshape(B, S, H, hd)
        k, v = cross_kv
        causal = False
    else:
        q, k, v = _qkv(p, cfg, x, pos)
    window = cfg.window if kind == "attn_local" else None
    out = blocked_attention(
        scale_like(q, 1.0 / math.sqrt(hd)), k, v, causal=causal,
        window=window, attn_softcap=cfg.attn_softcap,
        block_kv=cfg.runtime.attn_block_kv)
    return out.reshape(B, S, H * hd) @ p["wo"]


def cross_kv(p, cfg, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K/V for cross-attention (once per request):
    (B, S_enc, Hkv, hd) each."""
    B, S, _ = enc_out.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (enc_out @ p["wv"]).reshape(B, S, Hkv, hd)
    return k, v


def gqa_prefill_cache(cfg, k: torch.Tensor, v: torch.Tensor, max_len: int,
                      length) -> Dict[str, torch.Tensor]:
    """The decode cache after prefill: K/V padded to ``max_len``, with rows
    at positions >= ``length`` zeroed first (bucketed prefill pads the
    prompt, and the tier store ingests this cache — zeroing keeps stored
    chunks and their abstracts equal to exact-length prefill), and the
    abstract pyramid over the padded keys (f32, sentinels past
    ``length``) when ``cfg.leoam.enabled``."""
    B, S, Hkv, hd = k.shape
    valid = (torch.arange(S, device=k.device) < int(length))[None, :, None,
                                                               None]
    k = torch.where(valid, k, torch.zeros_like(k))
    v = torch.where(valid, v, torch.zeros_like(v))
    pad = max_len - S
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return {"k": kp, "v": vp,
            **_pyramid_leaves(cfg, {"k": ("kmax", "kmin")}, [("k", kp)],
                              length)}


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
    concat(ckv, krope) per token into its one-plane store), and the two
    abstract pyramids (``cmax``/``cmin`` over ckv, ``rmax``/``rmin`` over
    krope, one logical kv head) when ``cfg.leoam.enabled``."""
    ckv, krope = mla_latent(p, cfg, x, pos)
    return mla_latent_cache(cfg, ckv, krope, max_len, length)


def mla_latent_cache(cfg, ckv: torch.Tensor, krope: torch.Tensor,
                     max_len: int, length) -> Dict[str, torch.Tensor]:
    """:func:`mla_prefill_cache` from latent rows already computed."""
    S = ckv.shape[1]
    valid = (torch.arange(S, device=ckv.device) < int(length))[None, :, None]
    pad = max_len - S
    c = {name: torch.nn.functional.pad(
        torch.where(valid, t, torch.zeros_like(t)), (0, 0, 0, pad))
        for name, t in (("ckv", ckv), ("krope", krope))}
    c.update(_pyramid_leaves(
        cfg, {"c": ("cmax", "cmin"), "r": ("rmax", "rmin")},
        [("c", c["ckv"][:, :, None]), ("r", c["krope"][:, :, None])],
        length))
    return c


# ---------------------------------------------------------------------------
# Decode: one token, in place, sparse or dense
# ---------------------------------------------------------------------------


def _layer_budget(cfg, layer_idx: int, n_chunks: int,
                  n_seq_shards: int = 1) -> int:
    """Chunks a layer attends on a shard of ``n_chunks`` base chunks: the
    early rate for the first ``early_layers`` indices, ``importance_rate``
    otherwise (body layers decode with index 10**6, so every body layer
    takes the standard rate), plus the forced sink and recent chunks.
    With more than one sequence shard no shard hosts both the sink and the
    tail, so only max(sink, recent) slots are reserved."""
    lcfg = cfg.leoam
    rate = lcfg.early_rate if layer_idx < lcfg.early_layers \
        else lcfg.importance_rate
    if n_seq_shards > 1:
        forced = max(lcfg.sink_chunks, lcfg.recent_chunks)
    else:
        forced = lcfg.sink_chunks + lcfg.recent_chunks
    want = int(math.ceil(n_chunks * rate)) + forced
    return max(1, min(n_chunks, want))


def _use_sparse(cfg, kind: str, S_total: int) -> bool:
    return (cfg.leoam.enabled and kind != "attn_local"
            and S_total >= cfg.leoam.min_seq_for_sparse)


def _shard_place(ctx: DecodeCtx, S_l: int, length: int):
    """(shard index, whether this shard owns position ``length``, the
    row it takes there, the shard's valid rows after the write) for a
    shard of ``S_l`` rows."""
    idx = ctx.seq_index()
    owner = length // S_l == idx
    local_len = min(max(length + 1 - idx * S_l, 0), S_l)
    return idx, owner, length % S_l, local_len


def gqa_decode(p, cfg, kind: str, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], length: int, *,
               layer_idx: int, ctx: DecodeCtx = LOCAL_CTX,
               cross_kv_cache=None, impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x: (B, 1, d); length: the cache fill (an int), the
    position the new token takes.  Writes the token's K/V row (and, on
    the sparse path, folds its key into the pyramid) into ``cache`` IN
    PLACE; returns (out (B, 1, d), cache).  Under a ``ctx`` with
    ``seq_axes`` ``cache`` is this rank's block of rows (the whole cache
    has ``ctx.n_seq_shards`` times as many): the row is written on the
    shard that owns position ``length`` only, and the shards' partial
    softmax triples are combined over the mesh.

    With ``cross_kv_cache`` = (K, V) of the encoder (B, S_enc, Hkv, hd)
    it is the cross-attention: the un-rotated query attends densely over
    every encoder row, and nothing is written."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    if cross_kv_cache is not None:
        q = scale_like((x @ p["wq"]).reshape(B, H, hd), 1.0 / math.sqrt(hd))
        ck, cv = cross_kv_cache
        part = sa.dense_decode_gqa(q, ck, cv, length=ck.shape[1])
        out = sa._finish(part).to(x.dtype)
        return out.reshape(B, 1, H * hd) @ p["wo"], cache
    length = int(length)
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    if cfg.rope == "mrope":
        # at decode every M-RoPE stream takes the token's position
        pos = pos[None].expand(3, B, 1)
    q, k_new, v_new = _qkv(p, cfg, x, pos)
    q = scale_like(q[:, 0], 1.0 / math.sqrt(hd))             # (B, H, hd)
    k_new, v_new = k_new[:, 0], v_new[:, 0]                  # (B, Hkv, hd)

    S_l, n_sh = cache["k"].shape[1], ctx.n_seq_shards
    chunk = cfg.leoam.chunk_size
    use_sparse = _use_sparse(cfg, kind, S_l * n_sh)
    idx, owner, wpos, local_len = _shard_place(ctx, S_l, length)
    if owner:
        cache["k"][:, wpos] = k_new.to(cache["k"].dtype)
        cache["v"][:, wpos] = v_new.to(cache["v"].dtype)
    if use_sparse:
        pyr = _pyr_from_cache(cache)
        if owner:
            # the reference folds -inf (max) / +inf (min) on the other
            # shards: the identity
            update_pyramid(pyr, k_new, wpos, chunk)
        part = sa.leoam_decode_shard(
            q, cache["k"], cache["v"], pyr, chunk=chunk,
            budget=_layer_budget(cfg, layer_idx, S_l // chunk, n_sh),
            length=local_len, attn_softcap=cfg.attn_softcap,
            sink_chunks=cfg.leoam.sink_chunks,
            recent_chunks=cfg.leoam.recent_chunks,
            rf=cfg.leoam.refine_factor,
            n_valid_chunks=(length + chunk) // chunk,
            chunk_offset=idx * (S_l // chunk), impl=impl)
    else:
        part = sa.dense_decode_gqa(
            q, cache["k"], cache["v"], length=local_len,
            attn_softcap=cfg.attn_softcap,
            window=cfg.window if kind == "attn_local" else None,
            base_pos=idx * S_l, query_pos=length)
    out = sa.combine_partials(part, ctx.seq_axes, ctx.mesh)
    out = out.to(x.dtype).reshape(B, 1, H * hd)
    return out @ p["wo"], cache


def mla_decode(p, cfg, kind: str, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], length: int, *,
               layer_idx: int, ctx: DecodeCtx = LOCAL_CTX,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-MLA decode step: the query absorbs W_UK (latent space),
    the new latent row is written (and folded into both pyramids) IN
    PLACE, the latent attention runs sparse or dense, and W_UV and ``wo``
    project out.  Returns (out (B, 1, d), cache).  Sharded as
    :func:`gqa_decode` under a ``ctx`` with ``seq_axes``."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    length = int(length)
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos)
    q_lat = torch.einsum("bhd,hrd->bhr", q_nope[:, 0], p["wk_b"])
    scale = mla_scale(cfg)
    q_lat, q_rope = scale_like(q_lat, scale), scale_like(q_rope[:, 0], scale)
    ckv_new, krope_new = mla_latent(p, cfg, x, pos)
    ckv_new, krope_new = ckv_new[:, 0], krope_new[:, 0]

    S_l, n_sh = cache["ckv"].shape[1], ctx.n_seq_shards
    chunk = cfg.leoam.chunk_size
    use_sparse = (cfg.leoam.enabled
                  and S_l * n_sh >= cfg.leoam.min_seq_for_sparse)
    idx, owner, wpos, local_len = _shard_place(ctx, S_l, length)
    if owner:
        cache["ckv"][:, wpos] = ckv_new.to(cache["ckv"].dtype)
        cache["krope"][:, wpos] = krope_new.to(cache["krope"].dtype)
    if use_sparse:
        pc = _pyr_from_cache(cache, "c")
        pr = _pyr_from_cache(cache, "r")
        if owner:                  # the other shards' fold is the identity
            update_pyramid(pc, ckv_new[:, None], wpos, chunk)
            update_pyramid(pr, krope_new[:, None], wpos, chunk)
        ids = pyramid_select_mla(
            q_lat, q_rope, pc, pr,
            _layer_budget(cfg, layer_idx, S_l // chunk, n_sh),
            rf=cfg.leoam.refine_factor, sink_chunks=cfg.leoam.sink_chunks,
            recent_chunks=cfg.leoam.recent_chunks,
            n_valid0=(length + chunk) // chunk,
            chunk_offset=idx * (S_l // chunk))
        part = sa.sparse_decode_mla(q_lat, q_rope, cache["ckv"],
                                    cache["krope"], ids, chunk,
                                    length=local_len)
    else:
        part = sa.dense_decode_mla(q_lat, q_rope, cache["ckv"],
                                   cache["krope"], length=local_len)
    out_lat = sa.combine_partials(part, ctx.seq_axes, ctx.mesh)  # (B,H,r)
    out = torch.einsum("bhr,hrv->bhv", out_lat.float(),
                       p["wv_b"].float()).to(x.dtype)
    return out.reshape(B, 1, H * m.v_head_dim) @ p["wo"], cache
