"""The port's LeoAM sparse decode attention
(``repro_torch.core.sparse_attention``), ported from
``tests/test_sparse_attention.py``: exactness at full budget, the length
and window masks, fidelity on skewed caches, the partial-softmax merge —
each also held against ``repro.core.sparse_attention`` on the same numpy
inputs (f32: 1e-5; a bf16 cache with gemma2's softcap: 1e-5 relative to
max|out|, the two frameworks round q and the probabilities to bf16 at the
same points)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abstracts as jabs
from repro.core import sparse_attention as jsa
from repro_torch.core.abstracts import build_pyramid
from repro_torch.core.sparse_attention import (_finish, combine_partials,
                                               decode_budget_chunks,
                                               dense_decode_gqa,
                                               dense_decode_mla,
                                               leoam_decode_shard,
                                               sparse_decode_gqa,
                                               sparse_decode_mla)

T = torch.from_numpy


def make_cache(rng, B, S, Hkv, hd, scale=1.0):
    k = rng.randn(B, S, Hkv, hd).astype(np.float32) * scale
    v = rng.randn(B, S, Hkv, hd).astype(np.float32)
    return k, v


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_full_budget_equals_dense(rng):
    B, S, H, Hkv, hd, chunk = 2, 256, 8, 4, 32, 16
    k, v = make_cache(rng, B, S, Hkv, hd)
    q = rng.randn(B, H, hd).astype(np.float32) / np.sqrt(hd)
    nc = S // chunk
    ids = np.broadcast_to(np.arange(nc, dtype=np.int32), (B, Hkv, nc))
    ps = sparse_decode_gqa(T(q), T(k), T(v), T(ids.copy()), chunk, length=S)
    pd = dense_decode_gqa(T(q), T(k), T(v), length=S)
    _close(_finish(ps), _finish(pd))
    jps = jsa.sparse_decode_gqa(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(ids), chunk,
                                length=S)
    for t, j in zip(ps, jps):
        _close(t, j)


def test_partial_length_masking(rng):
    B, S, H, Hkv, hd, chunk = 1, 128, 4, 2, 16, 16
    k, v = make_cache(rng, B, S, Hkv, hd)
    q = rng.randn(B, H, hd).astype(np.float32)
    length = 75  # mid-chunk
    nc = S // chunk
    ids = np.broadcast_to(np.arange(nc, dtype=np.int32), (B, Hkv, nc)).copy()
    ps = sparse_decode_gqa(T(q), T(k), T(v), T(ids), chunk, length=length)
    pd = dense_decode_gqa(T(q), T(k), T(v), length=length)
    _close(_finish(ps), _finish(pd))
    _close(_finish(pd), jsa._finish(jsa.dense_decode_gqa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length=length)))


def test_skewed_cache_fidelity(rng):
    """<=1% output error at 25% chunk budget when attention is
    concentrated; the pyramid path's output is the reference's."""
    B, S, H, Hkv, hd, chunk = 2, 512, 8, 4, 32, 16
    G = H // Hkv
    q = rng.randn(B, H, hd).astype(np.float32) / np.sqrt(hd)
    k = rng.randn(B, S, Hkv, hd).astype(np.float32) * 0.3
    v = rng.randn(B, S, Hkv, hd).astype(np.float32)
    qg = q.reshape(B, Hkv, G, hd).mean(2)
    for b in range(B):
        for h in range(Hkv):
            for c in np.random.RandomState(b * 7 + h).choice(S // chunk, 3,
                                                             replace=False):
                k[b, c * chunk:(c + 1) * chunk, h] += (
                    3.0 * qg[b, h] / np.linalg.norm(qg[b, h]) * np.sqrt(hd))
    ps = leoam_decode_shard(T(q), T(k), T(v), build_pyramid(T(k), chunk, 3),
                            chunk=chunk, budget=8, length=S)
    pd = dense_decode_gqa(T(q), T(k), T(v), length=S)
    err = float(torch.linalg.norm(_finish(ps) - _finish(pd))
                / torch.linalg.norm(_finish(pd)))
    assert err < 0.01, err
    jps = jsa.leoam_decode_shard(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jabs.build_pyramid(jnp.asarray(k), chunk, 3), chunk=chunk, budget=8,
        length=S)
    _close(_finish(ps), jsa._finish(jps))
    # a one-level pyramid takes the flat selection (every base chunk)
    ps_flat = leoam_decode_shard(T(q), T(k), T(v),
                                 build_pyramid(T(k), chunk, 1), chunk=chunk,
                                 budget=8, length=S)
    _close(_finish(ps_flat), jsa._finish(jsa.leoam_decode_shard(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jabs.build_pyramid(jnp.asarray(k), chunk, 1), chunk=chunk, budget=8,
        length=S)))


def test_manual_shard_combine_equals_dense(rng):
    """Partial-softmax triples from sequence shards merge exactly (the
    local combine is ``_finish``)."""
    B, S, H, Hkv, hd = 2, 128, 4, 2, 16
    k, v = make_cache(rng, B, S, Hkv, hd)
    q = T(rng.randn(B, H, hd).astype(np.float32))
    k, v = T(k), T(v)
    n_shards = 4
    Sl = S // n_shards
    parts = [dense_decode_gqa(q, k[:, i * Sl:(i + 1) * Sl],
                              v[:, i * Sl:(i + 1) * Sl], length=Sl)
             for i in range(n_shards)]
    gm = torch.stack([p.m for p in parts]).amax(0)
    num = sum(p.num * torch.exp(p.m - gm)[..., None] for p in parts)
    den = sum(p.den * torch.exp(p.m - gm) for p in parts)
    pd = dense_decode_gqa(q, k, v, length=S)
    torch.testing.assert_close(num / den[..., None], _finish(pd), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(combine_partials(pd, ()), _finish(pd))


def test_mla_latent_decode_matches_dense(rng):
    B, S, H, r, rr, chunk = 2, 256, 4, 32, 8, 16
    q_lat = rng.randn(B, H, r).astype(np.float32) / np.sqrt(r)
    q_rope = rng.randn(B, H, rr).astype(np.float32)
    ckv = rng.randn(B, S, r).astype(np.float32)
    krope = rng.randn(B, S, rr).astype(np.float32)
    nc = S // chunk
    ids = np.broadcast_to(np.arange(nc, dtype=np.int32), (B, 1, nc)).copy()
    ps = sparse_decode_mla(T(q_lat), T(q_rope), T(ckv), T(krope), T(ids),
                           chunk, length=S)
    pd = dense_decode_mla(T(q_lat), T(q_rope), T(ckv), T(krope), length=S)
    _close(_finish(ps), _finish(pd))
    jpd = jsa.dense_decode_mla(jnp.asarray(q_lat), jnp.asarray(q_rope),
                               jnp.asarray(ckv), jnp.asarray(krope),
                               length=200)
    _close(_finish(dense_decode_mla(T(q_lat), T(q_rope), T(ckv), T(krope),
                                    length=200)), jsa._finish(jpd))


def test_window_masking(rng):
    B, S, H, Hkv, hd, window = 1, 128, 4, 2, 16, 32
    k, v = make_cache(rng, B, S, Hkv, hd)
    q = rng.randn(B, H, hd).astype(np.float32)
    pw = dense_decode_gqa(T(q), T(k), T(v), length=S, window=window,
                          query_pos=S)
    scores = np.einsum("bkgd,bskd->bkgs", q.reshape(B, Hkv, 2, hd), k)
    mask = np.arange(S) > (S - window)
    scores = np.where(mask[None, None, None], scores, -np.inf)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    ref = np.einsum("bkgs,bskd->bkgd", probs, v).reshape(B, H, hd)
    np.testing.assert_allclose(_finish(pw).numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    _close(_finish(pw), jsa._finish(jsa.dense_decode_gqa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length=S,
        window=window, query_pos=S)))


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_bf16_cache_cast_points_match_reference(rng, softcap):
    """A bf16 cache: q rounded to bf16 before the product, the
    probabilities rounded to bf16 for P·V, the softcap on the f32 scores —
    the partials within 1e-5 of max|num| of the reference's."""
    B, S, H, Hkv, hd, chunk, nsel = 2, 256, 8, 4, 32, 16, 5
    k, v = make_cache(rng, B, S, Hkv, hd)
    q = rng.randn(B, H, hd).astype(np.float32)
    ids = np.stack([np.stack([rng.choice(S // chunk, nsel, replace=False)
                              for _ in range(Hkv)]) for _ in range(B)]
                   ).astype(np.int32)
    kt, vt = T(k).bfloat16(), T(v).bfloat16()
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    ps = sparse_decode_gqa(T(q), kt, vt, T(ids), chunk, length=200,
                           attn_softcap=softcap)
    jps = jsa.sparse_decode_gqa(jnp.asarray(q), kj, vj, jnp.asarray(ids),
                                chunk, length=200, attn_softcap=softcap)
    for t, j in zip(ps, jps):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max())
    pd = dense_decode_gqa(T(q), kt, vt, length=200, attn_softcap=softcap)
    jpd = jsa.dense_decode_gqa(jnp.asarray(q), kj, vj, length=200,
                               attn_softcap=softcap)
    for t, j in zip(pd, jpd):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max())


def test_decode_budget_chunks_matches_reference():
    for args in ((4096, 64, 0.1, 1, 2), (64, 8, 0.4, 1, 1), (100, 16, 1.0,
                                                               1, 2)):
        assert decode_budget_chunks(*args) == jsa.decode_budget_chunks(*args)
