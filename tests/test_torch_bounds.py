"""Soundness of the port's LKA chunk bounds (paper §4.3) and its abstract
pyramid, ported from ``tests/test_bounds.py`` (property-based); each case
also holds the port's function against the ``repro`` function on the same
numpy inputs (f32: 1e-5 relative for sums in another order, abstracts
bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import abstracts as jabs
from repro.core import bounds as jbounds
from repro_torch.core.abstracts import (NEG, abstract_bytes, build_pyramid,
                                        chunk_minmax, num_levels,
                                        update_pyramid)
from repro_torch.core.bounds import (box_bounds, chunk_bounds_gqa,
                                     chunk_bounds_gqa_matmul,
                                     chunk_bounds_mla,
                                     positive_negative_split)

T = torch.from_numpy


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([8, 16, 32]),
       st.sampled_from([(4, 2), (8, 4), (6, 1)]))
def test_bounds_contain_true_scores(seed, chunk, heads):
    """For every chunk: lb <= (group-summed) q·k <= ub for all its tokens,
    and both bounds equal the reference's."""
    H, Hkv = heads
    rng = np.random.RandomState(seed)
    B, S, hd = 2, 4 * chunk, 16
    q = rng.randn(B, H, hd).astype(np.float32)
    k = (rng.randn(B, S, Hkv, hd) * rng.uniform(0.5, 3)).astype(np.float32)
    kmax, kmin = chunk_minmax(T(k), chunk)
    ub, lb = chunk_bounds_gqa(T(q), kmax, kmin)
    G = H // Hkv
    scores = np.einsum("bkgd,bskd->bkgs", q.reshape(B, Hkv, G, hd), k).sum(2)
    per_chunk = scores.reshape(B, Hkv, S // chunk, chunk)
    assert np.all(ub.numpy()[..., None] >= per_chunk - 1e-3)
    assert np.all(lb.numpy()[..., None] <= per_chunk + 1e-3)
    jkm, jkn = jabs.chunk_minmax(jnp.asarray(k), chunk)
    np.testing.assert_array_equal(kmax.numpy(), np.asarray(jkm))
    np.testing.assert_array_equal(kmin.numpy(), np.asarray(jkn))
    jub, jlb = jbounds.chunk_bounds_gqa(jnp.asarray(q), jkm, jkn)
    np.testing.assert_allclose(ub.numpy(), np.asarray(jub), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(lb.numpy(), np.asarray(jlb), rtol=1e-5,
                               atol=1e-4)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000))
def test_matmul_form_equals_corner_form(seed):
    """The q⁺/q⁻ matmul form (kernel B1's plain version on the CPU) equals
    the corner form, and the reference's matmul form."""
    rng = np.random.RandomState(seed)
    B, Hkv, G, hd, nc = 2, 3, 2, 8, 5
    q = rng.randn(B, Hkv * G, hd).astype(np.float32)
    km = rng.randn(B, nc, Hkv, hd).astype(np.float32)
    kn = km - np.abs(rng.randn(B, nc, Hkv, hd)).astype(np.float32)
    ub1, lb1 = chunk_bounds_gqa(T(q), T(km), T(kn))
    ub2, lb2 = chunk_bounds_gqa_matmul(T(q), T(km), T(kn))
    np.testing.assert_allclose(ub1, ub2, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(lb1, lb2, rtol=1e-5, atol=1e-4)
    jub, jlb = jbounds.chunk_bounds_gqa_matmul(jnp.asarray(q),
                                               jnp.asarray(km),
                                               jnp.asarray(kn))
    np.testing.assert_allclose(ub2, np.asarray(jub), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lb2, np.asarray(jlb), rtol=1e-5, atol=1e-5)


def test_box_bounds_and_split_match_reference(rng):
    q = rng.randn(2, 3, 8).astype(np.float32)
    km = rng.randn(2, 5, 8).astype(np.float32)
    kn = km - np.abs(rng.randn(2, 5, 8)).astype(np.float32)
    for t, j in zip(box_bounds(T(q), T(km), T(kn)),
                    jbounds.box_bounds(jnp.asarray(q), jnp.asarray(km),
                                       jnp.asarray(kn))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    for t, j in zip(positive_negative_split(T(q)),
                    jbounds.positive_negative_split(jnp.asarray(q))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_mla_bounds_sound(rng):
    B, H, r, rr, S, chunk = 2, 4, 32, 8, 128, 16
    q_lat = rng.randn(B, H, r).astype(np.float32)
    q_rope = rng.randn(B, H, rr).astype(np.float32)
    ckv = rng.randn(B, S, r).astype(np.float32)
    krope = rng.randn(B, S, rr).astype(np.float32)
    cm, cn = chunk_minmax(T(ckv[:, :, None]), chunk)
    rm, rn = chunk_minmax(T(krope[:, :, None]), chunk)
    ub, lb = chunk_bounds_mla(T(q_lat), T(q_rope), cm[:, :, 0], cn[:, :, 0],
                              rm[:, :, 0], rn[:, :, 0])
    scores = (np.einsum("bhr,bsr->bhs", q_lat, ckv)
              + np.einsum("bhr,bsr->bhs", q_rope, krope)).sum(1)
    per_chunk = scores.reshape(B, S // chunk, chunk)
    assert np.all(ub.numpy()[..., None] >= per_chunk - 1e-3)
    assert np.all(lb.numpy()[..., None] <= per_chunk + 1e-3)
    jub, _ = jbounds.chunk_bounds_mla(
        jnp.asarray(q_lat), jnp.asarray(q_rope), *[
            jnp.asarray(a[:, :, 0].numpy()) for a in (cm, cn, rm, rn)])
    np.testing.assert_allclose(ub.numpy(), np.asarray(jub), rtol=1e-5,
                               atol=1e-4)


def test_pyramid_parents_contain_children(rng):
    B, S, Hkv, hd, chunk = 2, 256, 2, 8, 16
    k = rng.randn(B, S, Hkv, hd).astype(np.float32)
    pyr = build_pyramid(T(k), chunk, 3)
    assert pyr.levels == 3
    for lvl in range(pyr.levels - 1):
        km, kn = pyr.kmax[lvl].numpy(), pyr.kmin[lvl].numpy()
        pm, pn = pyr.kmax[lvl + 1].numpy(), pyr.kmin[lvl + 1].numpy()
        np.testing.assert_allclose(pm, km.reshape(B, -1, 2, Hkv, hd).max(2))
        np.testing.assert_allclose(pn, kn.reshape(B, -1, 2, Hkv, hd).min(2))
    jpyr = jabs.build_pyramid(jnp.asarray(k), chunk, 3)
    for t, j in zip(pyr.kmax + pyr.kmin, jpyr.kmax + jpyr.kmin):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert abstract_bytes(pyr) == jabs.abstract_bytes(jpyr)


def test_incremental_update_matches_rebuild(rng):
    """The in-place decode update equals a rebuild, and the reference's
    functional update."""
    B, S, Hkv, hd, chunk = 1, 64, 2, 8, 8
    k = rng.randn(B, S, Hkv, hd).astype(np.float32)
    length = 37
    pyr = build_pyramid(T(k), chunk, 3, length=length)
    k_new = rng.randn(B, Hkv, hd).astype(np.float32)
    k2 = k.copy()
    k2[:, length] = k_new
    jinc = jabs.update_pyramid(jabs.build_pyramid(
        jnp.asarray(k), chunk, 3, length=length), jnp.asarray(k_new),
        jnp.int32(length), chunk)
    pyr_inc = update_pyramid(pyr, T(k_new), length, chunk)
    assert pyr_inc.kmax[0] is pyr.kmax[0]                 # in place
    pyr_re = build_pyramid(T(k2), chunk, 3, length=length + 1)
    for a, b, j in zip(pyr_inc.kmax + pyr_inc.kmin, pyr_re.kmax + pyr_re.kmin,
                       jinc.kmax + jinc.kmin):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))


@pytest.mark.parametrize("n,req", [(64, 3), (8, 2), (6, 3), (3, 3), (1, 2),
                                   (48, 4)])
def test_num_levels_and_sentinels_match_reference(rng, n, req):
    """Usable levels and the ∓1e30 sentinel rows past ``length`` are the
    reference's; q·sentinel stays finite through the bound."""
    assert num_levels(n, req) == jabs.num_levels(n, req)
    k = rng.randn(2, 4 * 8, 2, 8).astype(np.float32)
    km, kn = chunk_minmax(T(k), 8, length=13)
    jkm, jkn = jabs.chunk_minmax(jnp.asarray(k), 8, length=13)
    np.testing.assert_array_equal(km.numpy(), np.asarray(jkm))
    np.testing.assert_array_equal(kn.numpy(), np.asarray(jkn))
    assert (km[:, 2:] == NEG).all() and (kn[:, 2:] == -NEG).all()
    ub, lb = chunk_bounds_gqa_matmul(T(rng.randn(2, 4, 8).astype(
        np.float32)), km, kn)
    assert torch.isfinite(ub).all() and torch.isfinite(lb).all()
