"""The port's device-side pyramid selection (paper §4.2, the fixed-shape
IAKM descent of ``lm.decode_step``), ported from the pyramid cases of
``tests/test_adaptive.py``; each case also holds the selected ids equal,
in order, to ``repro.core.adaptive``'s on the same numpy inputs (the
port's top-k is a stable descending sort, ``jax.lax.top_k``'s tie order),
ties from forced sink/recent nodes and from sentinel chunks included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abstracts as jabs
from repro.core import adaptive as jad
from repro_torch.core.abstracts import build_pyramid
from repro_torch.core.adaptive import (_beam_sizes, flat_select_gqa,
                                       pyramid_eval_count,
                                       pyramid_select_gqa,
                                       pyramid_select_mla)

T = torch.from_numpy


def _ids_equal(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pyramid_recall_on_planted(rng):
    """Device-side pyramid descent finds the planted hot chunks."""
    B, S, H, Hkv, hd, chunk = 2, 1024, 8, 4, 32, 32
    nc = S // chunk
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(B, S, Hkv, hd).astype(np.float32) * 0.1
    planted = {}
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, hd).mean(2)
    for b in range(B):
        for h in range(Hkv):
            cs = rng.choice(nc - 4, 3, replace=False) + 2
            planted[(b, h)] = set(int(c) for c in cs)
            for c in cs:
                k[b, c * chunk:(c + 1) * chunk, h] += (
                    2.5 * qg[b, h] / np.linalg.norm(qg[b, h]) * np.sqrt(hd))
    ids = pyramid_select_gqa(T(q), build_pyramid(T(k), chunk, 3), budget=8)
    for b in range(B):
        for h in range(Hkv):
            got = set(ids[b, h].tolist())
            missing = planted[(b, h)] - got
            assert not missing, (b, h, planted[(b, h)], got)
    _ids_equal(ids, jad.pyramid_select_gqa(
        jnp.asarray(q), jabs.build_pyramid(jnp.asarray(k), chunk, 3),
        budget=8))


def test_pyramid_select_includes_sink_and_recent(rng):
    B, S, H, Hkv, hd, chunk = 1, 512, 4, 2, 16, 16
    k = rng.randn(B, S, Hkv, hd).astype(np.float32)
    q = rng.randn(B, H, hd).astype(np.float32)
    nc = S // chunk
    ids = pyramid_select_gqa(T(q), build_pyramid(T(k), chunk, 3), budget=6,
                             sink_chunks=1, recent_chunks=2)
    for h in range(Hkv):
        got = set(ids[0, h].tolist())
        assert 0 in got
        assert {nc - 1, nc - 2} <= got
    _ids_equal(ids, jad.pyramid_select_gqa(
        jnp.asarray(q), jabs.build_pyramid(jnp.asarray(k), chunk, 3),
        budget=6, sink_chunks=1, recent_chunks=2))


def test_pyramid_eval_count_scaling():
    """Adaptive evaluation count ~O(budget·log) vs O(nc) flat scoring."""
    nc0, budget = 8192, 128
    adaptive = pyramid_eval_count(4, nc0, budget)
    assert adaptive < 0.5 * nc0, adaptive
    for args in ((4, 8192, 128), (3, 64, 9, 2, 3), (2, 8, 3, 2, 2)):
        assert pyramid_eval_count(*args) == jad.pyramid_eval_count(*args)
    assert _beam_sizes(3, 9, [64, 32, 16], 2, 3) == \
        jad._beam_sizes(3, 9, [64, 32, 16], 2, 3)


@pytest.mark.parametrize("length", [1000, 777, 130, 64])
@pytest.mark.parametrize("levels,budget,rf", [(3, 8, 2), (2, 5, 1),
                                              (4, 12, 2), (1, 4, 2)])
def test_pyramid_ids_match_reference_with_ties(rng, length, levels, budget,
                                               rf):
    """Selections with the length mask: chunks past ``length`` hold the
    sentinels and tie among themselves, the forced sink and recent nodes
    tie at +inf — every id, in order, as the reference's."""
    B, S, H, Hkv, hd, chunk = 2, 1024, 8, 4, 16, 16
    k = rng.randn(B, S, Hkv, hd).astype(np.float32)
    q = rng.randn(B, H, hd).astype(np.float32)
    nv = (length + chunk - 1) // chunk
    pyr = build_pyramid(T(k), chunk, levels, length=length)
    jpyr = jabs.build_pyramid(jnp.asarray(k), chunk, levels, length=length)
    ids = pyramid_select_gqa(T(q), pyr, budget, rf=rf, n_valid0=nv)
    _ids_equal(ids, jad.pyramid_select_gqa(jnp.asarray(q), jpyr, budget,
                                           rf=rf, n_valid0=nv))
    assert ids.dtype == torch.int32
    flat = flat_select_gqa(T(q), pyr.kmax[0], pyr.kmin[0], budget,
                           n_valid0=nv)
    _ids_equal(flat, jad.flat_select_gqa(jnp.asarray(q), jpyr.kmax[0],
                                         jpyr.kmin[0], budget, n_valid0=nv))


@pytest.mark.parametrize("length", [256, 200, 70])
def test_pyramid_select_mla_matches_reference(rng, length):
    B, S, H, r, rr, chunk = 2, 256, 4, 32, 8, 16
    q_lat = rng.randn(B, H, r).astype(np.float32)
    q_rope = rng.randn(B, H, rr).astype(np.float32)
    ckv = rng.randn(B, S, 1, r).astype(np.float32)
    krope = rng.randn(B, S, 1, rr).astype(np.float32)
    nv = (length + chunk - 1) // chunk
    ids = pyramid_select_mla(
        T(q_lat), T(q_rope), build_pyramid(T(ckv), chunk, 3, length=length),
        build_pyramid(T(krope), chunk, 3, length=length), 5, n_valid0=nv)
    assert ids.shape == (B, 1, 5)
    _ids_equal(ids, jad.pyramid_select_mla(
        jnp.asarray(q_lat), jnp.asarray(q_rope),
        jabs.build_pyramid(jnp.asarray(ckv), chunk, 3, length=length),
        jabs.build_pyramid(jnp.asarray(krope), chunk, 3, length=length), 5,
        n_valid0=nv))
