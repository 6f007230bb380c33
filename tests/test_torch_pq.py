"""The port's PQ abstract plane against ``repro``'s: the plain versions of
the k-means kernels B4/B5 against the JAX oracles and the Pallas kernels
in interpret mode, the host k-means and codec helpers, the ADC scores,
the tier store's PQ script, and the engine with ``pq_abstracts=True`` on
the longchat smoke config.  Inputs come from numpy seeds and go to both
frameworks.

Tolerances: codes and counts are exact (both sides compute the same
distance expression and take the first minimal index); Lloyd sums are
f32 sums in another order than JAX's (the port's plain version repeats
B5's order, held byte for byte to a loop over rows), held to rtol/atol
1e-5 as in tests/test_kernels.py; ADC scores are f32 dot products in another order,
held to rtol/atol 1e-5."""

import dataclasses
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.pq import ops as jpq
from repro.serving.offload import DEVICE, DISK, HOST
from repro.serving.offload import TieredKVStore as JStore
from repro_torch.kernels.pq import ops as tpq
from repro_torch.kernels.pq import ref as tpq_ref
from repro_torch.serving.engine import group_sum
from repro_torch.serving.offload import TieredKVStore as TStore


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m,N,dsub,K", [
    (1, 8, 8, 4), (2, 100, 8, 16), (4, 257, 16, 32), (3, 512, 4, 256),
])
@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_pq_assign_plain_matches_reference(rng, m, N, dsub, K, impl):
    x = rng.randn(m, N, dsub).astype(np.float32)
    cb = rng.randn(m, K, dsub).astype(np.float32)
    cb[:, K // 2] = cb[:, 0]                # an exact tie: first index wins
    want = np.asarray(jpq.pq_assign(jnp.asarray(x), jnp.asarray(cb),
                                    impl=impl))
    got = tpq.pq_assign(_t(x), _t(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.numpy() == K // 2).any()


# ---------------------------------------------------------------------------
# B4's tensor-core screen, emulated (kernels/pq/ref.py)
# ---------------------------------------------------------------------------

ROUNDINGS = ["trunc", "nearest"]


@pytest.mark.parametrize("m,N,dsub,K", [
    (1, 8, 8, 4), (2, 100, 8, 16), (4, 257, 16, 32), (3, 512, 4, 256),
    (2, 300, 32, 64), (1, 200, 1, 8), (2, 70, 2, 5),
])
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_pq_screen_emulation_codes_equal_reference(rng, m, N, dsub, K,
                                                   rounding):
    """TF32 screen + exact re-check: codes bitwise equal to the plain
    version and to JAX's oracle and interpret-mode Pallas kernel, with an
    exact tie planted (the first index wins)."""
    x = rng.randn(m, N, dsub).astype(np.float32)
    cb = rng.randn(m, K, dsub).astype(np.float32)
    cb[:, K - 1] = cb[:, 0]
    codes, mean = tpq_ref.pq_assign_screened_ref(_t(x), _t(cb),
                                                 rounding=rounding)
    np.testing.assert_array_equal(codes.numpy(),
                                  tpq.pq_assign(_t(x), _t(cb)).numpy())
    for impl in ("ref", "interpret"):
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(jpq.pq_assign(jnp.asarray(x),
                                                    jnp.asarray(cb),
                                                    impl=impl)))
    assert 1.0 <= mean < 2.0


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_pq_screen_forced_ties(rng, rounding):
    """Duplicated centroids and rows sitting on a centroid: every tied
    centroid is a candidate and the first index wins."""
    m, N, dsub, K = 2, 400, 8, 32
    x = rng.randn(m, N, dsub).astype(np.float32)
    cb = rng.randn(m, K, dsub).astype(np.float32)
    cb[:, K - 1] = cb[:, 0]
    cb[:, K // 2] = cb[:, 1]
    x[:, ::7] = cb[:, :1]
    x[:, 3::7] = cb[:, 1:2]
    codes, mean = tpq_ref.pq_assign_screened_ref(_t(x), _t(cb),
                                                 rounding=rounding)
    np.testing.assert_array_equal(codes.numpy(),
                                  tpq.pq_assign(_t(x), _t(cb)).numpy())
    assert not (codes.numpy() == K - 1).any()
    assert not (codes.numpy() == K // 2).any()
    assert mean > 1.0


def _boundary_rows(rng, rounding):
    """Rows at the eps boundary: every value carries the largest relative
    TF32 rounding error (mantissa 1 + (2^13 - 1) 2^-23 for truncation, the
    half-way 1 + 2^-11 for rounding to nearest, times a power of two), and
    each row is a power-of-two multiple of the largest centroid, so
    |x . c| = |x| max|c| and the errors of the 8 products add up with one
    sign."""
    m, K, dsub = 2, 16, 8
    low = 0x1FFF if rounding == "trunc" else 0x1000
    mant = np.array([0x3F800000 | low], np.int32).view(np.float32)[0]

    def pattern(shape, lo, hi):
        sign = np.where(rng.rand(*shape) < 0.5, -1.0, 1.0)
        return (sign * 2.0 ** rng.randint(lo, hi, shape) * mant).astype(
            np.float32)

    cb = pattern((m, K, dsub), -3, 0)
    cb[:, 0] = pattern((m, dsub), 0, 2)                # the largest centroid
    x = (cb[:, :1] * 2.0 ** rng.randint(-1, 2, (m, 64, 1))).astype(
        np.float32)
    return x, cb


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_pq_screen_bound_holds_at_its_boundary(rng, rounding):
    """|d~ - d| <= eps for every (row, centroid), and on rows built to
    carry the largest error the bound is nearly reached (truncation: more
    than 90 % of eps), so it is not loose; the codes stay exact."""
    x, cb = _boundary_rows(rng, rounding)
    xt, cbt = _t(x), _t(cb)
    d, dt = tpq_ref.screened_distances(xt, cbt, rounding)
    eps = tpq_ref.screen_eps(xt, cbt)
    ratio = ((dt.double() - d.double()).abs() / eps[..., None]).amax()
    assert ratio <= 1.0
    assert ratio > (0.9 if rounding == "trunc" else 0.45), ratio
    codes, _ = tpq_ref.pq_assign_screened_ref(xt, cbt, rounding=rounding)
    assert torch.equal(codes, tpq.pq_assign(xt, cbt))


def test_pq_screen_recheck_decides_near_ties(rng):
    """Centroids that TF32 cannot tell apart (the same values above the
    low 13 mantissa bits): the screen alone picks the wrong one in many
    rows, which an eps of zero shows; the real eps makes both candidates
    and the exact re-check gets every code right."""
    m, N, dsub, K = 2, 500, 8, 8
    cb = rng.randn(m, K, dsub).astype(np.float32)
    cb.view(np.int32)[...] &= ~0x1FFF
    twin = cb[:, ::2].copy()
    twin.view(np.int32)[...] |= rng.randint(1, 0x2000, twin.shape)
    cb[:, 1::2] = twin                        # odd centroid ~ its even one
    x = (cb[:, rng.randint(0, K, N)]
         + rng.randn(m, N, dsub).astype(np.float32) * 1e-3)
    want = tpq.pq_assign(_t(x), _t(cb))
    for rounding in ROUNDINGS:
        codes, mean = tpq_ref.pq_assign_screened_ref(_t(x), _t(cb),
                                                     rounding=rounding)
        assert torch.equal(codes, want) and mean >= 2.0
        blind, _ = tpq_ref.pq_assign_screened_ref(_t(x), _t(cb),
                                                  rounding=rounding,
                                                  eps_scale=0.0)
        assert (blind != want).float().mean() > 0.05


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       dsub=st.sampled_from([1, 2, 4, 8, 16, 32]),
       K=st.integers(1, 64), scale=st.sampled_from([1e-3, 1.0, 1e3]),
       rounding=st.sampled_from(ROUNDINGS), ties=st.booleans())
def test_pq_screen_emulation_property(seed, dsub, K, scale, rounding, ties):
    """Hypothesis-drawn inputs: any dsub, K, scale and rounding, with and
    without duplicated centroids, give the plain version's codes."""
    r = np.random.RandomState(seed)
    x = (r.randn(2, 64, dsub) * scale).astype(np.float32)
    cb = (r.randn(2, K, dsub) * scale).astype(np.float32)
    if ties and K > 1:
        cb[:, -1] = cb[:, 0]
        x[:, ::5] = cb[:, :1]
    codes, _ = tpq_ref.pq_assign_screened_ref(_t(x), _t(cb),
                                              rounding=rounding)
    assert torch.equal(codes, tpq.pq_assign(_t(x), _t(cb)))


def test_pq_screen_constants_match_the_kernel_source():
    """The emulation's eps constants are the CUDA kernel's."""
    src = (Path(tpq.__file__).resolve().parents[1] / "csrc"
           / "pq_kmeans.cu").read_text()
    found = dict(re.findall(r"constexpr float kEps(\w+) = ([-+.\deE]+)f;",
                            src))
    assert {k: float(v) for k, v in found.items()} == {
        "C1": tpq_ref.EPS_C1, "C2": tpq_ref.EPS_C2,
        "Delta": tpq_ref.EPS_DELTA, "Full": tpq_ref.EPS_FULL}
    assert np.float32(tpq_ref.EPS_C2) == tpq_ref.EPS_C2


@pytest.mark.parametrize("m,N,dsub,K,impl", [
    (1, 8, 8, 4, "ref"), (2, 100, 8, 16, "ref"), (4, 257, 16, 32, "ref"),
    (1, 8, 8, 4, "interpret"), (2, 100, 8, 16, "interpret"),
    (4, 257, 16, 32, "interpret"),
    # past one block of B5's order: several runs and blocks folded
    (2, 9000, 8, 16, "ref"), (2, 5000, 32, 64, "ref"),
])
def test_pq_update_plain_matches_reference(rng, m, N, dsub, K, impl):
    x = rng.randn(m, N, dsub).astype(np.float32)
    codes = rng.randint(0, K, (m, N)).astype(np.int32)
    s_j, n_j = jpq.pq_update(jnp.asarray(x), jnp.asarray(codes), K,
                             impl=impl)
    s_t, n_t = tpq.pq_update(_t(x), _t(codes), K)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    # the padding sentinel K adds nothing, on both sides
    codes[:, ::3] = K
    s_j, n_j = jpq.pq_update(jnp.asarray(x), jnp.asarray(codes), K,
                             impl="ref")
    s_t, n_t = tpq.pq_update(_t(x), _t(codes), K)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert n_t.numpy().sum() == (codes < K).sum()


def _update_in_order(x, codes, K):
    """B5's order as a plain loop over rows: runs of UPDATE_RUN_ROWS rows
    summed in row order from +0.0, UPDATE_WARPS runs to a block folded
    left, blocks folded left."""
    S, W = tpq_ref.UPDATE_RUN_ROWS, tpq_ref.UPDATE_WARPS
    m, N, dsub = x.shape
    T = -(-N // (S * W))
    sums = np.zeros((m, K, dsub), np.float32)
    counts = np.zeros((m, K), np.float32)
    for i in range(m):
        for t in range(T):
            part = np.zeros((K, dsub), np.float32)
            for w in range(W):
                run = np.zeros((K, dsub), np.float32)
                r0 = (t * W + w) * S
                for r in range(r0, min(r0 + S, N)):
                    c = codes[i, r]
                    if 0 <= c < K:
                        run[c] = run[c] + x[i, r]
                        counts[i, c] += 1
                part = part + run
            sums[i] = sums[i] + part
    return sums, counts


# N against B5's runs of 1 024 rows, 4 to a block: under one run, one
# run, a tail run in the first block, one full block, a second block of
# one short run, and three blocks with a tail
@pytest.mark.parametrize("N", [100, 1024, 3000, 4096, 5000, 9000])
@pytest.mark.parametrize("m,dsub,K,codes_kind", [
    (2, 8, 16, "random"),
    (3, 4, 256, "random"),              # K 256
    (2, 2, 1, "random"),                # K 1
    (2, 8, 8, "one_code"),              # every row on one code
    (1, 16, 5, "neg_zero"),             # sums of -0.0 start from +0.0
])
def test_pq_update_plain_is_b5s_order(rng, N, m, dsub, K, codes_kind):
    """The plain version repeats B5's order exactly: byte for byte against
    a loop over rows, with the padding sentinel K and negative codes
    adding nothing."""
    x = rng.randn(m, N, dsub).astype(np.float32)
    codes = rng.randint(-2, K + 2, (m, N)).astype(np.int32)
    if codes_kind == "one_code":
        codes[:] = K - 1
        codes[:, ::13] = K
    elif codes_kind == "neg_zero":
        x[:, :, :] = -0.0
        x[:, ::3, 0] = 0.0
        codes[:, ::2] = 0
    s_t, n_t = tpq_ref.pq_update_ref(_t(x), _t(codes), K)
    s_o, n_o = _update_in_order(x, codes, K)
    assert s_t.numpy().tobytes() == s_o.tobytes()
    assert n_t.numpy().tobytes() == n_o.tobytes()
    if codes_kind == "neg_zero":
        assert not np.signbit(s_o).any()


def test_pq_update_order_constants_match_the_kernel_source():
    """The plain version's run length and block width are B5's."""
    src = (Path(tpq.__file__).resolve().parents[1] / "csrc"
           / "pq_kmeans.cu").read_text()
    found = dict(re.findall(r"constexpr int kUpdate(\w+) = (\d+);", src))
    assert {k: int(v) for k, v in found.items()} == {
        "RunRows": tpq_ref.UPDATE_RUN_ROWS, "Warps": tpq_ref.UPDATE_WARPS}
    assert tpq_ref.UPDATE_RUN_ROWS % 256 == 0


@pytest.mark.parametrize("n,d,m,K", [(500, 16, 2, 16), (300, 32, 4, 64),
                                     (2000, 16, 2, 256)])
def test_pq_train_encode_decode_match_reference(n, d, m, K):
    rng = np.random.RandomState(n)
    vecs = (rng.randn(n, d) * 2).astype(np.float32)
    cb0 = np.zeros((m, K, d // m), np.float32)
    cnt0 = np.zeros((m, K), np.float64)
    cb_j, cnt_j = jpq.pq_train(vecs, cb0, cnt0, iters=4)
    cb_t, cnt_t = tpq.pq_train(vecs, cb0, cnt0, iters=4, device="cpu")
    assert cb_t.dtype == np.float32 and cnt_t.dtype == np.float64
    np.testing.assert_allclose(cb_t, cb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    # a trained codebook takes one running-mean merge
    more = (rng.randn(n // 2, d) * 2).astype(np.float32)
    cb2_j, cnt2_j = jpq.pq_train(more, cb_j, cnt_j)
    cb2_t, cnt2_t = tpq.pq_train(more, cb_j, cnt_j, device="cpu")
    np.testing.assert_allclose(cb2_t, cb2_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt2_t, cnt2_j)
    codes_t = tpq.pq_encode(vecs, cb2_j, device="cpu")
    assert codes_t.dtype == np.uint8 and codes_t.shape == (n, m)
    np.testing.assert_array_equal(codes_t, jpq.pq_encode(vecs, cb2_j))
    np.testing.assert_array_equal(tpq.pq_decode(codes_t, cb2_j),
                                  jpq.pq_decode(codes_t, cb2_j))


def test_pq_degenerate_inputs_match_reference(rng):
    """Constant keys collapse every code to one centroid without NaNs, and
    a batch smaller than the codebook (n < K) still trains — as in the
    reference's tests/test_kernels.py, value for value."""
    m, dsub, K = 2, 8, 16
    const = np.ones((40, m * dsub), np.float32) * 3.0
    cb0 = np.zeros((m, K, dsub), np.float32)
    cnt0 = np.zeros((m, K), np.float64)
    cb_t, cnt_t = tpq.pq_train(const, cb0, cnt0, iters=3, device="cpu")
    cb_j, cnt_j = jpq.pq_train(const, cb0, cnt0, iters=3, impl="interpret")
    np.testing.assert_array_equal(cb_t, cb_j)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    assert np.isfinite(cb_t).all()
    codes = tpq.pq_encode(const, cb_t, device="cpu")
    assert all(len(np.unique(codes[:, i])) == 1 for i in range(m))
    few = rng.randn(5, m * dsub).astype(np.float32)
    cb2_t, _ = tpq.pq_train(few, cb0, cnt0, iters=4, device="cpu")
    cb2_j, _ = jpq.pq_train(few, cb0, cnt0, iters=4, impl="interpret")
    np.testing.assert_array_equal(cb2_t, cb2_j)
    dec = tpq.pq_decode(tpq.pq_encode(few, cb2_t, device="cpu"), cb2_t)
    np.testing.assert_allclose(dec, few, rtol=1e-4, atol=1e-4)
    # no rows: nothing changes
    cb3, cnt3 = tpq.pq_train(few[:0], cb_t, cnt_t, device="cpu")
    np.testing.assert_array_equal(cb3, cb_t)
    np.testing.assert_array_equal(cnt3, cnt_t)


@pytest.mark.parametrize("G", [1, 2, 3])
def test_adc_chunk_scores_match_reference(G):
    """The engine's ADC input and scores: q summed per kv group exactly as
    the reference engine does (numpy ``reshape(...).sum(2)``, one rounding
    per add), then the lookup table, code gather, subspace sum and
    live-token max against the reference's."""
    rng = np.random.RandomState(G)
    B, Hkv, hd, nc, chunk, m, K = 2, 2, 16, 4, 8, 2, 16
    q = rng.randn(B, Hkv * G, hd).astype(np.float32)
    q_sum = group_sum(_t(q), Hkv)
    np.testing.assert_array_equal(q_sum.numpy(),
                                  q.reshape(B, Hkv, G, hd).sum(2))
    cb = rng.randn(m, K, hd // m).astype(np.float32)
    codes = rng.randint(0, K, (B, nc, chunk, Hkv, m)).astype(np.uint8)
    lengths = np.asarray([nc * chunk, nc * chunk - chunk // 2 - 3])
    got = tpq.adc_chunk_scores(q_sum, cb, codes, lengths)
    want = jpq.adc_chunk_scores(q.reshape(B, Hkv, G, hd).sum(2), cb, codes,
                                lengths)
    assert got.shape == (B, Hkv, nc) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the tier store's PQ plane
# ---------------------------------------------------------------------------

L, NC, C, HKV, HD, NSEQ, K = 2, 4, 8, 2, 16, 2, 16


def _pq_stores(tmp_path):
    kw = dict(n_seqs=NSEQ, transit_codec=None, use_pool=True,
              abstract_kind="pq", pq_centroids=K)
    (tmp_path / "jax").mkdir()
    js = JStore(L, NC, C, HKV, HD, root=str(tmp_path / "jax"), **kw)
    ts = TStore(L, NC, C, HKV, HD, root=str(tmp_path / "torch"),
                device="cpu", **kw)
    return js, ts


def _pq_script(store, executor):
    """Ingest two sequences (some chunks on disk), read, append into two
    chunks, read (their codes are stale), two quiet sweeps re-encode them,
    read again; returns every value the store hands back."""
    rng = np.random.RandomState(3)
    lengths = {0: 27, 1: 19}
    out = []
    for seq, S in lengths.items():
        for layer in range(L):
            k = rng.randn(NC * C, HKV, HD).astype(np.float32)
            k[S:] = 0
            tiers = (DEVICE, HOST, DISK, DISK)
            store.ingest(layer, k, k * 0.5,
                         {c: tiers[(c + seq) % NC] for c in range(NC)},
                         seq=seq, executor=executor)
    for seq in lengths:
        store.ingest_fence(seq)
    chunks = {s: list(range(-(-n // C))) for s, n in lengths.items()}
    for layer in range(L):
        out += list(store.read_abstracts_pq_batch(layer, chunks))
    for layer in range(L):
        kn_ = rng.randn(NSEQ, HKV, HD).astype(np.float32)
        store.append_tokens_batch(layer, np.array([27, 19]), kn_, kn_,
                                  seqs=[0, 1])
    for layer in range(L):
        out += list(store.read_abstracts_pq_batch(layer, chunks))
    out.append(store.requant_sweep(executor))
    out.append(store.requant_sweep(executor))
    store.requant_fence()
    for layer in range(L):
        out += list(store.read_abstracts_pq_batch(layer, chunks))
    out.append(store.pq_reencodes)
    return out


@pytest.mark.parametrize("write_behind", [False, True])
def test_pq_store_script_matches_reference(tmp_path, write_behind):
    js, ts = _pq_stores(tmp_path)
    ex = ThreadPoolExecutor(max_workers=1) if write_behind else None
    try:
        out_j = _pq_script(js, ex)
        out_t = _pq_script(ts, ex)
        assert len(out_j) == len(out_t)
        for a, b in zip(out_j, out_t):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        assert out_t[-1] == 2 * L               # chunk 3 of seq 0, 2 of 1
        np.testing.assert_array_equal(np.asarray(js._pq_codes),
                                      np.asarray(ts._pq_codes))
        np.testing.assert_array_equal(js._pq_cb, ts._pq_cb)
        np.testing.assert_array_equal(np.asarray(js._pq_codebook),
                                      np.asarray(ts._pq_codebook))
        np.testing.assert_array_equal(js._pq_counts, ts._pq_counts)
        np.testing.assert_array_equal(js._pq_valid, ts._pq_valid)
        np.testing.assert_array_equal(np.asarray(js._pq_crc),
                                      np.asarray(ts._pq_crc))
        np.testing.assert_array_equal(np.asarray(js._crc),
                                      np.asarray(ts._crc))
        np.testing.assert_array_equal(np.asarray(js._crc_state),
                                      np.asarray(ts._crc_state))
        assert dict(js.log.bytes) == dict(ts.log.bytes)
        assert dict(js.log.ops) == dict(ts.log.ops)
        assert js.log.bytes[(DISK, HOST, "pq_codes_read")] > 0
        assert js.tier_bytes() == ts.tier_bytes()
        for key in ("checksum_failures", "pq_fallbacks", "pq_reencodes",
                    "disk_lost"):
            assert js.fault_stats()[key] == ts.fault_stats()[key]
        js.clear_seq(0)
        ts.clear_seq(0)
        np.testing.assert_array_equal(js._pq_valid, ts._pq_valid)
        assert js._chunk_version == ts._chunk_version
    finally:
        js.close()
        ts.close()
        if ex is not None:
            ex.shutdown()


def test_pq_corrupt_codes_quarantine_and_reencode(tmp_path):
    """A flipped code byte fails its CRC: min/max serves the chunk, the
    counters move, two sweeps re-encode it, and the next read is valid."""
    _, ts = _pq_stores(tmp_path)
    try:
        k = np.random.RandomState(6).randn(NC * C, HKV, HD).astype(
            np.float32)
        ts.ingest(0, k, k, {c: DISK for c in range(NC)}, seq=0)
        ts._pq_codes[0, 0, 1].reshape(-1)[0] ^= 1
        _, _, codes, valid, _, billed = ts.read_abstracts_pq_batch(
            0, {0: [0, 1]})
        assert list(valid[0]) == [True, False] and not codes[0, 1].any()
        assert billed[0] == ts.pq_bytes + ts.abstract_bytes
        fs = ts.fault_stats()
        assert fs["checksum_failures"] == 1 and fs["pq_fallbacks"] == 1
        ts.requant_sweep()
        ts.requant_sweep()
        _, _, _, valid, _, _ = ts.read_abstracts_pq_batch(0, {0: [0, 1]})
        assert valid.all() and ts.pq_reencodes == 1
    finally:
        ts.close()


# ---------------------------------------------------------------------------
# the engine with pq_abstracts=True
# ---------------------------------------------------------------------------

def _cfg(get):
    cfg = get("longchat-7b-32k", smoke=True)
    return dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=16,
                                       importance_rate=0.4, early_rate=0.6,
                                       min_seq_for_sparse=32))


@pytest.fixture(scope="module")
def engine_setup():
    from repro.configs import get_config
    from repro.models import lm as jlm
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.models.params import params_from_jax
    cfg, tcfg = _cfg(get_config), _cfg(t_get_config)
    params = jlm.init(cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.RandomState(11)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (48, 57)]
    return cfg, tcfg, params, tparams, prompts


def _run_engine(port, setup, rounds, **kw):
    cfg, tcfg, params, tparams, prompts = setup
    if port:
        from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
        eng = BatchedLeoAMEngine(
            tcfg, tparams, EngineCfg(max_len=128, selection="tree",
                                     pq_abstracts=True, **kw),
            max_seqs=2, device="cpu")
    else:
        from repro.serving.engine import BatchedLeoAMEngine, EngineCfg
        eng = BatchedLeoAMEngine(
            cfg, params, EngineCfg(max_len=128, selection="tree",
                                   disk_sidecar=False, pq_abstracts=True,
                                   **kw),
            max_seqs=2)
    toks = {}
    for p in prompts:
        sid, tok = eng.add_sequence(p)
        toks[sid] = tok
    out = {sid: [tok] for sid, tok in toks.items()}
    for _ in range(rounds):
        toks = eng.decode_round(toks)
        # the sweep re-encodes on the worker while the next round reads:
        # fence it, so which codes are valid at a read is not a race
        eng.store.requant_fence()
        for sid, t in toks.items():
            out[sid].append(t)
    st = eng.store
    res = dict(out=out, fs=eng.fault_stats(), bytes=dict(st.log.bytes),
               ops=dict(st.log.ops), cb=st._pq_cb.copy(),
               codes=np.array(st._pq_codes), valid=st._pq_valid.copy(),
               reencodes=st.pq_reencodes)
    st.close()
    return res


@pytest.mark.parametrize("pipeline", [True, False])
def test_pq_engine_matches_reference(engine_setup, pipeline):
    """Token streams, TrafficLogs, code validity and re-encodes equal the
    reference engine's over 12 rounds (the second prompt's tail chunk fills
    and goes quiet, so the sweep re-encodes it; each round's sweep is
    fenced in both engines).  The keys reach each store
    through its own framework's prefill (within 1e-5), and a key can round
    to the neighbouring fp16 value: the codebooks agree to one fp16 ulp of
    their largest entry, the codes exactly."""
    before = (tpq.assign_launches, tpq.update_launches)
    kw = dict(pipeline=pipeline, cpu_chunk_frac=0.2)   # chunks 2+ on disk
    j = _run_engine(False, engine_setup, 12, **kw)
    t = _run_engine(True, engine_setup, 12, **kw)
    assert t["out"] == j["out"]
    assert t["bytes"] == j["bytes"] and t["ops"] == j["ops"]
    assert t["bytes"][(DISK, HOST, "pq_codes_read")] > 0
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_array_equal(t["codes"], j["codes"])
    ulp = float(np.spacing(np.float16(np.abs(j["cb"]).max())))
    assert np.abs(t["cb"] - j["cb"]).max() <= ulp
    assert t["fs"]["pq_fallbacks"] == j["fs"]["pq_fallbacks"] == 0
    assert t["reencodes"] == j["reencodes"] > 0
    # on the CPU the plain versions ran: no kernel launch was counted
    assert (tpq.assign_launches, tpq.update_launches) == before
