"""Plain PyTorch versions of the port's kernels against the JAX package:
its pure-jnp oracles, its Pallas kernels in interpret mode, and the engine
functions the kernels replace on the main path.  Inputs come from numpy
seeds and go to both frameworks.

Tolerances follow tests/test_kernels.py (f32 1e-4 for bounds, 1e-5 for
sparse decode; bf16 2e-2), except the bf16 attention output of the
engine entry, held by :func:`assert_bf16_close`; the dequant and the host
quantizer must be bitwise equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core.bounds import chunk_bounds_gqa_matmul as j_bounds_gqa
from repro.kernels.chunk_bounds.ops import chunk_bounds as j_chunk_bounds
from repro.kernels.kv_quant.ops import kv_dequant as j_kv_dequant
from repro.kernels.sparse_decode.ops import sparse_decode as j_sparse_decode
from repro.serving.engine import _attend_pooled as j_attend_pooled
from repro.serving.engine import _attend_workingset as j_attend_workingset
from repro_torch.core import compression as tcomp
from repro_torch.core.bounds import chunk_bounds_gqa_matmul as t_bounds_gqa
from repro_torch.kernels.chunk_bounds.ops import chunk_bounds as t_chunk_bounds
from repro_torch.kernels.kv_quant.ops import kv_dequant as t_kv_dequant
from repro_torch.kernels.sparse_decode.ops import (BLOCKS_PER_SM,
                                                   sparse_decode as
                                                   t_sparse_decode,
                                                   sparse_decode_pooled,
                                                   sparse_decode_workingset,
                                                   split_plan, split_rows)
from repro_torch.kernels.sparse_decode.ref import (
    BF16_MAX_MISMATCH, bf16_agreement, contract_agreement, model_scale,
    sparse_decode_pooled_split_ref, sparse_decode_ref, tied_contract_case,
    workingset_slab)

_TDT = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _both(a: np.ndarray, dtype=np.float32):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(a)).to(_TDT[dtype]))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_bf16_close(out: np.ndarray, ref: np.ndarray) -> None:
    """Held by the kernel's own bar (``bf16_agreement``): at most 5 % of
    the elements differ, each by at most two bf16 ulps of max|ref|."""
    err, bar, frac = bf16_agreement(torch.from_numpy(out),
                                    torch.from_numpy(ref))
    assert err <= bar, f"max |diff| {err} > {bar}"
    assert frac <= BF16_MAX_MISMATCH, f"{frac:.1%} of elements differ"


@pytest.mark.parametrize("B,Hkv,G,hd,nc", [
    (1, 1, 1, 8, 4), (2, 4, 2, 32, 16), (1, 2, 3, 128, 7),
    (2, 8, 1, 64, 130), (1, 16, 6, 192, 33),
])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_chunk_bounds_plain_matches_jax(rng, B, Hkv, G, hd, nc, dtype):
    qn = rng.randn(B, Hkv, G, hd).astype(np.float32)
    km = rng.randn(B, Hkv, nc, hd).astype(np.float32)
    kn = km - np.abs(rng.randn(B, Hkv, nc, hd)).astype(np.float32)
    qj, qt = _both(qn, dtype)
    ub_t, lb_t = t_chunk_bounds(qt, torch.from_numpy(km),
                                torch.from_numpy(kn))
    tol = 1e-4 if dtype == np.float32 else 2e-2
    for impl in ("ref", "interpret"):
        ub_j, lb_j = j_chunk_bounds(qj, jnp.asarray(km), jnp.asarray(kn),
                                    impl=impl)
        np.testing.assert_allclose(_np(ub_t), _np(ub_j), rtol=tol,
                                   atol=tol * 10)
        np.testing.assert_allclose(_np(lb_t), _np(lb_j), rtol=tol,
                                   atol=tol * 10)


@pytest.mark.parametrize("B,H,Hkv,hd,nc", [(3, 4, 4, 16, 8), (2, 8, 2, 32, 5)])
def test_bounds_engine_entry_matches_jax(rng, B, H, Hkv, hd, nc):
    """The engine's entry (store layout, (B, H, hd) queries) against
    repro.core.bounds.chunk_bounds_gqa_matmul."""
    q = (rng.randn(B, H, hd) / np.sqrt(hd)).astype(np.float32)
    km = rng.randn(B, nc, Hkv, hd).astype(np.float32)
    kn = km - np.abs(rng.randn(B, nc, Hkv, hd)).astype(np.float32)
    ub_j, lb_j = j_bounds_gqa(jnp.asarray(q), jnp.asarray(km),
                              jnp.asarray(kn))
    ub_t, lb_t = t_bounds_gqa(torch.from_numpy(q), torch.from_numpy(km),
                              torch.from_numpy(kn))
    np.testing.assert_allclose(_np(ub_t), _np(ub_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(lb_t), _np(lb_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,Hkv,G,hd,S,chunk,nsel", [
    (1, 1, 1, 8, 64, 8, 3), (2, 2, 2, 32, 128, 16, 4),
    (1, 4, 1, 128, 256, 64, 3), (2, 1, 3, 64, 512, 32, 8),
    (1, 2, 4, 192, 256, 128, 2),
])
@pytest.mark.parametrize("kv_dtype", [np.float32, jnp.bfloat16])
def test_sparse_decode_plain_matches_jax(rng, B, Hkv, G, hd, S, chunk, nsel,
                                         kv_dtype):
    q = (rng.randn(B, Hkv, G, hd) / np.sqrt(hd)).astype(np.float32)
    kj, kt = _both(rng.randn(B, S, Hkv, hd).astype(np.float32), kv_dtype)
    vj, vt = _both(rng.randn(B, S, Hkv, hd).astype(np.float32), kv_dtype)
    nc = S // chunk
    ids = np.stack([
        np.stack([rng.choice(nc, nsel, replace=False) for _ in range(Hkv)])
        for _ in range(B)]).astype(np.int32)
    length = S - chunk // 2
    outs_t = t_sparse_decode(torch.from_numpy(q), kt, vt,
                             torch.from_numpy(ids), length, chunk=chunk)
    tol = 1e-5 if kv_dtype == np.float32 else 2e-2
    for impl in ("ref", "interpret"):
        outs_j = j_sparse_decode(jnp.asarray(q), kj, vj, jnp.asarray(ids),
                                 jnp.int32(length), chunk=chunk, impl=impl)
        for t, j in zip(outs_t, outs_j):
            np.testing.assert_allclose(_np(t), _np(j), rtol=tol,
                                       atol=tol * 10)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_sparse_decode_engine_entry_matches_attend_pooled(rng, dtype,
                                                          softcap):
    """The engine's entry against repro.serving.engine._attend_pooled:
    slot-indexed pool reads, -1 padding, the strict pos < length mask and
    the new token's row (output projection = identity)."""
    B, H, Hkv, hd, chunk, n_slots, nmax = 3, 4, 2, 16, 8, 12, 4
    pool = rng.randn(n_slots + 1, 2, chunk, Hkv, hd).astype(np.float16)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b, n in enumerate((4, 2, 3)):
        slots[b, :n] = rng.choice(n_slots, n, replace=False)
        cids[b, :n] = np.sort(rng.choice(10, n, replace=False))
        lengths[b] = cids[b, n - 1] * chunk + rng.randint(1, chunk)
    qj, qt = _both(rng.randn(B, 1, H, hd).astype(np.float32), dtype)
    knj, knt = _both(rng.randn(B, 1, Hkv, hd).astype(np.float32), dtype)
    vnj, vnt = _both(rng.randn(B, 1, Hkv, hd).astype(np.float32), dtype)
    eye = jnp.eye(H * hd, dtype=qj.dtype)
    y_j = j_attend_pooled(qj, jnp.asarray(pool), jnp.asarray(slots),
                          jnp.asarray(cids), jnp.asarray(lengths), knj, vnj,
                          eye, attn_softcap=softcap)
    y_t = sparse_decode_pooled(qt[:, 0], torch.from_numpy(pool),
                               torch.from_numpy(slots),
                               torch.from_numpy(cids),
                               torch.from_numpy(lengths), knt, vnt, softcap)
    assert y_t.dtype == qt.dtype
    if dtype == np.float32:
        np.testing.assert_allclose(_np(y_t).reshape(B, 1, H * hd), _np(y_j),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_bf16_close(_np(y_t).reshape(B, 1, H * hd), _np(y_j))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_sparse_decode_workingset_entry_matches_attend_workingset(
        rng, dtype, softcap):
    """The legacy engine's entry against repro.serving.engine.
    _attend_workingset (the reference's host-assembled working set,
    zero-padded, with the engine's position mask; output projection =
    identity), and bitwise against the pooled entry over the same rows."""
    B, H, Hkv, hd, chunk, nmax = 3, 4, 2, 16, 8, 4
    kg = rng.randn(B, nmax, chunk, Hkv, hd).astype(np.float16)
    vg = rng.randn(B, nmax, chunk, Hkv, hd).astype(np.float16)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b, n in enumerate((4, 2, 3)):
        cids[b, :n] = np.sort(rng.choice(10, n, replace=False))
        lengths[b] = cids[b, n - 1] * chunk + rng.randint(1, chunk)
        kg[b, n:] = 0
        vg[b, n:] = 0
    pos = np.full((B, nmax * chunk + 1), np.iinfo(np.int64).max, np.int64)
    for b in range(B):
        sel = cids[b][cids[b] >= 0]
        p = (sel[:, None] * chunk + np.arange(chunk)[None]).reshape(-1)
        pos[b, :len(p)] = p
    valid = pos < lengths[:, None]
    valid[:, -1] = True
    qj, qt = _both(rng.randn(B, 1, H, hd).astype(np.float32), dtype)
    knj, knt = _both(rng.randn(B, 1, Hkv, hd).astype(np.float32), dtype)
    vnj, vnt = _both(rng.randn(B, 1, Hkv, hd).astype(np.float32), dtype)
    eye = jnp.eye(H * hd, dtype=qj.dtype)
    y_j = j_attend_workingset(qj, jnp.asarray(kg), jnp.asarray(vg), knj,
                              vnj, jnp.asarray(valid)[:, None, None], eye,
                              attn_softcap=softcap)
    args = (torch.from_numpy(cids), torch.from_numpy(lengths), knt, vnt,
            softcap)
    y_t = sparse_decode_workingset(qt[:, 0], torch.from_numpy(kg),
                                   torch.from_numpy(vg), *args)
    assert y_t.dtype == qt.dtype
    if dtype == np.float32:
        np.testing.assert_allclose(_np(y_t).reshape(B, 1, H * hd), _np(y_j),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_bf16_close(_np(y_t).reshape(B, 1, H * hd), _np(y_j))
    slab, slots = workingset_slab(torch.from_numpy(kg), torch.from_numpy(vg))
    assert torch.equal(y_t, sparse_decode_pooled(qt[:, 0], slab, slots,
                                                 *args))


@pytest.mark.parametrize("nmax,B,Hkv,n_sm", [
    (1, 1, 1, 132), (1, 4, 32, 132), (16, 4, 32, 132), (3, 1, 1, 132),
    (80, 4, 32, 132), (500, 4, 32, 132), (500, 1, 8, 132), (7, 2, 2, 4),
    (0, 2, 2, 132),
])
def test_split_plan_covers_every_row_once(nmax, B, Hkv, n_sm):
    """Every one of the nmax * chunk + 1 rows lies in exactly one split,
    in order, each split covers whole selection entries (at least one when
    there are any), the new token's row is the last split's, and the grid
    reaches BLOCKS_PER_SM blocks per SM where there are entries enough.
    nmax 80 is longchat's 32k selection (rate 0.10 of 500 chunks of 64
    plus hot ones), 500 the whole 32k context."""
    chunk = 64
    nsplit, cps = split_plan(nmax, B, Hkv, n_sm)
    assert nsplit >= 1 and cps >= 1
    rows = split_rows(nmax, chunk, nsplit, cps)
    assert len(rows) == nsplit
    flat = [t for r in rows for t in r]
    assert flat == list(range(nmax * chunk + 1))
    assert rows[-1][-1] == nmax * chunk
    for r in rows[:-1] if nmax else []:
        assert r and len(r) % chunk == 0 and r[0] % chunk == 0
    if nmax:
        assert nsplit * B * Hkv >= min(BLOCKS_PER_SM * n_sm, nmax * B * Hkv)


def _split_inputs(rng, dtype, B, H, Hkv, hd, chunk, nmax, live):
    """Pool inputs with ``live[b]`` selected chunks for sequence b (0: an
    all-padding row of the selection) and the rest -1 padding."""
    n_slots = B * nmax
    pool = rng.randn(n_slots + 1, 2, chunk, Hkv, hd).astype(np.float16)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b, n in enumerate(live):
        slots[b, :n] = rng.choice(n_slots, n, replace=False)
        cids[b, :n] = np.sort(rng.choice(4 * nmax, n, replace=False))
        lengths[b] = (cids[b, n - 1] * chunk + rng.randint(1, chunk)
                      if n else rng.randint(0, 3 * chunk))
    q, kn, vn = (_both(rng.randn(B, 1, k, hd).astype(np.float32), dtype)
                 for k in (H, Hkv, Hkv))
    return pool, slots, cids, lengths, q, kn, vn


@pytest.mark.parametrize("B,H,Hkv,hd,chunk,nmax,live", [
    (3, 4, 2, 16, 8, 6, (6, 0, 2)),          # an all-padding sequence
    (2, 8, 8, 32, 16, 12, (12, 3)),          # splits beyond the live chunks
    (1, 32, 32, 128, 64, 24, (17,)),
])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_split_emulation_matches_plain_and_attend_pooled(
        rng, B, H, Hkv, hd, chunk, nmax, live, dtype, softcap):
    """The kernel's split arithmetic (split maxima, one global max, p
    rounded against it, f32 partials added in split order) in plain
    PyTorch against sparse_decode_pooled_ref and JAX's _attend_pooled,
    for the plan the wrapper picks and for one chunk per split and one
    split in all."""
    pool, slots, cids, lengths, (qj, qt), (knj, knt), (vnj, vnt) = \
        _split_inputs(rng, dtype, B, H, Hkv, hd, chunk, nmax, live)
    args = (qt[:, 0], torch.from_numpy(pool), torch.from_numpy(slots),
            torch.from_numpy(cids), torch.from_numpy(lengths), knt, vnt,
            softcap)
    ref = sparse_decode_pooled(*args)
    y_j = _np(j_attend_pooled(qj, jnp.asarray(pool), jnp.asarray(slots),
                              jnp.asarray(cids), jnp.asarray(lengths), knj,
                              vnj, jnp.eye(H * hd, dtype=qj.dtype),
                              attn_softcap=softcap)).reshape(B, H, hd)
    for nsplit, cps in (split_plan(nmax, B, Hkv), (nmax, 1), (1, nmax)):
        out = sparse_decode_pooled_split_ref(*args, nsplit=nsplit,
                                             chunks_per_split=cps)
        assert out.dtype == qt.dtype
        if dtype == np.float32:
            np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(_np(out), y_j, rtol=1e-5, atol=1e-5)
        else:
            assert_bf16_close(_np(out), _np(ref))
            assert_bf16_close(_np(out), y_j)


@pytest.mark.parametrize("fault", [None, "p", "kv", "scale"])
def test_bf16_bar_rejects_a_skipped_cast_point(rng, fault):
    """At the main path's shapes (longchat: H = Hkv = 32, hd 128, chunk
    64, ~12 selected chunks per sequence), the bar of bf16_agreement
    accepts the plain version's arithmetic with its sums taken in f64,
    and rejects it with one cast point skipped: probabilities (p), K/V
    (kv) or 1/sqrt(hd) (scale) not rounded to bf16."""
    B, H, hd, chunk, nmax = 4, 32, 128, 64, 12
    lengths = np.array([1552, 2064, 3088, 3600], np.int32)
    pool = torch.from_numpy(
        rng.randn(B * nmax + 1, 2, chunk, H, hd).astype(np.float16))
    slots = rng.permutation(B * nmax).reshape(B, nmax).astype(np.int32)
    cids = np.stack([np.sort(rng.choice(-(-L // chunk), nmax, replace=False))
                     for L in lengths]).astype(np.int32)
    q, k_new, v_new = (torch.from_numpy(rng.randn(B, H, hd).astype(
        np.float32)).bfloat16() for _ in range(3))
    ref = sparse_decode_pooled(q, pool, torch.from_numpy(slots),
                               torch.from_numpy(cids),
                               torch.from_numpy(lengths), k_new, v_new)

    f64 = torch.float64
    kv = pool[torch.from_numpy(slots).long()]         # (B, nmax, 2, c, H, hd)
    pos = (torch.from_numpy(cids).long()[..., None] * chunk
           + torch.arange(chunk)).reshape(B, -1)
    ok = torch.cat([pos < torch.from_numpy(lengths).long()[:, None],
                    torch.ones(B, 1, dtype=torch.bool)], 1)[:, None]
    kk, vv = (kv[:, :, i].reshape(B, -1, H, hd) for i in (0, 1))
    if fault != "kv":
        kk, vv = kk.bfloat16(), vv.bfloat16()
    kk = torch.cat([kk.to(f64), k_new[:, None].to(f64)], 1)
    vv = torch.cat([vv.to(f64), v_new[:, None].to(f64)], 1)
    scale = 1 / np.sqrt(hd) if fault == "scale" else model_scale(hd,
                                                                 q.dtype)
    qs = (q.double() * scale).bfloat16().to(f64)
    sc = torch.einsum("bhd,bshd->bhs", qs, kk).masked_fill(~ok, -np.inf)
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = e if fault == "p" else e.float().bfloat16().to(f64)
    out = (torch.einsum("bhs,bshd->bhd", p, vv)
           / e.sum(-1, keepdim=True)).bfloat16()

    err, bar, frac = bf16_agreement(out, ref)
    if fault is None:
        assert err <= bar and frac <= BF16_MAX_MISMATCH, (err, bar, frac)
    else:
        assert frac > BF16_MAX_MISMATCH, (err, bar, frac)


def test_contract_bar_sees_unrounded_probabilities():
    """``contract_agreement``'s bar at bf16 (B2's contract entry, as
    ``lm.decode_step`` runs it) is tight enough to see a P.V that leaves
    each probability unrounded: on ``tied_contract_case`` the plain
    version with an f32 q misses it by more than four bars, while the
    plain version with each selection reversed (the same rows summed in
    another order) stays within it."""
    q, k, v, ids, length = tied_contract_case(torch.device("cpu"))
    num, den, _ = sparse_decode_ref(q, k, v, ids, length, chunk=64)
    out = num / den[..., None]
    nf, df, _ = sparse_decode_ref(q, k, v, ids.flip(-1), length, chunk=64)
    err, bar = contract_agreement(nf / df[..., None], out, v, den,
                                  torch.bfloat16)
    assert err <= bar, (err, bar)
    nu, du, _ = sparse_decode_ref(q.float(), k, v, ids, length, chunk=64)
    err_u, _ = contract_agreement(nu / du[..., None], out, v, den,
                                  torch.bfloat16)
    assert err_u > 4 * bar, (err_u, bar)


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("N,c,d", [(1, 8, 16), (4, 16, 64), (2, 64, 128),
                                   (3, 32, 256)])
def test_kv_dequant_plain_bitwise_equal_to_jax(rng, codec, N, c, d):
    dp = d if codec == "int8" else d // 2
    data = rng.randint(-128, 128, (N, c, dp)).astype(np.int8)
    scale = (np.abs(rng.randn(N, d)) + 0.01).astype(np.float32)
    for jdt, tdt in ((jnp.float16, torch.float16),
                     (jnp.bfloat16, torch.bfloat16)):
        o_t = t_kv_dequant(torch.from_numpy(data), torch.from_numpy(scale),
                           codec=codec, out_dtype=tdt)
        for impl in ("ref", "interpret"):
            o_j = j_kv_dequant(jnp.asarray(data), jnp.asarray(scale),
                               codec=codec, out_dtype=jdt, impl=impl)
            assert np.array_equal(o_t.float().numpy(), _np(o_j))


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("N,c,d", [(1, 8, 16), (4, 16, 64), (2, 64, 128),
                                   (3, 32, 256)])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_kv_dequant_scatter_plain_bitwise_equal_to_jax(rng, codec, N, c, d,
                                                       dtype):
    """The K and V planes of N chunks, stacked plane-major as the store
    stacks them, land in permuted slots of a sentinel-filled slab exactly
    where numpy scatters the JAX dequant; the other slots keep their
    values, and no launch is counted on the CPU."""
    from repro_torch.kernels.kv_quant import ops as kq
    jdt, tdt = {"float16": (jnp.float16, torch.float16),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    planes, hkv, S = 2, 2, N + 3
    dp = d if codec == "int8" else d // 2
    data = rng.randint(-128, 128, (planes * N, c, dp)).astype(np.int8)
    scale = (np.abs(rng.randn(planes * N, d)) + 0.01).astype(np.float32)
    slots = rng.permutation(S)[:N]
    sentinel = torch.from_numpy(
        rng.randn(S, planes, c, hkv, d // hkv).astype(np.float32)).to(tdt)
    slab = sentinel.clone()
    before = kq.launches
    kq.kv_dequant_scatter(torch.from_numpy(data), torch.from_numpy(scale),
                          slab, slots.tolist(), codec=codec)
    assert kq.launches == before
    for impl in ("ref", "interpret"):
        o_j = _np(j_kv_dequant(jnp.asarray(data), jnp.asarray(scale),
                               codec=codec, out_dtype=jdt, impl=impl))
        want = sentinel.float().numpy()
        want[slots] = o_j.reshape(planes, N, c, hkv, d // hkv).transpose(
            1, 0, 2, 3, 4)
        assert np.array_equal(slab.float().numpy(), want)


@pytest.mark.parametrize("codec,d,offset,dtype,width", [
    ("int4", 4096, 0, torch.float16, 4),     # the main path: 16-byte stores
    ("int8", 4096, 0, torch.bfloat16, 8),
    ("int4", 4096, 0, torch.float32, 2),
    ("int8", 4096, 0, torch.float32, 4),
    ("int4", 16, 0, torch.float16, 4),
    ("int4", 12, 0, torch.float16, 2),       # 6-byte packed rows
    ("int8", 6, 0, torch.float16, 2),
    ("int4", 10, 0, torch.float16, 1),       # 5-byte packed rows
    ("int8", 7, 0, torch.bfloat16, 1),
    ("int4", 64, 1, torch.float16, 1),       # a slab 2 bytes off alignment
    ("int8", 64, 4, torch.float16, 4),       # 8 bytes off: 8-byte stores
    ("int4", 64, 8, torch.float16, 4),       # 16 bytes off: aligned again
])
def test_access_width_follows_shape_and_alignment(codec, d, offset, dtype,
                                                  width):
    """The widest payload access whose outputs make one store of at most
    16 bytes, that the packed row width and every pointer allow."""
    from repro_torch.kernels.kv_quant import ops as kq
    dp = d if codec == "int8" else d // 2
    data = torch.zeros(2, 4, dp, dtype=torch.int8)
    scale = torch.ones(2, d)
    out = torch.zeros(2 * 4 * d + offset, dtype=dtype)[offset:]
    assert data.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
    assert kq.access_width(codec, data, scale, out) == width


@pytest.mark.parametrize("case", ["duplicate", "negative", "past_end",
                                  "dtype", "rank", "width", "chunk",
                                  "noncontiguous", "payload", "scale"])
def test_kv_dequant_scatter_refuses_a_bad_call(case):
    """Duplicate or out-of-range slots, a slab the kernel cannot write
    (dtype, rank, Hkv·hd ≠ d, another chunk length, not contiguous) and a
    payload that is not planes·n chunk planes raise ValueError, and nothing
    is written."""
    from repro_torch.kernels.kv_quant import ops as kq
    planes, n, c, hkv, hd, S = 2, 3, 4, 2, 8, 6
    data = torch.zeros(planes * n, c, hkv * hd // 2, dtype=torch.int8)
    scale = torch.ones(planes * n, hkv * hd)
    slab = torch.zeros(S, planes, c, hkv, hd, dtype=torch.float16)
    slots = [4, 0, 2]
    if case == "duplicate":
        slots = [4, 0, 4]
    elif case == "negative":
        slots = [-1, 0, 2]
    elif case == "past_end":
        slots = [4, 0, S]
    elif case == "dtype":
        slab = slab.double()
    elif case == "rank":
        slab = slab.reshape(S, planes, c, hkv * hd)
    elif case == "width":
        slab = torch.zeros(S, planes, c, hkv, hd + 2, dtype=torch.float16)
    elif case == "chunk":
        slab = torch.zeros(S, planes, c + 1, hkv, hd, dtype=torch.float16)
    elif case == "noncontiguous":
        slab = torch.zeros(S, planes, c, hd, hkv,
                           dtype=torch.float16).transpose(3, 4)
    elif case == "payload":
        data = data[:-1]
    elif case == "scale":
        scale = scale[:, :-2]
    keep = slab.clone()
    with pytest.raises(ValueError):
        kq.kv_dequant_scatter(data, scale, slab, slots, codec="int4")
    assert torch.equal(slab, keep)


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("n,c,H,hd", [(1, 8, 2, 8), (3, 16, 4, 16),
                                      (2, 64, 2, 64)])
def test_quantize_chunks_bitwise_equal_to_jax(rng, codec, n, c, H, hd):
    k = (rng.randn(n, c, H, hd) * 3).astype(np.float16)
    k[0, :, 0, :] = 0                        # an all-zero channel group
    d_j, s_j = jcomp.quantize_chunks(k, codec)
    d_t, s_t = tcomp.quantize_chunks(k, codec)
    assert d_t.dtype == d_j.dtype and s_t.dtype == s_j.dtype
    assert np.array_equal(d_t, d_j) and np.array_equal(s_t, s_j)
    assert tcomp.packed_dim(codec, H * hd) == jcomp.packed_dim(codec, H * hd)
    assert tcomp.packed_chunk_bytes(codec, c, H * hd) == \
        jcomp.packed_chunk_bytes(codec, c, H * hd)
    assert tcomp.codec_ratio(codec, c) == jcomp.codec_ratio(codec, c)


def test_wrappers_take_the_plain_version_on_cpu_without_counting(rng):
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.sparse_decode import ops as sd
    before = (cb.launches, kq.launches, sd.launches)
    q = torch.from_numpy(rng.randn(1, 2, 1, 8).astype(np.float32))
    km = torch.from_numpy(rng.randn(1, 2, 3, 8).astype(np.float32))
    cb.chunk_bounds(q, km, km - 1)
    kq.kv_dequant(torch.zeros(1, 2, 4, dtype=torch.int8),
                  torch.ones(1, 8), codec="int4")
    kq.kv_dequant_scatter(torch.zeros(2, 2, 4, dtype=torch.int8),
                          torch.ones(2, 8), torch.zeros(3, 2, 2, 2, 4),
                          [1], codec="int4")
    kg = torch.zeros(1, 2, 4, 2, 8)
    sd.sparse_decode_workingset(q[:, :, 0], kg, kg,
                                torch.tensor([[0, -1]], dtype=torch.int32),
                                torch.tensor([3], dtype=torch.int32),
                                kg[:, 0, :1], kg[:, 0, :1])
    assert (cb.launches, kq.launches, sd.launches) == before
    with pytest.raises(ValueError):                  # neither CPU nor CUDA
        cb.chunk_bounds(q.to("meta"), km.to("meta"), km.to("meta"))
    with pytest.raises(ValueError):
        cb.chunk_bounds(q, km, km - 1, impl="pallas")
