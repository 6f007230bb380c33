"""Hand-written Hopper kernels of the port against their plain PyTorch
versions, on the card.  CUDA kernels have no CPU mode, so every test here
is marked ``requires_cuda`` and skips without a device.  Run on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: the kernels sum in another order than the plain einsums, so
f32 results agree to rtol 1e-5 (fp16 and bf16 bounds queries are widened
to f32 exactly, same bar); a bf16 model's attention output is held by ``bf16_agreement``
(at most 5 % of the elements differ, by at most two bf16 ulps of
max|ref|: an f32 sum that lands next to a rounding boundary); the dequant
must be bitwise equal.  The PQ assign (B4) repeats the plain version's
lane order with unfused products and sums, so its codes are bitwise equal,
ties included: its tensor-core screen only picks the candidates that the
exact chain then decides.  The PQ update (B5) adds in the order that its
plain version repeats (runs of rows, folded by block, then over blocks),
so its sums and counts are bitwise equal, and so are two launches (no
float atomics).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_bounds import ops as cb_ops
from repro_torch.kernels.kv_quant import ops as kq_ops
from repro_torch.kernels.pq import ops as pq_ops
from repro_torch.kernels.sparse_decode import ops as sd_ops
from repro_torch.kernels.sparse_decode.ref import (
    BF16_MAX_MISMATCH, bf16_agreement, contract_agreement, latent_agreement,
    latent_pooled_den, sparse_decode_latent_pooled_ref, tied_contract_case,
    tied_latent_case)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("B,Hkv,G,hd,nc", [
    (1, 1, 1, 8, 4), (2, 4, 2, 32, 16), (1, 2, 3, 128, 7),
    (2, 8, 1, 64, 130), (1, 16, 6, 192, 33), (4, 32, 1, 128, 64),
    (4, 32, 1, 128, 57),            # the main path's shape
    (1, 3, 2, 256, 9), (2, 5, 1, 12, 5), (1, 40, 1, 128, 3),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_chunk_bounds_cuda(cuda, rng, B, Hkv, G, hd, nc, dtype):
    q = _t(rng.randn(B, Hkv, G, hd).astype(np.float32), cuda, dtype)
    km = _t(rng.randn(B, Hkv, nc, hd).astype(np.float32), cuda)
    kn = km - _t(np.abs(rng.randn(B, Hkv, nc, hd)).astype(np.float32), cuda)
    ub_r, lb_r = cb_ops.chunk_bounds(q, km, kn, impl="ref")
    ub_k, lb_k = cb_ops.chunk_bounds(q, km, kn)
    torch.testing.assert_close(ub_k, ub_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(lb_k, lb_r, rtol=1e-5, atol=1e-4)
    # engine layout: (B, H, hd) queries against (B, nc, Hkv, hd) abstracts
    qe = q.reshape(B, Hkv * G, hd)
    kme, kne = km.transpose(1, 2).contiguous(), kn.transpose(1, 2).contiguous()
    ue_r, le_r = cb_ops.chunk_bounds_gqa(qe, kme, kne, impl="ref")
    ue_k, le_k = cb_ops.chunk_bounds_gqa(qe, kme, kne)
    torch.testing.assert_close(ue_k, ue_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(le_k, le_r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hd", [6, 260])
def test_chunk_bounds_unsupported_hd_raises(cuda, rng, hd):
    """hd must be a multiple of 4 up to 256; others raise, and never run
    the plain version instead."""
    q = _t(rng.randn(1, 2, 1, hd).astype(np.float32), cuda)
    km = _t(rng.randn(1, 2, 3, hd).astype(np.float32), cuda)
    before = cb_ops.launches
    with pytest.raises(ValueError, match="CUDA contract"):
        cb_ops.chunk_bounds(q, km, km - 1)
    assert cb_ops.launches == before


def _cuda_kernels(fn, attempts: int = 5):
    """Names of the CUDA kernels that one call of ``fn`` launches, read by
    torch.profiler after a warm-up call (the build, the allocator).  A
    trace in which the profiler caught no device activity at all is taken
    again, up to ``attempts`` calls (the profiler sometimes returns such a
    trace on the card; ``chip_smoke.py`` retakes them too)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


@pytest.mark.parametrize("kernel", ["b1_bf16", "b1_f32", "b1_pallas",
                                    "b1_latent", "b2_latent", "b3",
                                    "b3_scatter", "b5"])
def test_cuda_kernels_per_call(cuda, rng, kernel):
    """B1 (any q dtype, either layout) and B1-latent are one CUDA kernel,
    B5 and B2-latent two (B5: the partials, then their fold; B2-latent:
    the scores, then P.V with the combine): no cast of q, no fill of
    outputs or counters that the kernels write in full.  B3 is one CUDA
    kernel on either entry; the scatter's only other device work is the
    copy of its slot list."""
    if kernel == "b1_latent":
        q = _t(rng.randn(4, 16, 576).astype(np.float32), cuda,
               torch.bfloat16)
        km = _t(rng.randn(4, 57, 1, 576).astype(np.float32), cuda)
        kn = km - 1.0
        fn = lambda: cb_ops.chunk_bounds_latent(q, km, kn)
    elif kernel == "b2_latent":
        args = _latent_inputs(rng, cuda, 4, 16, 576, 64, 36, 12,
                              torch.bfloat16)
        fn = lambda: sd_ops.sparse_decode_latent_pooled(*args, 512)
    elif kernel.startswith("b1"):
        dtype = torch.float32 if kernel == "b1_f32" else torch.bfloat16
        q = _t(rng.randn(4, 32, 128).astype(np.float32), cuda, dtype)
        km = _t(rng.randn(4, 57, 32, 128).astype(np.float32), cuda)
        kn = km - 1.0
        if kernel == "b1_pallas":
            kmt, knt = km.transpose(1, 2).contiguous(), kn.transpose(1, 2) \
                .contiguous()
            fn = lambda: cb_ops.chunk_bounds(q.reshape(4, 32, 1, 128), kmt,
                                             knt)
        else:
            fn = lambda: cb_ops.chunk_bounds_gqa(q, km, kn)
    elif kernel.startswith("b3"):
        data, scale, slab, slots = _scatter_inputs(rng, cuda, "int4", 16, 64,
                                                   4096, torch.float16)
        fn = (lambda: kq_ops.kv_dequant_scatter(data, scale, slab, slots,
                                                codec="int4")) \
            if kernel == "b3_scatter" else \
            (lambda: kq_ops.kv_dequant(data, scale, codec="int4",
                                       out_dtype=torch.float16))
    else:
        x, _ = _pq_inputs(rng, cuda, 16, 114688, 8, 256)
        codes = _t(rng.randint(0, 256, (16, 114688)).astype(np.int32), cuda)
        fn = lambda: pq_ops.pq_update(x, codes, 256)
    names = _cuda_kernels(fn)
    if kernel.startswith("b3"):
        kernels = [n for n in names if not n.startswith("Memcpy")]
        copies = [n for n in names if n.startswith("Memcpy HtoD")]
        assert len(kernels) == 1 and "kv_dequant_scatter" in kernels[0], \
            names
        assert len(names) - 1 == len(copies) <= (kernel == "b3_scatter"), \
            names
    elif kernel == "b5":
        assert len(names) == 2 and all("pq_update" in n for n in names), names
    elif kernel == "b2_latent":
        assert len(names) == 2 and "lat_scores" in names[0] \
            and "lat_pv" in names[1], names
    else:
        assert len(names) == 1 and "chunk_bounds" in names[0], names


@pytest.mark.parametrize("B,Hkv,G,hd,S,chunk,nsel", [
    (1, 1, 1, 8, 64, 8, 3), (2, 2, 2, 32, 128, 16, 4),
    (1, 4, 1, 128, 256, 64, 3), (2, 1, 3, 64, 512, 32, 8),
    (1, 2, 4, 192, 256, 128, 2),
])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_sparse_decode_cuda(cuda, rng, B, Hkv, G, hd, S, chunk, nsel,
                            kv_dtype):
    q = _t(rng.randn(B, Hkv, G, hd).astype(np.float32) / np.sqrt(hd), cuda)
    k = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, kv_dtype)
    v = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, kv_dtype)
    nc = S // chunk
    ids = _t(np.stack([
        np.stack([rng.choice(nc, nsel, replace=False) for _ in range(Hkv)])
        for _ in range(B)]).astype(np.int32), cuda)
    length = S - chunk // 2
    outs_r = sd_ops.sparse_decode(q, k, v, ids, length, chunk=chunk,
                                  impl="ref")
    outs_k = sd_ops.sparse_decode(q, k, v, ids, length, chunk=chunk)
    for r, kk in zip(outs_r, outs_k):
        torch.testing.assert_close(kk, r, rtol=1e-5, atol=1e-4)


def _pooled_inputs(rng, dev, B, H, Hkv, hd, chunk, n_slots, nmax, dtype):
    pool = _t(rng.randn(n_slots + 1, 2, chunk, Hkv, hd).astype(np.float16),
              dev)
    q = _t(rng.randn(B, H, hd).astype(np.float32), dev, dtype)
    k_new = _t(rng.randn(B, 1, Hkv, hd).astype(np.float32), dev, dtype)
    v_new = _t(rng.randn(B, 1, Hkv, hd).astype(np.float32), dev, dtype)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(1, nmax + 1)
        slots[b, :n] = rng.choice(n_slots, n, replace=False)
        cids[b, :n] = np.sort(rng.choice(4 * nmax, n, replace=False))
        lengths[b] = cids[b, n - 1] * chunk + rng.randint(1, chunk + 1)
    return (q, pool, _t(slots, dev), _t(cids, dev), _t(lengths, dev), k_new,
            v_new)


@pytest.mark.parametrize("B,H,Hkv,hd,chunk,nmax", [
    (3, 4, 4, 16, 16, 8), (2, 8, 2, 64, 32, 5), (4, 32, 32, 128, 64, 20),
    (1, 8, 8, 128, 64, 200),        # a long selection: many splits
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_sparse_decode_pooled_cuda(cuda, rng, B, H, Hkv, hd, chunk, nmax,
                                   dtype, softcap):
    args = _pooled_inputs(rng, cuda, B, H, Hkv, hd, chunk, 3 * nmax, nmax,
                          dtype)
    ref = sd_ops.sparse_decode_pooled(*args, softcap, impl="ref")
    out = sd_ops.sparse_decode_pooled(*args, softcap)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        err, bar, frac = bf16_agreement(out, ref)
        assert err <= bar and frac <= BF16_MAX_MISMATCH, (err, bar, frac)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_decode_pooled_cuda_shared_slots(cuda, rng, dtype):
    """The shared-prefix cache's slot table: sequences that adopted one
    prefix read the same pool slots for its chunks (a shared head of
    chunk ids and slots, private tails) — B2 against its plain version."""
    B, H, Hkv, hd, chunk, nmax, shared = 4, 32, 32, 128, 64, 24, 16
    q, pool, _, _, _, k_new, v_new = _pooled_inputs(
        rng, cuda, B, H, Hkv, hd, chunk, 3 * nmax, nmax, dtype)
    head = rng.choice(3 * nmax, shared, replace=False)
    rest = np.setdiff1d(np.arange(3 * nmax), head)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        n = nmax - b                        # ragged private tails
        tail = rng.choice(rest, n - shared, replace=False)
        slots[b, :n] = np.concatenate([head, tail])
        cids[b, :n] = np.arange(n)
        lengths[b] = (n - 1) * chunk + rng.randint(1, chunk + 1)
    args = (q, pool, _t(slots, cuda), _t(cids, cuda), _t(lengths, cuda),
            k_new, v_new)
    ref = sd_ops.sparse_decode_pooled(*args, impl="ref")
    out = sd_ops.sparse_decode_pooled(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        err, bar, frac = bf16_agreement(out, ref)
        assert err <= bar and frac <= BF16_MAX_MISMATCH, (err, bar, frac)


def _long_inputs(rng, dev, B, H, Hkv, hd, chunk, nmax, live, length,
                 dtype=torch.bfloat16):
    """Pool inputs of ``B`` sequences of ``length`` tokens, each with
    ``live`` chunks selected out of length / chunk (sorted, the last
    chunk always among them) and the rest of nmax -1 padding."""
    nc = -(-length // chunk)
    n_slots = B * live
    pool = _t(rng.randn(n_slots + 1, 2, chunk, Hkv, hd).astype(np.float16),
              dev)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    for b in range(B):
        slots[b, :live] = rng.permutation(n_slots)[:live]
        cids[b, :live] = np.sort(np.concatenate([
            rng.choice(nc - 1, live - 1, replace=False), [nc - 1]]))
    lengths = np.full(B, length, np.int32)
    q = _t(rng.randn(B, H, hd).astype(np.float32), dev, dtype)
    k_new = _t(rng.randn(B, 1, Hkv, hd).astype(np.float32), dev, dtype)
    v_new = _t(rng.randn(B, 1, Hkv, hd).astype(np.float32), dev, dtype)
    return (q, pool, _t(slots, dev), _t(cids, dev), _t(lengths, dev), k_new,
            v_new)


@pytest.mark.parametrize("B,H,Hkv,hd,nmax,live,length,softcap", [
    (4, 32, 32, 128, 80, 80, 32000, None),     # longchat at 32k, rate 0.10
    (1, 32, 32, 128, 500, 500, 32000, None),   # the whole 32k context
    (1, 8, 2, 64, 300, 300, 19200, 50.0),      # G 4: scores past the old
                                               # one-block shared memory
    (2, 16, 4, 128, 96, 3, 4000, 30.0),        # most splits all padding
])
def test_sparse_decode_pooled_cuda_long(cuda, rng, B, H, Hkv, hd, nmax,
                                        live, length, softcap):
    args = _long_inputs(rng, cuda, B, H, Hkv, hd, 64, nmax, live, length)
    ref = sd_ops.sparse_decode_pooled(*args, softcap, impl="ref")
    out = sd_ops.sparse_decode_pooled(*args, softcap)
    err, bar, frac = bf16_agreement(out, ref)
    assert err <= bar and frac <= BF16_MAX_MISMATCH, (err, bar, frac)


def test_sparse_decode_pooled_cuda_all_padding_sequence(cuda, rng):
    """A sequence whose selection is all padding attends only its new
    token (den from that row alone); its neighbours are unaffected."""
    args = list(_pooled_inputs(rng, cuda, 3, 8, 2, 64, 32, 30, 10,
                               torch.bfloat16))
    args[3][1] = -1
    ref = sd_ops.sparse_decode_pooled(*args, impl="ref")
    out = sd_ops.sparse_decode_pooled(*args)
    err, bar, frac = bf16_agreement(out, ref)
    assert err <= bar and frac <= BF16_MAX_MISMATCH, (err, bar, frac)
    v_new = args[6].reshape(3, 2, 1, 64).expand(3, 2, 4, 64).reshape(3, 8, 64)
    assert torch.equal(out[1], v_new[1])


@pytest.mark.parametrize("G", [1, 4])
def test_sparse_decode_cuda_two_launches_bitwise(cuda, rng, G):
    """No float atomics: two calls give bitwise-equal outputs, for both
    contracts."""
    args = _long_inputs(rng, cuda, 4, 32 * G, 32, 128, 64, 40, 40, 3600)
    a = sd_ops.sparse_decode_pooled(*args)
    b = sd_ops.sparse_decode_pooled(*args)
    assert torch.equal(a, b)
    q = _t(rng.randn(2, 4, G, 64).astype(np.float32) / 8, cuda)
    k = _t(rng.randn(2, 2048, 4, 64).astype(np.float32), cuda, torch.bfloat16)
    ids = _t(np.stack([np.stack([rng.choice(32, 20, replace=False)
                                 for _ in range(4)]) for _ in range(2)])
             .astype(np.int32), cuda)
    one = sd_ops.sparse_decode(q, k, k * 0.5, ids, 2000, chunk=64)
    two = sd_ops.sparse_decode(q, k, k * 0.5, ids, 2000, chunk=64)
    assert all(torch.equal(x, y) for x, y in zip(one, two))


def test_sparse_decode_launch_counter_counts_calls(cuda, rng):
    """``launches`` moves by one per call (two CUDA launches)."""
    args = _pooled_inputs(rng, cuda, 2, 8, 8, 64, 16, 12, 6, torch.bfloat16)
    before = sd_ops.launches
    sd_ops.sparse_decode_pooled(*args, impl="ref")
    assert sd_ops.launches == before
    sd_ops.sparse_decode_pooled(*args)
    assert sd_ops.launches == before + 1


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("N,c,d", [(1, 8, 16), (4, 16, 64), (2, 64, 128),
                                   (3, 32, 256), (16, 64, 4096)])
@pytest.mark.parametrize("out_dtype", [torch.float16, torch.bfloat16])
def test_kv_dequant_cuda_bitwise(cuda, rng, codec, N, c, d, out_dtype):
    dp = d if codec == "int8" else d // 2
    data = _t(rng.randint(-128, 128, (N, c, dp)).astype(np.int8), cuda)
    scale = _t(np.abs(rng.randn(N, d)).astype(np.float32) + 0.01, cuda)
    ref = kq_ops.kv_dequant(data, scale, codec=codec, out_dtype=out_dtype,
                            impl="ref")
    out = kq_ops.kv_dequant(data, scale, codec=codec, out_dtype=out_dtype)
    assert torch.equal(out, ref)


def _scatter_inputs(rng, dev, codec, n, c, d, dtype, offset=0, extra=3):
    """A plane-major payload of n chunks (the K planes, then the V planes,
    with V's scales apart from K's), a slab of n + extra slots filled with
    sentinel values and starting ``offset`` elements into its buffer, and
    n permuted slots that are not contiguous."""
    dp = d if codec == "int8" else d // 2
    data = _t(rng.randint(-128, 128, (2 * n, c, dp)).astype(np.int8), dev)
    scale = np.abs(rng.randn(2 * n, d)).astype(np.float32) + 0.01
    scale[n:] *= 3.0
    hkv = d // 128 if d >= 256 else 2 if d % 2 == 0 else 1
    shape = (n + extra, 2, c, hkv, d // hkv)
    buf = _t(rng.randn(int(np.prod(shape)) + offset).astype(np.float32),
             dev, dtype)
    slab = buf[offset:].view(shape)
    slots = rng.permutation(n + extra)[:n].tolist()
    return data, _t(scale, dev), slab, slots


def _scatter_matches_plain(codec, data, scale, slab, slots):
    """The kernel's slab equals the plain version's bitwise, and the slots
    it was not given keep their sentinels."""
    ref = slab.clone()
    kq_ops.kv_dequant_scatter(data, scale, ref, slots, codec=codec,
                              impl="ref")
    keep = slab.clone()
    kq_ops.kv_dequant_scatter(data, scale, slab, slots, codec=codec)
    torch.cuda.synchronize()
    assert torch.equal(slab, ref)
    rest = [s for s in range(slab.shape[0]) if s not in slots]
    assert torch.equal(slab[rest], keep[rest])


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("N,c,d", [(1, 8, 16), (4, 16, 64), (2, 64, 128),
                                   (3, 32, 256), (16, 64, 4096),
                                   (48, 64, 4096)])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_kv_dequant_scatter_cuda_bitwise(cuda, rng, codec, N, c, d, dtype):
    data, scale, slab, slots = _scatter_inputs(rng, cuda, codec, N, c, d,
                                               dtype)
    _scatter_matches_plain(codec, data, scale, slab, slots)


@pytest.mark.parametrize("codec,d,offset,width", [
    ("int4", 16, 0, 4),        # 8-byte packed rows
    ("int8", 16, 0, 8),        # 16-byte rows
    ("int4", 8, 0, 4),         # one unit a row
    ("int8", 12, 0, 4),
    ("int4", 12, 0, 2),        # 6-byte packed rows
    ("int8", 6, 0, 2),
    ("int4", 10, 0, 1),        # 5-byte packed rows
    ("int8", 7, 0, 1),
    ("int4", 64, 1, 1),        # a slab 2 bytes off alignment
    ("int8", 64, 4, 4),        # 8 bytes off: 8-byte stores
    ("int4", 64, 8, 4),        # 16 bytes off: aligned again
])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_kv_dequant_scatter_cuda_narrow_widths(cuda, rng, codec, d, offset,
                                               width, dtype):
    """Rows that are not a multiple of 16 bytes, and a slab that is not
    16-byte aligned, take a narrower access in the same kernel."""
    data, scale, slab, slots = _scatter_inputs(rng, cuda, codec, 5, 24, d,
                                               dtype, offset=offset)
    assert kq_ops.access_width(codec, data, scale, slab) == width
    _scatter_matches_plain(codec, data, scale, slab, slots)


def test_kv_dequant_scatter_cuda_two_launches_bitwise(cuda, rng):
    data, scale, slab, slots = _scatter_inputs(rng, cuda, "int4", 16, 64,
                                               4096, torch.float16)
    other = slab.clone()
    kq_ops.kv_dequant_scatter(data, scale, slab, slots, codec="int4")
    kq_ops.kv_dequant_scatter(data, scale, other, slots, codec="int4")
    assert torch.equal(slab, other)


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_fetch_chunks_pooled_cuda_matches_plain_scatter(cuda, tmp_path,
                                                        theta):
    """The store's codec upload through the fused kernel leaves the same
    slab, slots and billing as the same store with the plain scatter, over
    rounds with evictions and queued decode-append rows."""
    from repro_torch.serving.offload import HOST, TieredKVStore
    L, NC, C, HKV, HD = 1, 8, 16, 4, 32
    stores = {impl: TieredKVStore(
        L, NC, C, HKV, HD, n_seqs=2, transit_codec="int4", use_pool=True,
        pool_slots=9, real_codec=True, root=str(tmp_path / str(impl)),
        device="cuda", impl=impl) for impl in (None, "ref")}
    out = {}
    before = kq_ops.launches
    for impl, store in stores.items():
        rng = np.random.RandomState(0)
        for seq in range(2):
            k = rng.randn(NC * C, HKV, HD).astype(np.float32)
            v = rng.randn(NC * C, HKV, HD).astype(np.float32)
            store.ingest(0, k, v, {c: HOST for c in range(NC)}, seq=seq)
        res = []
        for rnd in range(4):
            sels = {seq: sorted(rng.choice(NC, 4, replace=False).tolist())
                    for seq in range(2)}
            slots, nsel, st = store.fetch_chunks_pooled(0, sels, theta=theta)
            res.append((slots.tolist(), st.uploads, st.compressed,
                        st.upload_bytes))
            store.append_tokens_batch(
                0, np.array([NC * C - 8 + rnd] * 2),
                rng.randn(2, HKV, HD).astype(np.float32),
                rng.randn(2, HKV, HD).astype(np.float32), seqs=[0, 1])
        torch.cuda.synchronize()
        out[impl] = (res, store.pools[0].kv.clone(), store.codec_uploads)
        store.close()
    assert out[None][0] == out["ref"][0]
    assert torch.equal(out[None][1], out["ref"][1])
    assert out[None][2] == out["ref"][2] > 0
    assert kq_ops.launches > before


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_shared_prefix_fetch_dedupes_b3_slots_cuda(cuda, tmp_path, theta):
    """A pooled fetch where two sequences miss the same arena chunks
    (one registered them, the other adopted them): each arena chunk gets
    ONE slot and ONE upload, kernel B3 never sees a slot twice, and the
    slab, slots and billing equal the same store's with ``impl="ref"``,
    bit for bit."""
    from repro_torch.serving.offload import HOST, TieredKVStore
    L, NC, C, HKV, HD = 1, 8, 16, 4, 32
    out = {}
    before = kq_ops.launches
    for impl in (None, "ref"):
        st = TieredKVStore(L, NC, C, HKV, HD, n_seqs=2, prefix_rows=1,
                           transit_codec="int4", use_pool=True,
                           real_codec=True, root=str(tmp_path / str(impl)),
                           device="cuda", impl=impl)
        rng = np.random.RandomState(3)
        toks = np.arange(2, 2 + 4 * C)
        st.prefix_admit(0, toks)
        k = rng.randn(NC * C, HKV, HD).astype(np.float32)
        st.ingest(0, k, -k, {c: HOST for c in range(NC)}, seq=0)
        st.finish_admission(0)
        assert st.prefix_admit(1, toks) == 4 * C
        k1 = rng.randn(NC * C, HKV, HD).astype(np.float32)
        st.ingest(0, k1, -k1, {c: HOST for c in range(NC)}, seq=1)
        pool = st.pools[0]
        seen, scatter = [], pool.scatter

        def spy(slots, *a, **kw):
            seen.append(list(slots))
            return scatter(slots, *a, **kw)

        pool.scatter = spy
        slots, _, fs = st.fetch_chunks_pooled(
            0, {0: [0, 1, 2, 5], 1: [0, 1, 2, 3, 6]}, theta=theta)
        torch.cuda.synchronize()
        assert all(len(set(x)) == len(x) for x in seen)
        assert fs.uploads == 6                # 4 arena + 1 + 1 private
        assert slots[0, :3].tolist() == slots[1, :3].tolist()
        out[impl] = (slots.tolist(), fs.compressed, pool.kv.clone(),
                     dict(st.log.bytes), dict(st.log.ops))
        st.close()
    assert out[None][:2] == out["ref"][:2]
    assert torch.equal(out[None][2], out["ref"][2])
    assert out[None][3:] == out["ref"][3:]
    assert kq_ops.launches > before


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_deferred_placements_fold_into_a_codec_upload_cuda(
        cuda, tmp_path, monkeypatch, theta):
    """Deferred prefill placements (ingest with ``pool_place=False``, as an
    admission on the worker does) ride along with a pooled fetch's codec
    upload: the slab, slots and billing equal the same store's with
    ``impl="ref"``, and kernel B3's slot list holds the codec part of the
    delta only, never a placed slot."""
    from repro_torch.serving import offload
    from repro_torch.serving.offload import DEVICE, HOST, TieredKVStore
    L, NC, C, HKV, HD = 1, 8, 16, 4, 32
    lists = []
    real = offload.kv_dequant_scatter

    def spy(data, scale, slab, slots, **kw):
        lists.append(list(slots))
        return real(data, scale, slab, slots, **kw)

    monkeypatch.setattr(offload, "kv_dequant_scatter", spy)
    out = {}
    before = kq_ops.launches
    for impl in (None, "ref"):
        store = TieredKVStore(
            L, NC, C, HKV, HD, n_seqs=2, transit_codec="int4",
            use_pool=True, pool_slots=12, real_codec=True,
            root=str(tmp_path / str(impl)),
            device="cuda", impl=impl)
        rng = np.random.RandomState(0)
        place = {c: DEVICE if c < 2 else HOST for c in range(NC)}
        for seq in range(2):
            k = rng.randn(NC * C, HKV, HD).astype(np.float32)
            v = rng.randn(NC * C, HKV, HD).astype(np.float32)
            store.ingest(0, k, v, place, seq=seq, pool_place=False)
        assert len(store.pools[0].pending_place) == 4
        lists.clear()
        slots, _, st = store.fetch_chunks_pooled(
            0, {0: [2, 3, 4, 5], 1: [2, 3, 6, 7]}, theta=theta)
        pool = store.pools[0]
        placed = {pool.slot_of[(s, c)] for s in range(2) for c in range(2)}
        assert not pool.pending_place and len(lists) == 1
        assert len(lists[0]) == st.compressed == round(theta * 8)
        assert not placed & set(lists[0])
        torch.cuda.synchronize()
        out[impl] = (slots.tolist(), dict(pool.slot_of), st.upload_bytes,
                     dict(store.log.bytes), pool.kv.clone())
        store.close()
    for a, b in zip(out[None][:4], out["ref"][:4]):
        assert a == b
    assert torch.equal(out[None][4], out["ref"][4])
    assert kq_ops.launches == before + 1


def test_async_admission_on_its_stream_stores_the_sync_bytes(cuda, tmp_path):
    """``add_sequence_async`` runs the admission on the worker's own CUDA
    stream; what it stores (disk replica, abstracts), its first token and
    logits, and the next round's token equal a synchronous admission's,
    which runs on the decode thread's stream."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    cfg = get_config("longchat-7b-32k", smoke=True)
    cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, chunk_size=16))
    params = lm.init(cfg, seed=0, device=cuda)
    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, 100)
    res = {}
    for mode in ("sync", "async"):
        eng = BatchedLeoAMEngine(cfg, params, EngineCfg(max_len=128),
                                 device=cuda,
                                 store_root=str(tmp_path / mode))
        streams = []
        admit = eng._admit

        def spy(*a, _admit=admit, _streams=streams, **kw):
            _streams.append(torch.cuda.current_stream(cuda))
            return _admit(*a, **kw)

        eng._admit = spy
        if mode == "sync":
            sid, tok = eng.add_sequence(prompt)
            assert streams == [torch.cuda.default_stream(cuda)]
        else:
            sid, tok = eng.add_sequence_async(prompt).result(timeout=300)
            assert streams == [eng._admit_stream]
            assert streams[0] != torch.cuda.default_stream(cuda)
        eng.store.ingest_fence(sid)
        st = eng.store
        res[mode] = (tok, eng.seqs[sid].prefill_logits.copy(),
                     np.array(st._disk), st._abs_km.copy(),
                     st._abs_kn.copy(), eng.decode_round({sid: tok})[sid])
        st.close()
    for a, b in zip(res["sync"], res["async"]):
        assert np.array_equal(a, b)


def _sidecar_script(store, seed, theta):
    """Two sequences ingested over DEVICE/HOST/DISK placements with the
    packed sidecar, then four rounds of pooled promotion (packed disk
    reads dequantized on the host, the θ-part of each upload by kernel B3
    on the card) and appends, a sweep after each; returns the slots and
    stats of every fetch."""
    from repro_torch.serving.offload import DEVICE, DISK, HOST
    rng = np.random.RandomState(seed)
    nc, c = store.n_chunks, store.chunk
    place = {i: (DEVICE, HOST, DISK, DISK)[i % 4] for i in range(nc)}
    for seq in range(2):
        k = rng.randn(nc * c, store.kv_heads, store.head_dim)
        v = rng.randn(nc * c, store.kv_heads, store.head_dim)
        store.ingest(0, k.astype(np.float32), v.astype(np.float32), place,
                     seq=seq)
    res = []
    for rnd in range(4):
        sels = {seq: sorted(rng.choice(nc, 4, replace=False).tolist())
                for seq in range(2)}
        slots, _, st = store.fetch_chunks_pooled(0, sels, theta=theta)
        res.append((slots.tolist(), st.uploads, st.compressed,
                    st.disk_reads, st.disk_bytes, st.upload_bytes))
        store.append_tokens_batch(
            0, np.array([nc * c - 8 + rnd] * 2),
            rng.randn(2, store.kv_heads, store.head_dim).astype(np.float32),
            rng.randn(2, store.kv_heads, store.head_dim).astype(np.float32),
            seqs=[0, 1])
        store.requant_sweep()
    return res


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_sidecar_promotion_into_the_pool_cuda(cuda, tmp_path, theta):
    """Packed disk->host promotions of a CUDA store land in its pool (B3
    for the codec part) bit for bit as a CPU store's running the same
    script, with the same TrafficLog; disk->host kv bytes are packed."""
    from repro_torch.serving.offload import DISK, HOST, TieredKVStore
    out = {}
    before = kq_ops.launches
    for dev in ("cuda", "cpu"):
        store = TieredKVStore(
            1, 8, 16, 4, 32, n_seqs=2, transit_codec="int4", use_pool=True,
            pool_slots=12, real_codec=True, disk_sidecar=True,
            root=str(tmp_path / dev), device=dev)
        res = _sidecar_script(store, 0, theta)
        torch.cuda.synchronize()
        out[dev] = (res, store.pools[0].kv.cpu(), dict(store.log.bytes),
                    dict(store.log.ops), store.sidecar_repacks)
        full, packed = store.chunk_bytes, store._packed_bytes()
        store.close()
    assert out["cuda"][0] == out["cpu"][0]
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2:] == out["cpu"][2:]
    assert kq_ops.launches > before
    log_b, log_o = out["cuda"][2], out["cuda"][3]
    assert log_b[(DISK, HOST, "kv")] < log_o[(DISK, HOST, "kv")] * full
    assert log_b[(HOST, DISK, "kv_replica")] == \
        log_o[(HOST, DISK, "kv_replica")] * packed


@pytest.mark.parametrize("Hkv,G,hd", [(8, 8, 128), (2, 6, 128), (16, 1, 64)],
                         ids=["jamba", "qwen2-vl", "seamless"])
def test_a11_shapes_b1_b2_b3_cuda(cuda, rng, Hkv, G, hd):
    """B1, B2 and B3 at the attention shapes of the A11 families (jamba's
    G 8 / hd 128, qwen2-vl's G 6 / hd 128, seamless's G 1 / hd 64), each
    against its plain version: B1 on the engine's and the pyramid's
    layouts, B2 over pool slots (the engine's round) and through its
    contract entry (``decode_step``'s), B3's scatter at the layer's row
    width (bitwise)."""
    B, nc, chunk, nmax = 4, 64, 64, 12
    H = Hkv * G
    q = _t(rng.randn(B, H, hd).astype(np.float32) / np.sqrt(hd), cuda,
           torch.bfloat16)
    km = _t(rng.randn(B, nc, Hkv, hd).astype(np.float32), cuda)
    kn = km - _t(np.abs(rng.randn(B, nc, Hkv, hd)).astype(np.float32), cuda)
    for got, want in zip(cb_ops.chunk_bounds_gqa(q, km, kn),
                         cb_ops.chunk_bounds_gqa(q, km, kn, impl="ref")):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    q4 = q.reshape(B, Hkv, G, hd)
    kmp, knp = km.transpose(1, 2).contiguous(), kn.transpose(1, 2).contiguous()
    for got, want in zip(cb_ops.chunk_bounds(q4, kmp, knp),
                         cb_ops.chunk_bounds(q4, kmp, knp, impl="ref")):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    args = _pooled_inputs(rng, cuda, B, H, Hkv, hd, chunk, 3 * nmax, nmax,
                          torch.bfloat16)
    err, bar, frac = bf16_agreement(
        sd_ops.sparse_decode_pooled(*args, None),
        sd_ops.sparse_decode_pooled(*args, None, impl="ref"))
    assert err <= bar and frac <= BF16_MAX_MISMATCH, (err, bar, frac)
    S = nc * chunk
    k = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, torch.bfloat16)
    v = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, torch.bfloat16)
    ids = _t(np.stack([np.stack([np.sort(rng.choice(nc, nmax,
                                                    replace=False))
                                 for _ in range(Hkv)]) for _ in range(B)
                       ]).astype(np.int32), cuda)
    qc = _t(rng.randn(B, Hkv, G, hd).astype(np.float32) / np.sqrt(hd), cuda)
    for got, want in zip(sd_ops.sparse_decode(qc, k, v, ids, S - 7,
                                              chunk=chunk),
                         sd_ops.sparse_decode(qc, k, v, ids, S - 7,
                                              chunk=chunk, impl="ref")):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    for dtype in (torch.float16, torch.bfloat16):
        _scatter_matches_plain("int4", *_scatter_inputs(
            rng, cuda, "int4", 16, chunk, Hkv * hd, dtype))


@pytest.mark.parametrize("B,H,Hkv,hd,chunk,nmax", [
    (3, 4, 4, 16, 16, 8), (2, 8, 2, 64, 32, 5), (4, 32, 32, 128, 64, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_sparse_decode_workingset_cuda(cuda, rng, B, H, Hkv, hd, chunk, nmax,
                                       dtype, softcap):
    """B2 over a legacy working set uploaded whole, read in place: against
    its plain version, and bitwise against the pooled call over the same
    rows (same kernel, mask and split plan)."""
    from repro_torch.kernels.sparse_decode.ref import workingset_slab
    kg = _t(rng.randn(B, nmax, chunk, Hkv, hd).astype(np.float16), cuda)
    vg = _t(rng.randn(B, nmax, chunk, Hkv, hd).astype(np.float16), cuda)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(1, nmax + 1)
        cids[b, :n] = np.sort(rng.choice(4 * nmax, n, replace=False))
        lengths[b] = cids[b, n - 1] * chunk + rng.randint(1, chunk + 1)
    q = _t(rng.randn(B, H, hd).astype(np.float32), cuda, dtype)
    k_new = _t(rng.randn(B, 1, Hkv, hd).astype(np.float32), cuda, dtype)
    v_new = _t(rng.randn(B, 1, Hkv, hd).astype(np.float32), cuda, dtype)
    args = (q, kg, vg, _t(cids, cuda), _t(lengths, cuda), k_new, v_new,
            softcap)
    before = sd_ops.launches
    out = sd_ops.sparse_decode_workingset(*args)
    assert sd_ops.launches == before + 1
    ref = sd_ops.sparse_decode_workingset(*args, impl="ref")
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        err, bar, frac = bf16_agreement(out, ref)
        assert err <= bar and frac <= BF16_MAX_MISMATCH, (err, bar, frac)
    slab, slots = workingset_slab(kg, vg)
    pooled = sd_ops.sparse_decode_pooled(q, slab.contiguous(), slots,
                                         _t(cids, cuda), _t(lengths, cuda),
                                         k_new, v_new, softcap)
    assert torch.equal(out, pooled)


def test_reopened_store_fills_the_pool_cuda(cuda, tmp_path):
    """A CUDA store with the sidecar and the real codec ingests one
    sequence, is fenced, flushed and closed, and reopened; every chunk
    then promotes into the pool bit for bit as in a CPU store
    (``impl="ref"``) that ran the same script."""
    from repro_torch.serving.offload import DEVICE, DISK, HOST, TieredKVStore
    L, NC, C, HKV, HD = 2, 8, 16, 4, 32
    kw = dict(n_seqs=1, transit_codec="int4", use_pool=True,
              real_codec=True, disk_sidecar=True)
    out = {}
    for dev, impl in (("cuda", None), ("cpu", "ref")):
        root = str(tmp_path / dev)
        rng = np.random.RandomState(0)
        st = TieredKVStore(L, NC, C, HKV, HD, root=root, device=dev,
                           impl=impl, **kw)
        place = {c: (DEVICE, HOST, DISK, DISK)[c % 4] for c in range(NC)}
        for layer in range(L):
            k = rng.randn(NC * C, HKV, HD).astype(np.float32)
            v = rng.randn(NC * C, HKV, HD).astype(np.float32)
            st.ingest(layer, k, v, place, seq=0)
        st.ingest_fence(0)
        for m in (st._disk, st._disk_q, st._disk_scale, st._crc,
                  st._crc_state, st._q_crc):
            m.flush()
        st.close()
        st = TieredKVStore(L, NC, C, HKV, HD, root=root, device=dev,
                           impl=impl, reopen=True, **kw)
        res = []
        for layer in range(L):
            slots, _, fs = st.fetch_chunks_pooled(layer, {0: list(range(NC))},
                                                  theta=0.5)
            res.append((slots.tolist(), fs.disk_reads, fs.compressed))
        torch.cuda.synchronize()
        out[dev] = (res, [p.kv.cpu() for p in st.pools],
                    dict(st.log.bytes))
        st.close()
    assert out["cuda"][0] == out["cpu"][0]
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][1],
                                                 out["cpu"][1]))
    assert out["cuda"][2] == out["cpu"][2]


def _lost_and_restored_script(st):
    """One sequence over two layers with the real codec: a flipped
    replica bit of a disk chunk raises ``ChunkLostError`` at the pooled
    fetch; ``restore_chunk`` re-lands it from the original rows and the
    fetch is retried, θ 1.0 (every missing chunk through B3).  Returns
    the fault raised, the slot maps and the fetch stats."""
    from repro_torch.serving.faults import ChunkLostError
    from repro_torch.serving.offload import DEVICE, DISK, HOST
    NC, C = st.n_chunks, st.chunk
    rng = np.random.RandomState(4)
    place = {c: (DEVICE, HOST, DISK, DISK)[c % 4] for c in range(NC)}
    kv = []
    for layer in range(st.n_layers):
        k = rng.randn(NC * C, st.kv_heads, st.head_dim).astype(np.float16)
        v = rng.randn(NC * C, st.kv_heads, st.head_dim).astype(np.float16)
        st.ingest(layer, k, v, place, seq=0)
        kv.append((k, v))
    flat = st._disk[0, 1, 3].reshape(-1)
    flat[:1].view(np.uint16)[0] ^= np.uint16(1 << 10)   # the _flip_bit bit
    res = []
    for layer in range(st.n_layers):
        try:
            slots, _, fs = st.fetch_chunks_pooled(
                layer, {0: list(range(NC))}, theta=1.0)
        except ChunkLostError as e:
            res.append(("lost", e.layer, e.keys))
            k, v = kv[layer]
            for _, _, c in e.keys:
                st.restore_chunk(layer, 0, c, k[c * C:(c + 1) * C],
                                 v[c * C:(c + 1) * C])
            slots, _, fs = st.fetch_chunks_pooled(
                layer, {0: list(range(NC))}, theta=1.0)
        res.append((slots.tolist(), fs.disk_reads, fs.compressed))
    return res


def test_restored_chunk_refills_the_pool_cuda(cuda, tmp_path):
    """A card store whose replica lost a bit raises ``ChunkLostError``;
    after ``restore_chunk`` its pool slots, filled through B3, equal a CPU
    store's (``impl="ref"``) after the same script, bit for bit, with the
    same TrafficLog and fault counters."""
    from repro_torch.serving.offload import TieredKVStore
    out = {}
    before = kq_ops.launches
    for dev, impl in (("cuda", None), ("cpu", "ref")):
        st = TieredKVStore(2, 8, 16, 4, 32, n_seqs=1, transit_codec="int4",
                           use_pool=True, real_codec=True,
                           root=str(tmp_path / dev), device=dev, impl=impl)
        res = _lost_and_restored_script(st)
        torch.cuda.synchronize()
        out[dev] = (res, [p.kv.cpu() for p in st.pools],
                    dict(st.log.bytes), st.fault_stats())
        st.close()
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][0][1][0] == "lost"
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][1],
                                                 out["cpu"][1]))
    assert out["cuda"][2:] == out["cpu"][2:]
    assert out["cuda"][3]["chunks_recomputed"] == 1
    assert kq_ops.launches > before


def test_swapped_sequence_refills_the_pool_cuda(cuda, tmp_path):
    """``swap_out_seq`` on a card store frees the sequence's pool slots;
    ``swap_in_seq`` re-stages its chunks on the host, and the next pooled
    fetch (θ 0.5: half of the upload through B3) refills the slots bit
    for bit as a CPU store's running the same script."""
    from repro_torch.serving.offload import DEVICE, DISK, HOST, TieredKVStore
    L, NC, C, HKV, HD = 2, 8, 16, 4, 32
    out = {}
    for dev, impl in (("cuda", None), ("cpu", "ref")):
        st = TieredKVStore(L, NC, C, HKV, HD, n_seqs=2, transit_codec="int4",
                           use_pool=True, real_codec=True,
                           root=str(tmp_path / dev), device=dev, impl=impl)
        rng = np.random.RandomState(5)
        place = {c: (DEVICE, HOST, DISK, DEVICE)[c % 4] for c in range(NC)}
        for seq in (0, 1):
            for layer in range(L):
                k = rng.randn(NC * C, HKV, HD).astype(np.float32)
                st.ingest(layer, k, -k, place, seq=seq)
        res = []
        for layer in range(L):
            st.fetch_chunks_pooled(layer, {0: [0, 2, 5], 1: [1, 3]},
                                   theta=0.5)
        resident = st.pool_stats()["resident"]
        res.append(st.swap_out_seq(1))
        res.append((resident, st.pool_stats()["resident"],
                    [sorted(p.slot_of) for p in st.pools]))
        res.append(st.swap_in_seq(1))
        for layer in range(L):
            slots, _, fs = st.fetch_chunks_pooled(
                layer, {0: [0, 2, 5], 1: [1, 3, 4]}, theta=0.5)
            res.append((slots.tolist(), fs.uploads, fs.compressed,
                        fs.disk_reads))
        torch.cuda.synchronize()
        out[dev] = (res, [p.kv.cpu() for p in st.pools],
                    dict(st.log.bytes), dict(st.log.ops))
        st.close()
    assert out["cuda"][0] == out["cpu"][0]
    _, (before, after, slot_keys), _ = out["cuda"][0][:3]
    assert after < before
    assert all(s != 1 for keys in slot_keys for s, _ in keys)
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][1],
                                                 out["cpu"][1]))
    assert out["cuda"][2:] == out["cpu"][2:]
    assert out["cuda"][3][("disk", "host", "kv_swapin")] == \
        out["cuda"][0][2]


def test_launch_counters_count_kernel_launches_only(cuda, rng):
    data = _t(rng.randint(-128, 128, (2, 8, 8)).astype(np.int8), cuda)
    scale = _t(np.ones((2, 16), np.float32), cuda)
    slab = torch.zeros(3, 2, 4, 2, 8, dtype=torch.float16, device=cuda)
    before = kq_ops.launches
    kq_ops.kv_dequant(data, scale, codec="int4", impl="ref")
    kq_ops.kv_dequant_scatter(data[:, :4], scale, slab, [2], codec="int4",
                              impl="ref")
    assert kq_ops.launches == before
    kq_ops.kv_dequant(data, scale, codec="int4")
    assert kq_ops.launches == before + 1
    kq_ops.kv_dequant_scatter(data[:, :4], scale, slab, [2], codec="int4")
    assert kq_ops.launches == before + 2


def _pq_inputs(rng, dev, m, N, dsub, K, ties=False):
    x = rng.randn(m, N, dsub).astype(np.float32)
    cb = rng.randn(m, K, dsub).astype(np.float32)
    if ties:
        # exact ties: duplicated centroids, and rows that sit on a centroid
        cb[:, K - 1] = cb[:, 0]
        cb[:, K // 2] = cb[:, 1]
        x[:, ::7] = cb[:, :1]
    return _t(x, dev), _t(cb, dev)


@pytest.mark.parametrize("m,N,dsub,K", [
    (1, 8, 8, 4), (2, 100, 8, 16), (4, 257, 16, 32), (3, 512, 4, 256),
    (16, 131072, 8, 256), (2, 1000, 32, 64), (1, 300, 1, 8), (2, 70, 2, 5),
])
@pytest.mark.parametrize("ties", [False, True])
def test_pq_assign_cuda_bitwise(cuda, rng, m, N, dsub, K, ties):
    x, cb = _pq_inputs(rng, cuda, m, N, dsub, K, ties)
    ref = pq_ops.pq_assign(x, cb, impl="ref")
    out = pq_ops.pq_assign(x, cb)
    assert out.dtype == torch.int32 and torch.equal(out, ref)
    if ties:
        assert not (out == K - 1).any()   # the first of two equal centroids


@pytest.mark.parametrize("rounding_bits", [0x1FFF, 0x1000])
def test_pq_assign_cuda_at_the_screen_boundary(cuda, rng, rounding_bits):
    """Rows built to carry the largest TF32 error in one direction (each
    a power-of-two multiple of the largest centroid, every mantissa
    1 + low bits) and near-tied centroid twins that TF32 cannot tell
    apart: the codes stay bitwise equal, and the twins are re-checked."""
    m, K, dsub = 16, 256, 8
    mant = np.array([0x3F800000 | rounding_bits], np.int32).view(
        np.float32)[0]
    sign = np.where(rng.rand(m, K, dsub) < 0.5, -1.0, 1.0)
    cb = (sign * 2.0 ** rng.randint(-3, 0, (m, K, dsub)) * mant).astype(
        np.float32)
    cb[:, 0] *= 8
    x = (cb[:, :1] * 2.0 ** rng.randint(-1, 2, (m, 4096, 1))).astype(
        np.float32)
    twin = cb[:, 2:130:2].copy()
    twin.view(np.int32)[...] ^= rng.randint(1, 0x2000, twin.shape)
    cb[:, 3:131:2] = twin
    near = (cb[:, rng.randint(2, 130, 4096)]
            + rng.randn(m, 4096, dsub).astype(np.float32) * 1e-3)
    x = np.concatenate([x, near], 1)
    xt, cbt = _t(x, cuda), _t(cb, cuda)
    ref = pq_ops.pq_assign(xt, cbt, impl="ref")
    out, mean = pq_ops.pq_assign_candidates(xt, cbt)
    assert torch.equal(out, ref)
    assert mean > 1.0
    assert torch.equal(pq_ops.pq_assign(xt, cbt), ref)


@pytest.mark.parametrize("m,N,dsub,K", [
    (1, 8, 8, 4), (2, 100, 8, 16), (4, 257, 16, 32), (3, 512, 4, 256),
    (16, 114688, 8, 256), (2, 5000, 32, 64), (1, 9000, 1, 3),
    (16, 49152, 8, 256), (16, 131072, 8, 256),   # the path's N range
    (2, 5000, 2, 7), (3, 4097, 8, 256),          # N % 1024 != 0
    (2, 1000, 16, 1),
])
@pytest.mark.parametrize("codes_kind", ["random", "one_code"])
def test_pq_update_cuda(cuda, rng, m, N, dsub, K, codes_kind):
    x, _ = _pq_inputs(rng, cuda, m, N, dsub, K)
    if codes_kind == "random":
        # K is the padding sentinel, -1 another code outside [0, K)
        codes = rng.randint(-1, K + 1, (m, N)).astype(np.int32)
    else:
        # every row on one code: each 32-row step is one group
        codes = np.full((m, N), K - 1, np.int32)
        codes[:, ::97] = K
    codes = _t(codes, cuda)
    s_r, n_r = pq_ops.pq_update(x, codes, K, impl="ref")
    s_k, n_k = pq_ops.pq_update(x, codes, K)
    assert torch.equal(n_k, n_r)
    assert n_k.sum().item() == ((codes >= 0) & (codes < K)).sum().item()
    assert torch.equal(s_k, s_r)
    s_k2, n_k2 = pq_ops.pq_update(x, codes, K)
    assert torch.equal(s_k2, s_k) and torch.equal(n_k2, n_k)


def test_pq_update_cuda_signed_zero(cuda):
    """Every fold starts from +0.0: a centroid whose only members are -0.0
    sums to +0.0, as in the plain version."""
    x = torch.full((1, 3000, 8), -0.0, device=cuda)
    codes = torch.zeros((1, 3000), dtype=torch.int32, device=cuda)
    s_k, _ = pq_ops.pq_update(x, codes, 4)
    s_r, _ = pq_ops.pq_update(x, codes, 4, impl="ref")
    assert torch.equal(torch.signbit(s_k), torch.signbit(s_r))
    assert not torch.signbit(s_k).any()


@pytest.mark.parametrize("blocks_off", [-1, 1])
def test_pq_update_entry_refuses_another_scratch_size(cuda, blocks_off):
    """B5's C entry takes the scratch's block count and refuses one that
    is not its own, so a scratch sized for another run length is never
    overrun."""
    from repro_torch.kernels import build
    m, N, dsub, K = 2, 9000, 8, 16
    x = torch.randn(m, N, dsub, device=cuda)
    codes = torch.zeros((m, N), dtype=torch.int32, device=cuda)
    T = -(-N // (pq_ops.UPDATE_RUN_ROWS * pq_ops.UPDATE_WARPS)) + blocks_off
    ps = torch.empty((m, T + 1, K, dsub), device=cuda)
    pc = torch.empty((m, T + 1, K), dtype=torch.int32, device=cuda)
    sums = torch.empty((m, K, dsub), device=cuda)
    counts = torch.empty((m, K), device=cuda)
    rc = build.library().leoam_pq_update(
        x.data_ptr(), codes.data_ptr(), ps.data_ptr(), pc.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), m, N, K, dsub, T,
        build.stream_ptr(x))
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="pq_update: CUDA error"):
        build.check(rc, "pq_update")


def test_pq_train_cuda_is_deterministic(cuda):
    """Two kernel runs of pq_train and pq_encode give byte-identical
    codebooks and codes."""
    rng = np.random.RandomState(1)
    vecs = (rng.randn(20000, 128) * 2).astype(np.float32)
    cb0 = np.zeros((16, 256, 8), np.float32)
    cnt0 = np.zeros((16, 256), np.float64)
    runs = []
    for _ in range(2):
        cb, cnt = pq_ops.pq_train(vecs, cb0, cnt0, iters=4, device=cuda)
        runs.append((cb, cnt, pq_ops.pq_encode(vecs, cb, device=cuda)))
    for a, b in zip(*runs):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["dsub3", "K512", "K0", "codes_f32",
                                  "cb_on_cpu"])
def test_pq_unsupported_cuda_shapes_raise(cuda, rng, case):
    """A CUDA tensor the kernels do not take raises; it never runs the
    plain version instead."""
    before = (pq_ops.assign_launches, pq_ops.update_launches)
    dsub = 3 if case == "dsub3" else 8
    K = {"K512": 512, "K0": 0}.get(case, 16)
    x = _t(rng.randn(2, 64, dsub).astype(np.float32), cuda)
    cb = _t(rng.randn(2, K, dsub).astype(np.float32), cuda)
    if case == "cb_on_cpu":
        cb = cb.cpu()
    codes = _t(rng.randint(0, max(K, 1), (2, 64)).astype(np.int32), cuda)
    if case == "codes_f32":
        codes = codes.float()
    with pytest.raises(ValueError, match="not a supported CUDA shape"):
        if case == "codes_f32":
            pq_ops.pq_update(x, codes, K)
        else:
            pq_ops.pq_assign(x, cb)
    if case in ("dsub3", "K512", "K0"):
        with pytest.raises(ValueError, match="not a supported CUDA shape"):
            pq_ops.pq_update(x, codes, K)
    assert (pq_ops.assign_launches, pq_ops.update_launches) == before


# ---------------------------------------------------------------------------
# The latent (MLA) variants of B1 and B2, and B3 on one plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,D,nc", [
    (1, 4, 40, 5), (2, 7, 64, 1), (3, 16, 576, 130),
    (4, 16, 576, 57),               # deepseek-v2-lite's serve shape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_chunk_bounds_latent_cuda(cuda, rng, B, H, D, nc, dtype):
    """B1's latent variant against its plain version (the GQA bound at one
    kv head): f32 sums in another order."""
    q = _t(rng.randn(B, H, D).astype(np.float32) / 8, cuda, dtype)
    km = _t(rng.randn(B, nc, 1, D).astype(np.float32), cuda)
    kn = km - _t(np.abs(rng.randn(B, nc, 1, D)).astype(np.float32), cuda)
    ub_r, lb_r = cb_ops.chunk_bounds_latent(q, km, kn, impl="ref")
    before = cb_ops.latent_launches
    ub_k, lb_k = cb_ops.chunk_bounds_latent(q, km, kn)
    assert cb_ops.latent_launches == before + 1
    assert ub_k.shape == (B, 1, nc)
    torch.testing.assert_close(ub_k, ub_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(lb_k, lb_r, rtol=1e-5, atol=1e-4)


def test_chunk_bounds_latent_unsupported_shape_raises(cuda, rng):
    """Two kv heads, or D not a multiple of 4, raise; never the plain
    version instead."""
    q = _t(rng.randn(1, 4, 40).astype(np.float32), cuda)
    before = cb_ops.latent_launches
    for shape in ((1, 3, 2, 40), (1, 3, 1, 42)):
        km = _t(rng.randn(*shape).astype(np.float32), cuda)
        qq = q if shape[-1] == 40 else _t(rng.randn(1, 4, 42).astype(
            np.float32), cuda)
        with pytest.raises(ValueError, match="CUDA contract"):
            cb_ops.chunk_bounds_latent(qq, km, km - 1)
    assert cb_ops.latent_launches == before


def _latent_inputs(rng, dev, B, H, D, chunk, n_slots, nmax, dtype):
    """A one-plane fp16 pool, pre-scaled queries, ragged selections with
    padding (-1) and lengths inside each last chunk, the round's rows."""
    pool = _t(rng.randn(n_slots + 1, 1, chunk, 1, D).astype(np.float16), dev)
    q = _t(rng.randn(B, H, D).astype(np.float32) / np.sqrt(D), dev, dtype)
    lat_new = _t(rng.randn(B, D).astype(np.float32), dev, dtype)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(1, nmax + 1)
        slots[b, :n] = rng.choice(n_slots, n, replace=False)
        cids[b, :n] = np.sort(rng.choice(4 * nmax, n, replace=False))
        lengths[b] = cids[b, n - 1] * chunk + rng.randint(1, chunk + 1)
    return (q, pool, _t(slots, dev), _t(cids, dev), _t(lengths, dev),
            lat_new)


@pytest.mark.parametrize("B,H,D,r,chunk,nmax", [
    (2, 4, 40, 32, 16, 6), (3, 8, 128, 96, 32, 9),
    (4, 16, 576, 512, 64, 12),      # deepseek-v2-lite's serve shape
    (4, 16, 576, 512, 64, 44),
    (1, 16, 576, 512, 64, 200),     # a long selection: many splits
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_sparse_decode_latent_pooled_cuda(cuda, rng, B, H, D, r, chunk, nmax,
                                          dtype):
    args = _latent_inputs(rng, cuda, B, H, D, chunk, 3 * nmax, nmax, dtype)
    ref = sd_ops.sparse_decode_latent_pooled(*args, r, impl="ref")
    before = sd_ops.latent_launches
    out = sd_ops.sparse_decode_latent_pooled(*args, r)
    assert sd_ops.latent_launches == before + 1
    assert out.shape == (B, H, r) and out.dtype == torch.float32
    err, bar = latent_agreement(out, ref, (args[1], args[5]),
                                latent_pooled_den(*args, r))
    assert err <= bar, (err, bar)


@pytest.mark.parametrize("B,H,D,r,chunk,nmax", [
    (2, 4, 40, 32, 16, 6), (4, 16, 576, 512, 64, 12)])
def test_sparse_decode_latent_workingset_cuda(cuda, rng, B, H, D, r, chunk,
                                              nmax):
    """The legacy working set read in place: against its plain version,
    and bitwise against the pooled call over the same rows (same kernel,
    mask and split plan)."""
    q, pool, slots, cids, lengths, lat_new = _latent_inputs(
        rng, cuda, B, H, D, chunk, 3 * nmax, nmax, torch.bfloat16)
    latg = pool[slots.long()].reshape(B, nmax, chunk, 1, D).contiguous()
    out = sd_ops.sparse_decode_latent_workingset(q, latg, cids, lengths,
                                                 lat_new, r)
    ref = sd_ops.sparse_decode_latent_workingset(q, latg, cids, lengths,
                                                 lat_new, r, impl="ref")
    err, bar = latent_agreement(out, ref, (latg, lat_new), latent_pooled_den(
        q, pool, slots, cids, lengths, lat_new, r))
    assert err <= bar, (err, bar)
    pooled = sd_ops.sparse_decode_latent_pooled(q, pool, slots, cids,
                                                lengths, lat_new, r)
    assert torch.equal(out, pooled)


def test_sparse_decode_latent_bar_sees_unrounded_p(cuda):
    """The agreement bar is tight enough to see a P.V that does not round
    each probability to fp16 (``tied_latent_case``: every probability of a
    head is one value a quarter fp16 ulp or more from fp16): the kernel
    passes it, and the plain version over an f32 pool, which leaves p
    unrounded, fails it by more than four bars."""
    q, pool, slots, cids, lengths, lat_new = tied_latent_case(cuda)
    args = (slots, cids, lengths, lat_new, 512)
    ref = sd_ops.sparse_decode_latent_pooled(q, pool, *args, impl="ref")
    den = latent_pooled_den(q, pool, *args)
    out = sd_ops.sparse_decode_latent_pooled(q, pool, *args)
    err, bar = latent_agreement(out, ref, (pool, lat_new), den)
    assert err <= bar, (err, bar)
    unrounded = sparse_decode_latent_pooled_ref(q, pool.float(), *args)
    err_u, _ = latent_agreement(unrounded, ref, (pool, lat_new), den)
    assert err_u > 4 * bar, (err_u, bar)


@pytest.mark.parametrize("B,H,D,r,chunk,nmax", [
    (3, 16, 576, 512, 40, 5),       # 40-row tiles: no whole k-step of 16
    (2, 16, 576, 512, 100, 4),      # 64 + 36 rows a chunk: two tiles
    (2, 7, 72, 40, 24, 7),          # r not a multiple of 16 columns
    (2, 5, 42, 34, 16, 6),          # D % 8 != 0: rows by 4-byte copies
    (1, 16, 704, 512, 8, 3),        # the widest row, 8-row chunks
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_decode_latent_partial_tiles_cuda(cuda, rng, B, H, D, r,
                                                 chunk, nmax, dtype):
    """Selections whose rows fill no whole staged tile (T = nsel x chunk +
    1 for chunks that are not a multiple of 16 rows, or longer than one
    64-row tile), value widths that are not a multiple of 16, and rows
    that are not a whole number of 16-byte pieces: against the plain
    version within ``latent_agreement``'s bar."""
    args = _latent_inputs(rng, cuda, B, H, D, chunk, 3 * nmax, nmax, dtype)
    ref = sd_ops.sparse_decode_latent_pooled(*args, r, impl="ref")
    out = sd_ops.sparse_decode_latent_pooled(*args, r)
    err, bar = latent_agreement(out, ref, (args[1], args[5]),
                                latent_pooled_den(*args, r))
    assert err <= bar, (err, bar)


def test_sparse_decode_latent_all_padding_cuda(cuda, rng):
    """A selection that is all padding (chunk ids -1) but the new token's
    row: p = 1 on that row alone, so out_lat is its first r values
    rounded to fp16, exactly; a second sequence beside it has live rows."""
    q, pool, slots, cids, lengths, lat_new = _latent_inputs(
        rng, cuda, 2, 16, 576, 64, 36, 12, torch.bfloat16)
    cids[0] = -1
    out = sd_ops.sparse_decode_latent_pooled(q, pool, slots, cids, lengths,
                                             lat_new, 512)
    want = lat_new[0, :512].half().float().expand(16, 512)
    assert torch.equal(out[0], want)
    ref = sd_ops.sparse_decode_latent_pooled(q, pool, slots, cids, lengths,
                                             lat_new, 512, impl="ref")
    err, bar = latent_agreement(out, ref, (pool, lat_new), latent_pooled_den(
        q, pool, slots, cids, lengths, lat_new, 512))
    assert err <= bar, (err, bar)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_decode_latent_32k_rows_cuda(cuda, rng, dtype):
    """A 32k-row selection at the serve width (H 16, D 576, r 512): 512
    live chunks of 64 (32 splits of 16 entries in the P.V launch) against
    the plain version within ``latent_agreement``'s bar."""
    nsel, chunk, D = 512, 64, 576
    pool = _t(rng.randn(nsel + 9, 1, chunk, 1, D).astype(np.float16), cuda)
    q = _t(rng.randn(1, 16, D).astype(np.float32) / np.sqrt(192), cuda,
           dtype)
    lat_new = _t(rng.randn(1, D).astype(np.float32), cuda, dtype)
    slots = _t(rng.permutation(nsel + 8)[:nsel][None].astype(np.int32), cuda)
    cids = _t(np.arange(nsel, dtype=np.int32)[None], cuda)
    lengths = _t(np.array([nsel * chunk - 17], np.int32), cuda)
    args = (q, pool, slots, cids, lengths, lat_new, 512)
    out = sd_ops.sparse_decode_latent_pooled(*args)
    ref = sd_ops.sparse_decode_latent_pooled(*args, impl="ref")
    err, bar = latent_agreement(out, ref, (pool, lat_new),
                                latent_pooled_den(*args))
    assert err <= bar, (err, bar)


def test_sparse_decode_latent_two_launches_bitwise(cuda, rng):
    """No float atomics: two calls give bitwise-equal outputs."""
    args = _latent_inputs(rng, cuda, 4, 16, 576, 64, 132, 44,
                          torch.bfloat16)
    a = sd_ops.sparse_decode_latent_pooled(*args, 512)
    b = sd_ops.sparse_decode_latent_pooled(*args, 512)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["H17", "D706", "r514", "bf16_pool",
                                  "two_planes"])
def test_sparse_decode_latent_unsupported_shapes_raise(cuda, rng, case):
    """Shapes the latent kernel does not take raise; never the plain
    version instead."""
    H = 17 if case == "H17" else 4
    D = 706 if case == "D706" else 576
    r = 514 if case == "r514" else 512
    q, pool, slots, cids, lengths, lat_new = _latent_inputs(
        rng, cuda, 2, H, D, 16, 12, 4, torch.bfloat16)
    if case == "bf16_pool":
        pool = pool.to(torch.bfloat16)
    if case == "two_planes":
        pool = torch.cat([pool, pool], dim=1)
    before = sd_ops.latent_launches
    with pytest.raises(ValueError, match="sparse_decode"):
        sd_ops.sparse_decode_latent_pooled(q, pool, slots, cids, lengths,
                                           lat_new, r)
    assert sd_ops.latent_launches == before


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("n", [1, 16])
def test_kv_dequant_scatter_one_plane_cuda_bitwise(cuda, rng, codec, n):
    """B3 into a one-plane latent slab (S, 1, 64, 1, 576), as the MLA
    store's codec upload writes it: bitwise the plain version, the slots
    it was not given untouched, two launches equal."""
    d, c = 576, 64
    dp = d if codec == "int8" else d // 2
    data = _t(rng.randint(-128, 128, (n, c, dp)).astype(np.int8), cuda)
    scale = _t(np.abs(rng.randn(n, d)).astype(np.float32) + 0.01, cuda)
    slab = _t(rng.randn(n + 5, 1, c, 1, d).astype(np.float16), cuda)
    slots = rng.permutation(n + 5)[:n].tolist()
    _scatter_matches_plain(codec, data, scale, slab, slots)
    other = slab.clone()
    kq_ops.kv_dequant_scatter(data, scale, other, slots, codec=codec)
    assert torch.equal(slab, other)


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_fetch_chunks_pooled_latent_cuda_matches_plain_scatter(cuda, tmp_path,
                                                               theta):
    """The latent (one-plane) store's codec upload through B3 leaves the
    same (S, 1, chunk, 1, 576) slab, slots and billing as the same store
    with the plain scatter, over rounds with evictions and queued
    decode-append rows (the latent rows in the K position, no V)."""
    from repro_torch.serving.offload import HOST, TieredKVStore
    L, NC, C, D = 1, 8, 16, 576
    stores = {impl: TieredKVStore(
        L, NC, C, 1, D, n_seqs=2, transit_codec="int4", use_pool=True,
        pool_slots=9, real_codec=True, latent=True,
        root=str(tmp_path / str(impl)), device="cuda", impl=impl)
        for impl in (None, "ref")}
    out = {}
    before = kq_ops.launches
    for impl, store in stores.items():
        rng = np.random.RandomState(0)
        for seq in range(2):
            lat = rng.randn(NC * C, 1, D).astype(np.float32)
            store.ingest(0, lat, None, {c: HOST for c in range(NC)}, seq=seq)
        res = []
        for rnd in range(4):
            sels = {seq: sorted(rng.choice(NC, 4, replace=False).tolist())
                    for seq in range(2)}
            slots, nsel, st = store.fetch_chunks_pooled(0, sels, theta=theta)
            res.append((slots.tolist(), st.uploads, st.compressed,
                        st.upload_bytes))
            store.append_tokens_batch(
                0, np.array([NC * C - 8 + rnd] * 2),
                rng.randn(2, 1, D).astype(np.float32), None, seqs=[0, 1])
        torch.cuda.synchronize()
        assert tuple(store.pools[0].kv.shape[1:]) == (1, C, 1, D)
        out[impl] = (res, store.pools[0].kv.clone(), store.codec_uploads,
                     dict(store.log.bytes))
        store.close()
    assert out[None][0] == out["ref"][0]
    assert torch.equal(out[None][1], out["ref"][1])
    assert out[None][2] == out["ref"][2] > 0
    assert out[None][3] == out["ref"][3]
    assert kq_ops.launches > before


# ---------------------------------------------------------------------------
# lm.decode_step's sparse path: B2's Pallas-contract entry at the model
# dtype and with a softcap, B1 on pyramid boxes with sentinel rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Hkv,G,hd,softcap,dtype", [
    (4, 32, 1, 128, None, torch.bfloat16),    # longchat
    (2, 4, 2, 256, 50.0, torch.bfloat16),     # gemma2: hd 256, softcap
    (2, 8, 12, 192, None, torch.bfloat16),    # nemotron4: hd 192, G 12
    (2, 2, 4, 64, 30.0, torch.float32),
    (1, 2, 3, 128, None, torch.float16),
])
def test_sparse_decode_contract_at_the_model_dtype(cuda, rng, B, Hkv, G, hd,
                                                   softcap, dtype):
    """q in the cache's dtype (``sparse_decode_gqa`` rounds it there): the
    kernel runs at that model dtype — probabilities rounded to it for P.V
    — and with the softcap, as the plain version.  m and den are f32 sums
    in another order (1e-5); the output may see a probability round the
    other way where the scores differ in their last bits: two such flips,
    one ulp of the model dtype at p <= 1 times max|v| over the smallest
    den."""
    S, chunk, nsel, length = 1024, 64, 6, 1000
    q = _t(rng.randn(B, Hkv, G, hd).astype(np.float32) / np.sqrt(hd) * 4,
           cuda, dtype)
    k = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, dtype)
    v = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, dtype)
    ids = _t(np.stack([np.stack([
        np.r_[rng.choice(S // chunk - 1, nsel - 1, replace=False),
              S // chunk - 1] for _ in range(Hkv)]) for _ in range(B)])
        .astype(np.int32), cuda)
    num_r, den_r, m_r = sd_ops.sparse_decode(q, k, v, ids, length,
                                             chunk=chunk,
                                             attn_softcap=softcap,
                                             impl="ref")
    before = sd_ops.launches
    num_k, den_k, m_k = sd_ops.sparse_decode(q, k, v, ids, length,
                                             chunk=chunk,
                                             attn_softcap=softcap)
    assert sd_ops.launches == before + 1
    torch.testing.assert_close(m_k, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(den_k, den_r, rtol=1e-5, atol=1e-5)
    out_k, out_r = num_k / den_k[..., None], num_r / den_r[..., None]
    err, bar = contract_agreement(out_k, out_r, v, den_r, dtype)
    assert err <= bar, (err, bar)
    if softcap is not None:
        assert m_k.max().item() <= softcap


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("where", ["empty", "first_chunk"])
def test_sparse_decode_contract_on_a_shard_edge(cuda, rng, dtype, where):
    """A sequence shard's B2 call (``lm.decode_step`` under a mesh) at the
    shard's edges: a local length of 0 (a shard that holds no token yet)
    gives num 0, den 0 and m -inf as the plain version does, never a NaN;
    a length inside the first selected chunk (the shard that the fill has
    just reached) masks the rest of it and every later chunk.  The
    selection lists chunks past the fill, as the pyramid descent picks
    sentinel boxes there."""
    B, Hkv, G, hd, S, chunk = 4, 32, 1, 128, 1024, 64
    q = _t(rng.randn(B, Hkv, G, hd).astype(np.float32) / np.sqrt(hd),
           cuda, dtype)
    k = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, dtype)
    v = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, dtype)
    ids = _t(np.broadcast_to(np.array([0, 2, 4, 6, 8, 1], np.int32),
                             (B, Hkv, 6)).copy(), cuda)
    length = 0 if where == "empty" else chunk // 2 + 3
    ref = sd_ops.sparse_decode(q, k, v, ids, length, chunk=chunk,
                               impl="ref")
    before = sd_ops.launches
    got = sd_ops.sparse_decode(q, k, v, ids, length, chunk=chunk)
    assert sd_ops.launches == before + 1
    for t in got:
        assert not torch.isnan(t).any()
    if where == "empty":
        for t, r in zip(got, ref):
            assert torch.equal(t, r)
        assert bool((got[2] == float("-inf")).all())
        assert not got[0].any() and not got[1].any()
        return
    num_k, den_k, m_k = got
    num_r, den_r, m_r = ref
    torch.testing.assert_close(m_k, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(den_k, den_r, rtol=1e-5, atol=1e-5)
    err, bar = contract_agreement(num_k / den_k[..., None],
                                  num_r / den_r[..., None], v, den_r, dtype)
    assert err <= bar, (err, bar)


def test_sparse_decode_contract_bar_sees_unrounded_p(cuda):
    """The contract entry's bar at bf16 sees a P.V that does not round
    each probability to bf16 (``tied_contract_case``: every probability
    of a head but its one maximum is one value a quarter bf16 ulp or more
    from bf16): the kernel at bf16 passes it, and the kernel with an f32 q
    (the Pallas kernel's case, which leaves p unrounded) fails it by more
    than four bars."""
    q, k, v, ids, length = tied_contract_case(cuda)
    num_r, den_r, _ = sd_ops.sparse_decode(q, k, v, ids, length, chunk=64,
                                           impl="ref")
    out_r = num_r / den_r[..., None]
    num_k, den_k, _ = sd_ops.sparse_decode(q, k, v, ids, length, chunk=64)
    err, bar = contract_agreement(num_k / den_k[..., None], out_r, v, den_r,
                                  torch.bfloat16)
    assert err <= bar, (err, bar)
    num_f, den_f, _ = sd_ops.sparse_decode(q.float(), k, v, ids, length,
                                           chunk=64)
    err_f, _ = contract_agreement(num_f / den_f[..., None], out_r, v, den_r,
                                  torch.bfloat16)
    assert err_f > 4 * bar, (err_f, bar)


@pytest.mark.parametrize("hd,G", [(128, 1), (256, 2), (192, 12)])
def test_chunk_bounds_on_pyramid_boxes_with_sentinels(cuda, rng, hd, G):
    """B1 at the decode path's two layouts — a cache leaf's (B, nc, Hkv,
    hd) boxes read in place (a view into a stacked body leaf) and gathered
    (B, Hkv, C, hd) boxes — where chunks past the length hold the -1e30 /
    +1e30 sentinels: finite bounds within 1e-5 of the plain version's."""
    from repro_torch.core.abstracts import NEG, build_pyramid
    B, Hkv, S, chunk = 2, 4, 4096, 64
    k = _t(rng.randn(B, S, Hkv, hd).astype(np.float32), cuda, torch.bfloat16)
    pyr = build_pyramid(k, chunk, 3, length=1500)
    stacked = torch.stack([pyr.kmax[2], pyr.kmax[2]])
    stacked_n = torch.stack([pyr.kmin[2], pyr.kmin[2]])
    km, kn = stacked[1], stacked_n[1]                  # views, offset > 0
    assert (km == NEG).any() and (kn == -NEG).any()
    q = _t(rng.randn(B, Hkv * G, hd).astype(np.float32), cuda,
           torch.bfloat16)
    ub_r, lb_r = cb_ops.chunk_bounds_gqa(q, km, kn, impl="ref")
    ub_k, lb_k = cb_ops.chunk_bounds_gqa(q, km, kn)
    for got, want in ((ub_k, ub_r), (lb_k, lb_r)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    ids = torch.randint(0, pyr.kmax[1].shape[1], (B, Hkv, 9), device=cuda)
    idx = ids[..., None].expand(B, Hkv, 9, hd)
    gkm = torch.gather(pyr.kmax[1].transpose(1, 2), 2, idx)
    gkn = torch.gather(pyr.kmin[1].transpose(1, 2), 2, idx)
    q4 = q.reshape(B, Hkv, G, hd)
    ub_r, lb_r = cb_ops.chunk_bounds(q4, gkm, gkn, impl="ref")
    ub_k, lb_k = cb_ops.chunk_bounds(q4, gkm, gkn)
    for got, want in ((ub_k, ub_r), (lb_k, lb_r)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,hd", [("longchat-7b-32k", 128),
                                     ("gemma2-2b", 256),
                                     ("nemotron-4-340b", 192)])
def test_decode_step_kernels_match_plain(cuda, arch, hd):
    """``lm.decode_step`` with B1 and B2 (``impl=None``) against the plain
    versions (``impl="ref"``) on the card, at a small depth and width
    (the arch's layer pattern and head dim, 8 q heads over 2 kv heads,
    bf16): the plain run's chunk selections replayed, 4 steps, logits
    within 4 bf16 ulps of max|logit|; B2 launched once per sparse layer
    and step, B1 at least as often; and every kernel call of the run
    within its bar of its plain version on the same inputs
    (``repro_torch.testing.check_decode_kernels``: B1 1e-5 relative and
    finite on the pyramid's sentinel boxes, B2 at the model dtype's
    ``contract_agreement`` bar)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.testing import check_decode_kernels, replay_selections
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(
        cfg, d_model=256, n_heads=8, n_kv_heads=2, head_dim=hd, d_ff=512,
        dtype="bfloat16", leoam=dataclasses.replace(
            cfg.leoam, chunk_size=16, pyramid_levels=3,
            min_seq_for_sparse=64))
    params = lm.init(cfg, seed=0, device=cuda)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (2, 300), generator=gen).to(cuda)
    recorded, outs, launches, checks = [], [], [], {}
    for impl in ("ref", None):
        with contextlib.ExitStack() as stack:
            if impl == "ref":
                stack.enter_context(replay_selections(record=recorded))
            else:
                stack.enter_context(replay_selections(replay=recorded))
                stack.enter_context(check_decode_kernels(checks))
            with torch.no_grad():
                logits, cache = lm.prefill(params, cfg, {"tokens": toks},
                                           max_len=512)
                b1, b2 = cb_ops.launches, sd_ops.launches
                tok, out = logits.argmax(-1), []
                for step in range(4):
                    lg, cache = lm.decode_step(params, cfg, cache,
                                               {"token": tok}, 300 + step,
                                               impl=impl)
                    out.append(lg.float())
                    tok = lg.argmax(-1) if impl == "ref" else \
                        outs[0][step].argmax(-1)
                launches.append((cb_ops.launches - b1,
                                 sd_ops.launches - b2))
        outs.append(out)
    n_sparse = sum(k != "attn_local" for k in cfg.layer_kinds()) * 4
    assert launches[0] == (0, 0)
    assert launches[1][1] == n_sparse and launches[1][0] >= n_sparse
    assert len(checks["sparse_decode"]) == n_sparse
    assert len(checks["chunk_bounds"]) + len(checks["chunk_bounds_gqa"]) \
        == launches[1][0]
    bad = [(name, row) for name, rows in checks.items() for row in rows
           if not row["ok"]]
    assert not bad, bad[:4]
    for got, want in zip(outs[1], outs[0]):
        top = want.abs().max().item()
        bar = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
        assert (got - want).abs().max().item() <= bar
