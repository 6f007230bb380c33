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

import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_bounds import ops as cb_ops
from repro_torch.kernels.kv_quant import ops as kq_ops
from repro_torch.kernels.pq import ops as pq_ops
from repro_torch.kernels.sparse_decode import ops as sd_ops
from repro_torch.kernels.sparse_decode.ref import (BF16_MAX_MISMATCH,
                                                   bf16_agreement)

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
                                    "b3", "b3_scatter", "b5"])
def test_cuda_kernels_per_call(cuda, rng, kernel):
    """B1 (any q dtype, either layout) is one CUDA kernel, B5 its two (the
    partials, then their fold): no cast of q, no fill of outputs that the
    kernels write in full.  B3 is one CUDA kernel on either entry; the
    scatter's only other device work is the copy of its slot list."""
    if kernel.startswith("b1"):
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
