"""Dispatching wrapper for sparse decode attention (kernel B2).

Three entries over one CUDA kernel (``csrc/sparse_decode.cu``): the
engine's :func:`sparse_decode_pooled` (slot-indexed reads from the device
pool slab, per-sequence lengths, the new token's row), the legacy engine's
:func:`sparse_decode_workingset` (the same over a working set uploaded
whole, read in place) and the Pallas contract :func:`sparse_decode` (a (B,
S, Hkv, hd) cache viewed as a slab of chunks, returning the partial-softmax
triple).  A CUDA tensor launches the kernel;
a CPU tensor takes the plain version in ``ref.py``.  ``launches`` counts
wrapper calls that launched the kernel (each call is two CUDA launches:
scores, then P.V with the combine).

The kernel splits each (sequence, kv head)'s rows across blocks;
:func:`split_plan` chooses the split and :func:`split_rows` says which
rows each split covers.

B2's latent variant (``csrc/sparse_decode_latent.cu``) serves MLA's
absorbed decode: :func:`sparse_decode_latent_pooled` and
:func:`sparse_decode_latent_workingset` attend the H query heads over one
latent plane (scores over all D columns, values the first r columns of the
same rows) and return the normalized out_lat (B, H, r) f32.
``latent_launches`` counts its wrapper calls that launched it (two CUDA
launches each: the scores, then P.V, whose row splits of a sequence are
added inside one thread-block cluster); :func:`latent_split_plan` gives
both launches' plan.

The Pallas contract :func:`sparse_decode` is a ``torch.library`` custom op
(``torch.ops.repro_torch.sparse_decode``): the CUDA implementation is the
kernel, the CPU one the plain version, and a fake implementation gives the
output shapes, so ``lm.decode_step`` traces under ``FakeTensorMode``
(``launch/dryrun.py``).  :func:`cost_sparse_decode` gives its (flops,
bytes) and :func:`cost_sparse_decode_pooled` the engine entry's, from the
rows the selections hold (:func:`cost_rows`)."""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sparse_decode.ref import (
    model_scale, sparse_decode_latent_pooled_ref,
    sparse_decode_latent_workingset_ref, sparse_decode_pooled_ref,
    sparse_decode_ref, sparse_decode_workingset_ref)

launches = 0
latent_launches = 0
LAT_MAX_H = 16               # q heads on the latent plane (mma's M)
LAT_MAX_D = 704              # row width (a warp's q fragments in registers)
LAT_MAX_R = 512              # value width
LAT_BLOCKS1 = 96             # the latent scores launch aims at this many
                             # blocks (csrc: LAT_BLOCKS1)
LAT_SPLIT_ROWS = 192         # selected rows a P.V split takes (csrc)
LAT_MAX_SPLITS = 8           # P.V splits a sequence at most (csrc)

H100_SMS = 132
BLOCKS_PER_SM = 8       # blocks the split plan aims at, per SM


def split_plan(nmax: int, batch: int, n_kv_heads: int,
               n_sm: int = H100_SMS) -> Tuple[int, int]:
    """(nsplit, chunks per split) for ``nmax`` selection entries of
    ``batch`` sequences x ``n_kv_heads``: the fewest chunks per split (at
    least one) that still give the grid ``(nsplit, n_kv_heads, batch)``
    about ``BLOCKS_PER_SM`` blocks per SM, so the longest selection sets
    the work of one block and short ones spread over more blocks."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // max(1, batch * n_kv_heads)))
    cps = max(1, nmax // want)
    return max(1, -(-nmax // cps)), cps


def split_rows(nmax: int, chunk: int, nsplit: int, cps: int
               ) -> List[List[int]]:
    """The rows t of the (nmax * chunk + 1)-row score vector each split
    covers: entries [s * cps, (s + 1) * cps) as rows j * chunk + r; the
    new token's row (the last) belongs to the last split."""
    out = []
    for s in range(nsplit):
        lo, hi = min(nmax, s * cps), min(nmax, (s + 1) * cps)
        out.append(list(range(lo * chunk, hi * chunk)))
    out[-1].append(nmax * chunk)
    return out


def latent_split_plan(nsel: int, chunk: int, batch: int
                      ) -> Tuple[int, int, int]:
    """The latent kernel's launch plan for ``batch`` sequences of ``nsel``
    selection entries of ``chunk`` rows (``csrc/sparse_decode_latent.cu:
    lat_plan``): (rows a scores block takes, scores blocks a sequence,
    row splits of the P.V launch).  A scores block takes one tile of one
    entry, the largest of 64, 32 and 16 rows that still gives the grid
    ``LAT_BLOCKS1`` blocks; the P.V launch splits each sequence's live rows
    into about ``LAT_SPLIT_ROWS`` a split, at most ``LAT_MAX_SPLITS`` (one
    cluster), as :func:`latent_split_rows` cuts them."""
    tr = 64
    while tr > 16 and batch * nsel * -(-chunk // tr) < LAT_BLOCKS1:
        tr //= 2
    tr1 = min(tr, -(-chunk // 8) * 8)
    nblk1 = max(1, nsel * -(-chunk // tr1))
    nsplit = min(LAT_MAX_SPLITS, max(1, -(-nsel * chunk // LAT_SPLIT_ROWS)))
    return tr1, nblk1, nsplit


def latent_split_rows(n_live: int, nsplit: int) -> List[Tuple[int, int]]:
    """The [start, end) of each P.V split among a sequence's ``n_live``
    live rows in order (its selected entries' live rows, then the new
    token's): equal runs of a multiple of 16 rows (an mma k-step), the
    last ones possibly empty."""
    per = -(-(-(-n_live // nsplit)) // 16) * 16
    return [(min(n_live, s * per), min(n_live, (s + 1) * per))
            for s in range(nsplit)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k, v, row_stride, slot_idx, cid_idx, idx_b_stride,
            idx_h_stride, nsel, row_b_offset, lengths, len_b_stride, k_new,
            v_new, B, Hkv, G, hd, chunk, q_scale, softcap, out, num, den, m,
            kv_dtype, name):
    """One call of the kernel: the split plan, its f32 scratch, the
    entry."""
    global launches
    _check(hd * kv_dtype.itemsize % 16 == 0 and hd <= 256 and G <= 16,
           f"hd {hd} x {kv_dtype} rows must be a multiple of 16 bytes, "
           f"hd <= 256, G {G} <= 16")
    nsplit, cps = split_plan(nsel, B, Hkv, _sm_count(q.device.index or 0))
    scratch = torch.empty(
        B * Hkv * (G * (nsel * chunk + 1 + nsplit * (hd + 2)) + 1),
        dtype=torch.float32, device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = build.library().leoam_sparse_decode(
        q.data_ptr(), k, v, row_stride, slot_idx.data_ptr(),
        cid_idx.data_ptr(), idx_b_stride, idx_h_stride, nsel, row_b_offset,
        lengths.data_ptr(), len_b_stride, ptr(k_new), ptr(v_new), B, Hkv, G,
        hd, chunk, nsplit, cps, q_scale, softcap, scratch.data_ptr(),
        ptr(out), ptr(num), ptr(den), ptr(m), build.DTYPE_CODES[kv_dtype],
        build.DTYPE_CODES[q.dtype], build.stream_ptr(q))
    build.check(rc, name)
    launches += 1


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"sparse_decode: {what}")


def sparse_decode_pooled(q: torch.Tensor, pool_kv: torch.Tensor,
                         slots: torch.Tensor, chunk_ids: torch.Tensor,
                         lengths: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor,
                         attn_softcap: Optional[float] = None, *,
                         impl: Optional[str] = None) -> torch.Tensor:
    """Normalized sparse attention of the engine's decode round.  See
    :func:`~repro_torch.kernels.sparse_decode.ref.sparse_decode_pooled_ref`
    for the contract.  Returns (B, H, hd) in q's dtype."""
    if not build.use_kernel(impl, q):
        return sparse_decode_pooled_ref(q, pool_kv, slots, chunk_ids,
                                        lengths, k_new, v_new, attn_softcap)
    B, H, hd = q.shape
    _, planes, chunk, Hkv, hd2 = pool_kv.shape
    G = H // Hkv
    nmax = slots.shape[1]
    _check(planes == 2 and hd2 == hd and G * Hkv == H,
           f"pool {tuple(pool_kv.shape)} does not fit q {tuple(q.shape)}")
    _check(pool_kv.is_contiguous() and pool_kv.is_cuda, "pool must be a "
           "contiguous CUDA tensor")
    _check(all(t.is_cuda and t.dtype == torch.int32 for t in
               (slots, chunk_ids, lengths)), "indices must be int32 on CUDA")
    _check(q.dtype in build.DTYPE_CODES and pool_kv.dtype in build.DTYPE_CODES,
           f"dtypes {q.dtype} / {pool_kv.dtype}")
    q = q.contiguous()
    slots, chunk_ids = slots.contiguous(), chunk_ids.contiguous()
    k_new = k_new.reshape(B, Hkv, hd).to(q.dtype).contiguous()
    v_new = v_new.reshape(B, Hkv, hd).to(q.dtype).contiguous()
    out = torch.empty_like(q)
    plane = chunk * Hkv * hd
    _launch(q, pool_kv.data_ptr(),
            pool_kv.data_ptr() + plane * pool_kv.element_size(), 2 * plane,
            slots, chunk_ids, nmax, 0, nmax, 0, lengths, 1, k_new, v_new, B,
            Hkv, G, hd, chunk, model_scale(hd, q.dtype),
            float(attn_softcap) if attn_softcap is not None else 0.0, out,
            None, None, None, pool_kv.dtype, "sparse_decode_pooled")
    return out


def sparse_decode_workingset(q: torch.Tensor, kg: torch.Tensor,
                             vg: torch.Tensor, chunk_ids: torch.Tensor,
                             lengths: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor,
                             attn_softcap: Optional[float] = None, *,
                             impl: Optional[str] = None) -> torch.Tensor:
    """Normalized sparse attention of the legacy engine's round, over the
    padded working set kg/vg (B, nmax, chunk, Hkv, hd) uploaded whole.  See
    :func:`~repro_torch.kernels.sparse_decode.ref.sparse_decode_workingset_ref`
    for the contract.  The kernel reads kg and vg in place as a slab with
    one chunk per row, entry j of sequence b at row b * nmax + j, with the
    pooled call's mask and split plan, so over the same rows it returns
    the pooled call's bits.  Returns (B, H, hd) in q's dtype."""
    if not build.use_kernel(impl, q):
        return sparse_decode_workingset_ref(q, kg, vg, chunk_ids, lengths,
                                            k_new, v_new, attn_softcap)
    B, H, hd = q.shape
    _, nmax, chunk, Hkv, hd2 = kg.shape
    G = H // Hkv
    _check(kg.shape == vg.shape and kg.shape[0] == B and hd2 == hd
           and G * Hkv == H and tuple(chunk_ids.shape) == (B, nmax),
           f"working set {tuple(kg.shape)} / {tuple(vg.shape)} does not fit "
           f"q {tuple(q.shape)} and chunk ids {tuple(chunk_ids.shape)}")
    _check(kg.is_contiguous() and vg.is_contiguous() and kg.is_cuda
           and vg.is_cuda and kg.dtype == vg.dtype,
           "kg / vg must be contiguous CUDA tensors of one dtype")
    _check(all(t.is_cuda and t.dtype == torch.int32 for t in
               (chunk_ids, lengths)), "indices must be int32 on CUDA")
    _check(q.dtype in build.DTYPE_CODES and kg.dtype in build.DTYPE_CODES,
           f"dtypes {q.dtype} / {kg.dtype}")
    q = q.contiguous()
    chunk_ids = chunk_ids.contiguous()
    slots = torch.arange(B * nmax, dtype=torch.int32, device=q.device)
    k_new = k_new.reshape(B, Hkv, hd).to(q.dtype).contiguous()
    v_new = v_new.reshape(B, Hkv, hd).to(q.dtype).contiguous()
    out = torch.empty_like(q)
    _launch(q, kg.data_ptr(), vg.data_ptr(), chunk * Hkv * hd, slots,
            chunk_ids, nmax, 0, nmax, 0, lengths, 1, k_new, v_new, B, Hkv, G,
            hd, chunk, model_scale(hd, q.dtype),
            float(attn_softcap) if attn_softcap is not None else 0.0, out,
            None, None, None, kg.dtype, "sparse_decode_workingset")
    return out


def sparse_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ids: torch.Tensor, length, *, chunk: int,
                  attn_softcap: Optional[float] = None,
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pallas contract: q (B, Hkv, G, hd) pre-scaled; k/v (B, S, Hkv, hd);
    ids (B, Hkv, nsel); scalar length (an int; a tensor is read on the
    host) -> (num, den, m) f32 triple.  q in the cache's dtype runs the
    kernel at that model dtype (probabilities rounded to it for P·V, as
    ``lm.decode_step``'s sparse attention rounds them); any other q runs
    in f32.  ``attn_softcap`` caps the scores (gemma2)."""
    if impl == "ref":
        return sparse_decode_ref(q, k, v, ids, length, chunk=chunk,
                                 attn_softcap=attn_softcap)
    build.use_kernel(impl, q)        # refuses another impl or device
    return torch.ops.repro_torch.sparse_decode(
        q, k, v, ids, int(length), chunk,
        None if attn_softcap is None else float(attn_softcap))


@torch.library.custom_op("repro_torch::sparse_decode", mutates_args=(),
                         device_types="cpu")
def _sparse_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ids: torch.Tensor, length: int, chunk: int,
                      attn_softcap: Optional[float]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return sparse_decode_ref(q, k, v, ids, length, chunk=chunk,
                             attn_softcap=attn_softcap)


@_sparse_decode_op.register_fake
def _sparse_decode_fake(q, k, v, ids, length, chunk, attn_softcap):
    num = q.new_empty(q.shape, dtype=torch.float32)
    den = q.new_empty(q.shape[:3], dtype=torch.float32)
    return num, den, torch.empty_like(den)


@_sparse_decode_op.register_kernel("cuda")
def _sparse_decode_cuda(q, k, v, ids, length, chunk, attn_softcap):
    B, Hkv, G, hd = q.shape
    S = k.shape[1]
    nsel = ids.shape[-1]
    _check(S % chunk == 0 and k.shape == v.shape and k.shape[2] == Hkv,
           f"k {tuple(k.shape)} / chunk {chunk} do not fit q {tuple(q.shape)}")
    _check(k.dtype == v.dtype and k.dtype in build.DTYPE_CODES and k.is_cuda
           and v.is_cuda, f"k/v dtype {k.dtype}/{v.dtype}")
    q = (q if q.dtype == k.dtype else q.float()).contiguous()
    k, v = k.contiguous(), v.contiguous()
    ids = ids.to(device=q.device, dtype=torch.int32).contiguous()
    # the length is filled on the device: no host-to-device copy, so no
    # wait for the stream at every call
    lens = torch.full((1,), length, dtype=torch.int32, device=q.device)
    num = torch.empty((B, Hkv, G, hd), dtype=torch.float32, device=q.device)
    den = torch.empty((B, Hkv, G), dtype=torch.float32, device=q.device)
    m = torch.empty_like(den)
    _launch(q, k.data_ptr(), v.data_ptr(), chunk * Hkv * hd, ids, ids,
            Hkv * nsel, nsel, nsel, S // chunk, lens, 0, None, None, B, Hkv,
            G, hd, chunk, 1.0,
            float(attn_softcap) if attn_softcap is not None else 0.0, None,
            num, den, m, k.dtype, "sparse_decode")
    return num, den, m


def cost_rows(kv_rows: int, new_rows: int, heads_per_kv: int, hd: int,
              kv_itemsize: int, io_bytes: int) -> Tuple[float, float]:
    """(flops, bytes) of B2 over ``kv_rows`` cache rows, summed over every
    (sequence, kv head), and ``new_rows`` new-token rows: each row costs
    its ``heads_per_kv`` q heads 2·hd for the score and 2·hd for P·V;
    the cache rows' K and V are read once (the selected chunks' rows,
    never the whole cache), beside ``io_bytes`` for q, the new rows, the
    indices and the outputs."""
    flops = 4 * heads_per_kv * hd * (kv_rows + new_rows)
    return float(flops), float(2 * kv_rows * hd * kv_itemsize + io_bytes)


def cost_sparse_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       ids: torch.Tensor, length: int, chunk: int,
                       attn_softcap: Optional[float] = None
                       ) -> Tuple[float, float]:
    """(flops, bytes) of one :func:`sparse_decode` call from its shapes and
    ``length``: each (sequence, kv head) attends its ``nsel`` chunks' rows
    up to the fill, ``min(nsel * chunk, length)``; q is read in the
    kernel's dtype, ids as int32, (num, den, m) written in f32."""
    B, Hkv, G, hd = q.shape
    nsel = ids.shape[-1]
    rows = B * Hkv * min(nsel * chunk, max(int(length), 0))
    q_item = k.element_size() if q.dtype == k.dtype else 4
    io = q.numel() * q_item + ids.numel() * 4 + 4 + B * Hkv * G * (hd + 2) * 4
    return cost_rows(rows, 0, G, hd, k.element_size(), io)


def cost_sparse_decode_pooled(q: torch.Tensor, pool_kv: torch.Tensor,
                              slots: torch.Tensor, chunk_ids: torch.Tensor,
                              lengths: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor, *, live_rows: int
                              ) -> Tuple[float, float]:
    """(flops, bytes) of one :func:`sparse_decode_pooled` call.  The data
    decides its rows: ``live_rows`` is the selected chunks' rows below each
    sequence's length, summed over the sequences (every kv head reads
    them); each sequence's new token adds one row; q, the new K/V rows,
    the output (q's shape and dtype) and the index arrays move once."""
    B, H, hd = q.shape
    Hkv = pool_kv.shape[3]
    io = sum(t.numel() * t.element_size()
             for t in (q, k_new, v_new, q, slots, chunk_ids, lengths))
    return cost_rows(live_rows * Hkv, B * Hkv, H // Hkv, hd,
                     pool_kv.element_size(), io)


def _launch_latent(q, slab_ptr, slot_stride, slots, chunk_ids, lengths,
                   lat_new, r, chunk, slab_dtype, name):
    """One call of the latent kernel over slab rows ``slot * slot_stride +
    row * D``: its f32 scratch (the size the library names), the entry.
    Returns out_lat."""
    global latent_launches
    B, H, D = q.shape
    nsel = slots.shape[1]
    _check(H <= LAT_MAX_H and D % 2 == 0 and D <= LAT_MAX_D and r % 2 == 0
           and 0 < r <= min(D, LAT_MAX_R) and slab_dtype == torch.float16,
           f"q {tuple(q.shape)}, r {r}, slab {slab_dtype}: the latent kernel "
           f"takes H <= {LAT_MAX_H}, even D <= {LAT_MAX_D}, even r <= "
           f"{LAT_MAX_R} and an fp16 slab")
    _check(q.dtype in build.DTYPE_CODES, f"q dtype {q.dtype}")
    _check(all(t.is_cuda and t.dtype == torch.int32 for t in
               (slots, chunk_ids, lengths)), "indices must be int32 on CUDA")
    lib = build.library()
    scratch = torch.empty(
        lib.leoam_sparse_decode_latent_scratch(B, H, r, nsel, chunk),
        dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, r), dtype=torch.float32, device=q.device)
    q = q.contiguous()
    lat_new = lat_new.reshape(B, D).to(q.dtype).contiguous()
    rc = lib.leoam_sparse_decode_latent(
        q.data_ptr(), slab_ptr, slot_stride, slots.contiguous().data_ptr(),
        chunk_ids.contiguous().data_ptr(), nsel,
        lengths.contiguous().data_ptr(), lat_new.data_ptr(), B, H, D, r,
        chunk, scratch.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[q.dtype], build.stream_ptr(q))
    build.check(rc, name)
    latent_launches += 1
    return out


def sparse_decode_latent_pooled(q: torch.Tensor, pool_kv: torch.Tensor,
                                slots: torch.Tensor, chunk_ids: torch.Tensor,
                                lengths: torch.Tensor, lat_new: torch.Tensor,
                                r: int, *, impl: Optional[str] = None
                                ) -> torch.Tensor:
    """The MLA round's latent attention over the one-plane pool slab.  See
    ``ref.sparse_decode_latent_pooled_ref`` for the contract.  Returns
    out_lat (B, H, r) f32."""
    if not build.use_kernel(impl, q):
        return sparse_decode_latent_pooled_ref(q, pool_kv, slots, chunk_ids,
                                               lengths, lat_new, r)
    _, planes, chunk, hkv, D = pool_kv.shape
    _check(planes == 1 and hkv == 1 and D == q.shape[-1],
           f"pool {tuple(pool_kv.shape)} is not one latent plane for q "
           f"{tuple(q.shape)}")
    _check(pool_kv.is_contiguous() and pool_kv.is_cuda,
           "pool must be a contiguous CUDA tensor")
    return _launch_latent(q, pool_kv.data_ptr(), chunk * D, slots,
                          chunk_ids, lengths, lat_new, r, chunk,
                          pool_kv.dtype, "sparse_decode_latent_pooled")


def sparse_decode_latent_workingset(q: torch.Tensor, latg: torch.Tensor,
                                    chunk_ids: torch.Tensor,
                                    lengths: torch.Tensor,
                                    lat_new: torch.Tensor, r: int, *,
                                    impl: Optional[str] = None
                                    ) -> torch.Tensor:
    """The legacy MLA round's latent attention over the padded working set
    latg (B, nmax, chunk, 1, D) uploaded whole, read in place as a slab of
    one chunk a row (entry j of sequence b at row b * nmax + j), with the
    pooled call's mask and split plan.  Returns out_lat (B, H, r) f32."""
    if not build.use_kernel(impl, q):
        return sparse_decode_latent_workingset_ref(q, latg, chunk_ids,
                                                   lengths, lat_new, r)
    B, nmax, chunk, hkv, D = latg.shape
    _check(hkv == 1 and D == q.shape[-1] and B == q.shape[0]
           and tuple(chunk_ids.shape) == (B, nmax),
           f"working set {tuple(latg.shape)} does not fit q "
           f"{tuple(q.shape)} and chunk ids {tuple(chunk_ids.shape)}")
    _check(latg.is_contiguous() and latg.is_cuda,
           "the working set must be a contiguous CUDA tensor")
    slots = torch.arange(B * nmax, dtype=torch.int32,
                         device=q.device).reshape(B, nmax)
    return _launch_latent(q, latg.data_ptr(), chunk * D, slots, chunk_ids,
                          lengths, lat_new, r, chunk, latg.dtype,
                          "sparse_decode_latent_workingset")
