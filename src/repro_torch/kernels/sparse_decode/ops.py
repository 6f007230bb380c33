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
rows each split covers."""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sparse_decode.ref import (
    model_scale, sparse_decode_pooled_ref, sparse_decode_ref,
    sparse_decode_workingset_ref)

launches = 0

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
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pallas contract: q (B, Hkv, G, hd) pre-scaled; k/v (B, S, Hkv, hd);
    ids (B, Hkv, nsel); scalar length -> (num, den, m) f32 triple."""
    if not build.use_kernel(impl, q):
        return sparse_decode_ref(q, k, v, ids, length, chunk=chunk)
    B, Hkv, G, hd = q.shape
    S = k.shape[1]
    nsel = ids.shape[-1]
    _check(S % chunk == 0 and k.shape == v.shape and k.shape[2] == Hkv,
           f"k {tuple(k.shape)} / chunk {chunk} do not fit q {tuple(q.shape)}")
    _check(k.dtype == v.dtype and k.dtype in build.DTYPE_CODES and k.is_cuda
           and v.is_cuda, f"k/v dtype {k.dtype}/{v.dtype}")
    q = q.float().contiguous()
    k, v = k.contiguous(), v.contiguous()
    ids = ids.to(device=q.device, dtype=torch.int32).contiguous()
    lens = torch.as_tensor(length, dtype=torch.int32,
                           device=q.device).reshape(1)
    num = torch.empty((B, Hkv, G, hd), dtype=torch.float32, device=q.device)
    den = torch.empty((B, Hkv, G), dtype=torch.float32, device=q.device)
    m = torch.empty_like(den)
    _launch(q, k.data_ptr(), v.data_ptr(), chunk * Hkv * hd, ids, ids,
            Hkv * nsel, nsel, nsel, S // chunk, lens, 0, None, None, B, Hkv,
            G, hd, chunk, 1.0, 0.0, None, num, den, m, k.dtype,
            "sparse_decode")
    return num, den, m
