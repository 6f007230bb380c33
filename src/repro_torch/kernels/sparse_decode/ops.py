"""Dispatching wrapper for sparse decode attention (kernel B2).

Two entries over one CUDA kernel (``csrc/sparse_decode.cu``): the engine's
:func:`sparse_decode_pooled` (slot-indexed reads from the device pool slab,
per-sequence lengths, the new token's row) and the Pallas contract
:func:`sparse_decode` (a (B, S, Hkv, hd) cache viewed as a slab of chunks,
returning the partial-softmax triple).  A CUDA tensor launches the kernel;
a CPU tensor takes the plain version in ``ref.py``.  ``launches`` counts
kernel launches only."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sparse_decode.ref import (model_scale,
                                                   sparse_decode_pooled_ref,
                                                   sparse_decode_ref)

launches = 0


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
    global launches
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
    rc = build.library().leoam_sparse_decode(
        q.data_ptr(), pool_kv.data_ptr(),
        pool_kv.data_ptr() + plane * pool_kv.element_size(), 2 * plane,
        slots.data_ptr(), chunk_ids.data_ptr(), nmax, 0, nmax, 0,
        lengths.data_ptr(), 1, k_new.data_ptr(), v_new.data_ptr(), B, Hkv, G,
        hd, chunk, model_scale(hd, q.dtype),
        float(attn_softcap) if attn_softcap is not None else 0.0,
        out.data_ptr(), None, None, None, build.DTYPE_CODES[pool_kv.dtype],
        build.DTYPE_CODES[q.dtype], build.stream_ptr(q))
    build.check(rc, "sparse_decode_pooled")
    launches += 1
    return out


def sparse_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ids: torch.Tensor, length, *, chunk: int,
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pallas contract: q (B, Hkv, G, hd) pre-scaled; k/v (B, S, Hkv, hd);
    ids (B, Hkv, nsel); scalar length -> (num, den, m) f32 triple."""
    if not build.use_kernel(impl, q):
        return sparse_decode_ref(q, k, v, ids, length, chunk=chunk)
    global launches
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
    rc = build.library().leoam_sparse_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), chunk * Hkv * hd,
        ids.data_ptr(), ids.data_ptr(), Hkv * nsel, nsel, nsel, S // chunk,
        lens.data_ptr(), 0, None, None, B, Hkv, G, hd, chunk, 1.0, 0.0, None,
        num.data_ptr(), den.data_ptr(), m.data_ptr(),
        build.DTYPE_CODES[k.dtype], build.DTYPE_CODES[torch.float32],
        build.stream_ptr(q))
    build.check(rc, "sparse_decode")
    launches += 1
    return num, den, m
