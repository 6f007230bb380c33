"""Dispatching wrapper for the LKA chunk bounds (kernel B1).

Two entries over one CUDA kernel (``csrc/chunk_bounds.cu``): the Pallas
contract :func:`chunk_bounds` on (B, Hkv, nc, hd) abstracts, and the
engine's :func:`chunk_bounds_gqa` on the tier store's (B, nc, Hkv, hd)
stack, read in place through strides, and q in its own dtype: one CUDA
launch a call.  A CUDA tensor launches the kernel; a CPU tensor takes the
plain version in ``ref.py``.  ``launches`` counts kernel launches only."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_bounds.ref import (chunk_bounds_gqa_ref,
                                                  chunk_bounds_ref)

launches = 0
MAX_HD = 256


def _launch(q4: torch.Tensor, kmax: torch.Tensor, kmin: torch.Tensor,
            h_dim: int, c_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q4: (B, Hkv, G, hd), read in its own dtype (f32, fp16, bf16);
    kmax/kmin f32 with the kv-head axis at ``h_dim`` and the chunk axis at
    ``c_dim``.  One CUDA launch."""
    global launches
    B, Hkv, G, hd = q4.shape
    nc = kmax.shape[c_dim]
    if (kmax.dtype != torch.float32 or kmin.dtype != torch.float32
            or kmax.shape != kmin.shape or not kmax.is_cuda
            or not kmin.is_cuda or kmax.shape[h_dim] != Hkv
            or kmax.shape[-1] != hd or hd % 4 or not 4 <= hd <= MAX_HD):
        raise ValueError(
            f"chunk_bounds: q {tuple(q4.shape)}, kmax {tuple(kmax.shape)} "
            f"{kmax.dtype}, kmin {tuple(kmin.shape)} {kmin.dtype} do not "
            f"match the kernel's f32 CUDA contract (hd a multiple of 4 up "
            f"to {MAX_HD})")
    if not _strided_ok(kmax, kmin):
        kmax, kmin = build.aligned(kmax), build.aligned(kmin)
    if q4.dtype not in build.DTYPE_CODES:
        q4 = q4.float()
    q4 = build.aligned(q4)
    ub = torch.empty((B, Hkv, nc), dtype=torch.float32, device=q4.device)
    lb = torch.empty_like(ub)
    rc = build.library().leoam_chunk_bounds(
        q4.data_ptr(), kmax.data_ptr(), kmin.data_ptr(), ub.data_ptr(),
        lb.data_ptr(), B, Hkv, G, nc, hd, build.DTYPE_CODES[q4.dtype],
        kmax.stride(0), kmax.stride(h_dim), kmax.stride(c_dim),
        build.stream_ptr(q4))
    build.check(rc, "chunk_bounds")
    launches += 1
    return ub, lb


def _strided_ok(kmax: torch.Tensor, kmin: torch.Tensor) -> bool:
    """Both planes read in place: rows of contiguous values, 16-byte
    aligned, the same strides, each a multiple of 4."""
    return (kmax.stride() == kmin.stride() and kmax.stride(-1) == 1
            and all(s % 4 == 0 for s in kmax.stride()[:-1])
            and kmax.data_ptr() % 16 == 0 and kmin.data_ptr() % 16 == 0)


def chunk_bounds(q: torch.Tensor, kmax: torch.Tensor, kmin: torch.Tensor,
                 *, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hkv, G, hd) any float; kmax/kmin: (B, Hkv, nc, hd) f32 ->
    (ub, lb) (B, Hkv, nc) f32."""
    if not build.use_kernel(impl, q):
        return chunk_bounds_ref(q, kmax, kmin)
    return _launch(q, kmax, kmin, h_dim=1, c_dim=2)


def chunk_bounds_gqa(q: torch.Tensor, kmax: torch.Tensor, kmin: torch.Tensor,
                     *, impl: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, hd) any float (pre-scaled); kmax/kmin: (B, nc, Hkv, hd)
    f32 -> (ub, lb) (B, Hkv, nc) f32, group-summed over H // Hkv."""
    if not build.use_kernel(impl, q):
        return chunk_bounds_gqa_ref(q, kmax, kmin)
    B, H, hd = q.shape
    Hkv = kmax.shape[2]
    return _launch(q.reshape(B, Hkv, H // Hkv, hd), kmax, kmin,
                   h_dim=2, c_dim=1)
