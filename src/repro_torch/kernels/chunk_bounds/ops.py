"""Dispatching wrappers for the LKA chunk bounds (kernel B1 and its latent
variant).

Two entries over one CUDA kernel (``csrc/chunk_bounds.cu``): the Pallas
contract :func:`chunk_bounds` on (B, Hkv, nc, hd) abstracts, and the
engine's :func:`chunk_bounds_gqa` on the tier store's (B, nc, Hkv, hd)
stack, read in place through strides, and q in its own dtype: one CUDA
launch a call.  :func:`chunk_bounds_latent` is B1's latent variant
(``csrc/chunk_bounds_latent.cu``) for MLA: one logical kv head, many q
heads, rows of 576.  A CUDA tensor launches the kernel; a CPU tensor takes
the plain version in ``ref.py``.  ``launches`` and ``latent_launches``
count kernel launches only.

The two GQA entries are ``torch.library`` custom ops
(``torch.ops.repro_torch.chunk_bounds`` / ``chunk_bounds_gqa``): the CUDA
implementation is the kernel, the CPU one the plain version, and a fake
implementation gives the output shapes, so the decode path traces under
``FakeTensorMode`` (``launch/dryrun.py``).  :func:`cost_chunk_bounds` and
:func:`cost_chunk_bounds_gqa` give a call's (flops, bytes), which
``launch/op_costing.py`` charges for the op."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_bounds.ref import (chunk_bounds_gqa_ref,
                                                  chunk_bounds_ref)

launches = 0
latent_launches = 0
MAX_HD = 256
LAT_MAX_D = 1024             # the latent variant's row width (shared q)


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
    if impl == "ref":
        return chunk_bounds_ref(q, kmax, kmin)
    build.use_kernel(impl, q)        # refuses another impl or device
    return torch.ops.repro_torch.chunk_bounds(q, kmax, kmin)


def chunk_bounds_gqa(q: torch.Tensor, kmax: torch.Tensor, kmin: torch.Tensor,
                     *, impl: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, hd) any float (pre-scaled); kmax/kmin: (B, nc, Hkv, hd)
    f32 -> (ub, lb) (B, Hkv, nc) f32, group-summed over H // Hkv."""
    if impl == "ref":
        return chunk_bounds_gqa_ref(q, kmax, kmin)
    build.use_kernel(impl, q)        # refuses another impl or device
    return torch.ops.repro_torch.chunk_bounds_gqa(q, kmax, kmin)


# The entries as custom ops: CPU -> the plain version, CUDA -> the kernel,
# fake tensors -> the output shapes.

@torch.library.custom_op("repro_torch::chunk_bounds", mutates_args=(),
                         device_types="cpu")
def _chunk_bounds_op(q: torch.Tensor, kmax: torch.Tensor,
                     kmin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return chunk_bounds_ref(q, kmax, kmin)


@_chunk_bounds_op.register_kernel("cuda")
def _chunk_bounds_cuda(q, kmax, kmin):
    return _launch(q, kmax, kmin, h_dim=1, c_dim=2)


@_chunk_bounds_op.register_fake
def _chunk_bounds_fake(q, kmax, kmin):
    B, Hkv = q.shape[:2]
    ub = q.new_empty((B, Hkv, kmax.shape[2]), dtype=torch.float32)
    return ub, torch.empty_like(ub)


@torch.library.custom_op("repro_torch::chunk_bounds_gqa", mutates_args=(),
                         device_types="cpu")
def _chunk_bounds_gqa_op(q: torch.Tensor, kmax: torch.Tensor,
                         kmin: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    return chunk_bounds_gqa_ref(q, kmax, kmin)


@_chunk_bounds_gqa_op.register_kernel("cuda")
def _chunk_bounds_gqa_cuda(q, kmax, kmin):
    B, H, hd = q.shape
    Hkv = kmax.shape[2]
    return _launch(q.reshape(B, Hkv, H // Hkv, hd), kmax, kmin,
                   h_dim=2, c_dim=1)


@_chunk_bounds_gqa_op.register_fake
def _chunk_bounds_gqa_fake(q, kmax, kmin):
    ub = q.new_empty((q.shape[0], kmax.shape[2], kmax.shape[1]),
                     dtype=torch.float32)
    return ub, torch.empty_like(ub)


def _bounds_cost(q_rows: int, nc: int, hd: int, n_out: int,
                 *inputs: torch.Tensor) -> Tuple[float, float]:
    """8 operations per (query row, chunk, coordinate): the two box
    products, their max and min, and the two sums; bytes: every input read
    once, ub and lb (f32) written once."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    return float(8 * q_rows * nc * hd), float(nbytes + 2 * n_out * 4)


def cost_chunk_bounds(q: torch.Tensor, kmax: torch.Tensor,
                      kmin: torch.Tensor) -> Tuple[float, float]:
    """(flops, bytes) of one :func:`chunk_bounds` call (shapes only)."""
    B, Hkv, G, hd = q.shape
    nc = kmax.shape[2]
    return _bounds_cost(B * Hkv * G, nc, hd, B * Hkv * nc, q, kmax, kmin)


def cost_chunk_bounds_gqa(q: torch.Tensor, kmax: torch.Tensor,
                          kmin: torch.Tensor) -> Tuple[float, float]:
    """(flops, bytes) of one :func:`chunk_bounds_gqa` call (shapes only)."""
    B, H, hd = q.shape
    nc, Hkv = kmax.shape[1], kmax.shape[2]
    return _bounds_cost(B * H, nc, hd, B * Hkv * nc, q, kmax, kmin)


def chunk_bounds_latent(q: torch.Tensor, kmax: torch.Tensor,
                        kmin: torch.Tensor, *, impl: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, D) any float (pre-scaled); kmax/kmin: (B, nc, 1, D) f32
    latent boxes -> (ub, lb) (B, 1, nc) f32, summed over the H heads: the
    GQA bound at one kv head, on the latent variant of the kernel."""
    global latent_launches
    if not build.use_kernel(impl, q):
        return chunk_bounds_gqa_ref(q, kmax, kmin)
    B, H, D = q.shape
    nc = kmax.shape[1]
    if (kmax.dtype != torch.float32 or kmin.dtype != torch.float32
            or kmax.shape != kmin.shape or kmax.dim() != 4
            or tuple(kmax.shape[::2]) != (B, 1) or kmax.shape[3] != D
            or not kmax.is_cuda or not kmin.is_cuda or D % 4
            or not 4 <= D <= LAT_MAX_D):
        raise ValueError(
            f"chunk_bounds_latent: q {tuple(q.shape)}, kmax "
            f"{tuple(kmax.shape)} {kmax.dtype}, kmin {tuple(kmin.shape)} "
            f"{kmin.dtype} do not match the kernel's f32 CUDA contract "
            f"(one kv head, D a multiple of 4 up to {LAT_MAX_D})")
    kmax, kmin = build.aligned(kmax), build.aligned(kmin)
    if q.dtype not in build.DTYPE_CODES:
        q = q.float()
    q = build.aligned(q)
    ub = torch.empty((B, 1, nc), dtype=torch.float32, device=q.device)
    lb = torch.empty_like(ub)
    rc = build.library().leoam_chunk_bounds_latent(
        q.data_ptr(), kmax.data_ptr(), kmin.data_ptr(), ub.data_ptr(),
        lb.data_ptr(), B, H, nc, D, build.DTYPE_CODES[q.dtype],
        kmax.stride(0), kmax.stride(1), build.stream_ptr(q))
    build.check(rc, "chunk_bounds_latent")
    latent_launches += 1
    return ub, lb
