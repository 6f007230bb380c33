"""Dispatching wrappers for KV transit decompression (kernel B3).

A CUDA tensor launches ``csrc/kv_dequant.cu``; a CPU tensor takes the plain
version in ``ref.py``.  Both entries run the same kernel:
:func:`kv_dequant_scatter` writes a layer's codec upload straight into its
pool slots, :func:`kv_dequant` (the Pallas contract) into a fresh tensor.
``launches`` counts kernel launches only, of both entries."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_quant.ref import (dequant_int4_ref,
                                              dequant_int8_ref,
                                              kv_dequant_scatter_ref)

launches = 0

_BITS = {"int4": 4, "int8": 8}


def access_width(codec: str, data: torch.Tensor, scale: torch.Tensor,
                 out: torch.Tensor) -> int:
    """The payload bytes a kernel thread loads at once: the widest of 8, 4
    and 2 whose outputs make one store of at most 16 bytes and that the
    packed row width and every base pointer allow, else 1 (element-wise
    stores, for an output at any element offset)."""
    e = 2 if codec == "int4" else 1
    dp, sz = data.shape[-1], out.element_size()
    for w in (8, 4, 2):
        if (w * e * sz <= 16 and dp % w == 0 and data.data_ptr() % w == 0
                and scale.data_ptr() % (16 if w * e % 4 == 0 else 4) == 0
                and out.data_ptr() % (w * e * sz) == 0):
            return w
    return 1


def _check_codec(codec: str, data: torch.Tensor, scale: torch.Tensor,
                 rows: int) -> None:
    if codec not in _BITS:
        raise ValueError(f"unknown codec {codec!r}")
    d = scale.shape[-1] if scale.dim() == 2 else -1
    dp = d // 2 if codec == "int4" else d
    if (data.dtype != torch.int8 or scale.dtype != torch.float32
            or data.dim() != 3 or scale.dim() != 2
            or data.shape[0] != rows or scale.shape[0] != rows
            or data.shape[-1] != dp or (codec == "int4" and d % 2)):
        raise ValueError(
            f"data {tuple(data.shape)} {data.dtype}, scale "
            f"{tuple(scale.shape)} {scale.dtype}: not a {codec} payload of "
            f"{rows} chunk planes")


def _launch(codec: str, data: torch.Tensor, scale: torch.Tensor,
            out: torch.Tensor, slots: Optional[torch.Tensor], n: int,
            planes: int, slot_stride: int, name: str) -> None:
    global launches
    if not (scale.is_cuda and out.is_cuda and data.device == scale.device
            == out.device):
        raise ValueError(f"{name}: data, scale and output must share one "
                         f"CUDA device")
    data = data.contiguous()
    scale = scale.contiguous()
    _, c, _ = data.shape
    if n == 0 or c == 0:
        return                                   # nothing to launch
    rc = build.library().leoam_kv_dequant_scatter(
        data.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if slots is None else slots.data_ptr(), n, planes, c,
        scale.shape[-1], _BITS[codec], build.DTYPE_CODES[out.dtype],
        slot_stride, access_width(codec, data, scale, out),
        build.stream_ptr(data))
    build.check(rc, name)
    launches += 1


def kv_dequant(data: torch.Tensor, scale: torch.Tensor, *,
               codec: str = "int4", out_dtype=torch.bfloat16,
               impl: Optional[str] = None) -> torch.Tensor:
    """data: (N, c, dp) int8 with dp = d (int8) or d // 2 (packed int4);
    scale: (N, d) f32 -> (N, c, d) ``out_dtype``."""
    if codec not in _BITS:
        raise ValueError(f"unknown codec {codec!r}")
    if not build.use_kernel(impl, data):
        fn = dequant_int4_ref if codec == "int4" else dequant_int8_ref
        return fn(data, scale, out_dtype)
    if out_dtype not in build.DTYPE_CODES:
        raise ValueError(f"kv_dequant: no kernel for output {out_dtype}")
    _check_codec(codec, data, scale, data.shape[0])
    N, c, _ = data.shape
    d = scale.shape[-1]
    out = torch.empty((N, c, d), dtype=out_dtype, device=data.device)
    _launch(codec, data, scale, out, None, N, 1, c * d, "kv_dequant")
    return out


def kv_dequant_scatter(data: torch.Tensor, scale: torch.Tensor,
                       slab: torch.Tensor, slots: Sequence[int], *,
                       codec: str, impl: Optional[str] = None) -> None:
    """Dequantize the K and V planes of ``n = len(slots)`` chunks straight
    into their slots of ``slab``, in place, in the slab's dtype.

    data: (planes·n, c, dp) int8, plane-major (the K planes of the n
    chunks, then the V planes), dp = d (int8) or d // 2 (packed int4);
    scale: (planes·n, d) f32; slab: (S, planes, c, Hkv, hd), contiguous,
    Hkv·hd = d; slots: n distinct ints in [0, S), a host sequence (checked
    here, where the list is built, and copied to the card without a
    synchronisation).  Chunk i's plane p lands in ``slab[slots[i], p]``."""
    if isinstance(slots, torch.Tensor) and slots.device.type != "cpu":
        raise ValueError("kv_dequant_scatter: slots must be a host sequence")
    idx = np.asarray(slots, dtype=np.int64).reshape(-1)
    n = len(idx)
    if slab.dtype not in build.DTYPE_CODES:
        raise ValueError(f"kv_dequant_scatter: no kernel writes a "
                         f"{slab.dtype} slab")
    if not slab.is_contiguous():
        raise ValueError("kv_dequant_scatter: the slab must be contiguous")
    if slab.dim() != 5:
        raise ValueError(f"kv_dequant_scatter: slab {tuple(slab.shape)} is "
                         f"not (slots, planes, chunk, Hkv, hd)")
    S, planes, c, hkv, hd = slab.shape
    _check_codec(codec, data, scale, planes * n)
    if scale.shape[-1] != hkv * hd or data.shape[1] != c:
        raise ValueError(
            f"kv_dequant_scatter: payload {tuple(data.shape)} with d = "
            f"{scale.shape[-1]} does not fit slab rows (c={c}, Hkv·hd="
            f"{hkv * hd})")
    if n and (idx.min() < 0 or idx.max() >= S):
        raise ValueError(f"kv_dequant_scatter: slots {idx.tolist()} outside "
                         f"[0, {S})")
    if len(np.unique(idx)) != n:
        raise ValueError(f"kv_dequant_scatter: duplicate slots "
                         f"{idx.tolist()}")
    if not build.use_kernel(impl, slab):
        kv_dequant_scatter_ref(data, scale, slab, torch.from_numpy(idx),
                               codec)
        return
    if n == 0:
        return
    # pinned, so the copy is enqueued on the stream with no synchronisation
    slots_dev = torch.from_numpy(idx).pin_memory().to(slab.device,
                                                      non_blocking=True)
    _launch(codec, data, scale, slab, slots_dev, n, planes,
            planes * c * hkv * hd, "kv_dequant_scatter")
