"""Dispatching wrapper for KV transit decompression (kernel B3).

A CUDA tensor launches ``csrc/kv_dequant.cu``; a CPU tensor takes the plain
version in ``ref.py``.  ``launches`` counts kernel launches only."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_quant.ref import dequant_int4_ref, dequant_int8_ref

launches = 0


def kv_dequant(data: torch.Tensor, scale: torch.Tensor, *,
               codec: str = "int4", out_dtype=torch.bfloat16,
               impl: Optional[str] = None) -> torch.Tensor:
    """data: (N, c, dp) int8 with dp = d (int8) or d // 2 (packed int4);
    scale: (N, d) f32 -> (N, c, d) ``out_dtype``."""
    if codec not in ("int4", "int8"):
        raise ValueError(f"unknown codec {codec!r}")
    if not build.use_kernel(impl, data):
        fn = dequant_int4_ref if codec == "int4" else dequant_int8_ref
        return fn(data, scale, out_dtype)
    global launches
    N, c, dp = data.shape
    d = scale.shape[-1]
    if (data.dtype != torch.int8 or scale.dtype != torch.float32
            or scale.shape[0] != N or dp != (d // 2 if codec == "int4" else d)
            or not scale.is_cuda or out_dtype not in build.DTYPE_CODES):
        raise ValueError(
            f"kv_dequant: data {tuple(data.shape)} {data.dtype}, scale "
            f"{tuple(scale.shape)} {scale.dtype} on {scale.device}, codec "
            f"{codec}, out {out_dtype} is not a supported combination")
    data = data.contiguous()
    scale = scale.contiguous()
    out = torch.empty((N, c, d), dtype=out_dtype, device=data.device)
    rc = build.library().leoam_kv_dequant(
        data.data_ptr(), scale.data_ptr(), out.data_ptr(), N, c, d,
        4 if codec == "int4" else 8, build.DTYPE_CODES[out_dtype],
        build.stream_ptr(data))
    build.check(rc, "kv_dequant")
    launches += 1
    return out
