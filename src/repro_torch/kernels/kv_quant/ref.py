"""Plain PyTorch versions of the kv_dequant kernel (int4/int8 transit
codec): the dequant alone, and the dequant scattered into pool slots."""

from __future__ import annotations

import torch


def dequant_int8_ref(data: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """data: (N, c, d) int8; scale: (N, d) f32 -> (N, c, d)."""
    return (data.float() * scale[:, None, :]).to(dtype)


def dequant_int4_ref(data: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """data: (N, c, d//2) int8 packed nibbles; scale: (N, d) f32 -> (N, c, d).

    Packing: byte = lo | (hi << 4); values are 4-bit two's complement.
    """
    u = data.view(torch.uint8).to(torch.int32)
    lo = u & 0xF
    hi = (u >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    q = torch.stack([lo, hi], dim=-1).reshape(*data.shape[:-1],
                                              data.shape[-1] * 2)
    return (q.float() * scale[:, None, :]).to(dtype)


def kv_dequant_scatter_ref(data: torch.Tensor, scale: torch.Tensor,
                           slab: torch.Tensor, slots: torch.Tensor,
                           codec: str) -> None:
    """Dequantize the plane-major (planes·n, c, dp) payload in the slab's
    dtype, lay it out (n, planes, c, Hkv, hd) and write it into
    ``slab[slots]`` in place."""
    S, planes, c, hkv, hd = slab.shape
    n = len(slots)
    fn = dequant_int4_ref if codec == "int4" else dequant_int8_ref
    out = fn(data, scale, slab.dtype)
    slab[slots.to(slab.device)] = out.reshape(planes, n, c, hkv,
                                              hd).transpose(0, 1)
