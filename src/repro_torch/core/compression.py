"""KV transit compression (paper §4.4 "Dynamic KV compression"), numpy.

Symmetric per-(group, channel) int8 and int4 quantization; int4 packs two
nibbles per byte (``lo | hi << 4``, lo in the even channel).  The host side
of the transit codec: the tier store packs chunks here and the device
unpacks them with ``repro_torch.kernels.kv_quant``; the packed disk
sidecar is read back through :func:`dequantize_chunks` on the host.
Results are bitwise equal to ``repro.core.compression`` (round half to
even, the same f32 division and product, the same packing — tested).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class QuantizedKV(NamedTuple):
    data: np.ndarray      # int8 payload (packed for int4)
    scale: np.ndarray     # f32 per-(group, channel) scales
    codec: str            # "int8" | "int4"
    shape: Tuple[int, ...]  # original shape

    @property
    def nbytes(self) -> int:
        return int(self.data.size) + int(self.scale.size) * 4


def _group_reshape(x: np.ndarray, group: int) -> np.ndarray:
    """(..., S, d) -> (..., S//group, group, d)."""
    *lead, S, d = x.shape
    assert S % group == 0, (S, group)
    return x.reshape(*lead, S // group, group, d)


def quantize(x: np.ndarray, codec: str = "int4", group: int = 64
             ) -> QuantizedKV:
    orig_shape = tuple(x.shape)
    g = _group_reshape(np.asarray(x, np.float32), group)
    amax = np.max(np.abs(g), axis=-2, keepdims=True)          # per channel
    qmax = np.float32(127.0 if codec == "int8" else 7.0)
    scale = np.where(amax > 0, amax / qmax, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(g / scale), -qmax, qmax).astype(np.int8)
    q = q.reshape(orig_shape)
    scale = scale[..., 0, :]                                  # (..., S/g, d)
    if codec == "int4":
        # pack along the channel dim: two nibbles per byte
        *lead, S, d = orig_shape
        assert d % 2 == 0
        u = q.reshape(*lead, S, d // 2, 2).view(np.uint8)
        q = ((u[..., 0] & 0xF) | ((u[..., 1] & 0xF) << 4)).view(np.int8)
    return QuantizedKV(q, scale, codec, orig_shape)


def dequantize(qkv: QuantizedKV, group: int = 64,
               dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize`: payload x per-(group, channel) scale in
    f32, then one rounding to ``dtype`` (numpy has no bfloat16, so the
    default is f32 where the reference's is bf16)."""
    q = np.asarray(qkv.data)
    if qkv.codec == "int4":
        u = q.view(np.uint8)
        lo = (u & 0xF).astype(np.int8)
        hi = ((u >> 4) & 0xF).astype(np.int8)
        # sign-extend 4-bit two's complement
        lo = np.where(lo > 7, lo - 16, lo).astype(np.int8)
        hi = np.where(hi > 7, hi - 16, hi).astype(np.int8)
        q = np.stack([lo, hi], axis=-1).reshape(qkv.shape)
    g = _group_reshape(q.astype(np.float32), group)
    out = g * np.asarray(qkv.scale, np.float32)[..., None, :]
    return out.reshape(qkv.shape).astype(dtype)


def packed_dim(codec: str, d: int) -> int:
    """Payload channel width of :func:`quantize_chunks` for ``d`` fp16
    channels: int4 packs two nibbles per byte along the channel dim."""
    if codec == "int4":
        assert d % 2 == 0, d
        return d // 2
    assert codec == "int8", codec
    return d


def packed_chunk_bytes(codec: str, chunk: int, d: int) -> int:
    """Exact packed bytes of ONE (chunk, d) plane through
    :func:`quantize_chunks` (int payload + one f32 scale per channel)."""
    return chunk * packed_dim(codec, d) + 4 * d


def codec_ratio(codec: str, group: int = 64) -> float:
    """Compressed bytes / fp16 bytes (scales amortized over ``group``)."""
    payload = {"int8": 0.5, "int4": 0.25}[codec]
    scale_overhead = 4.0 / (group * 2.0)   # f32 scale per group fp16 values
    return payload + scale_overhead


def quantize_chunks(k: np.ndarray, codec: str = "int4"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Transit-pack a stack of KV chunks: (n, c, H, hd) -> packed payload.

    Groups along the whole chunk (one scale per channel per chunk).
    Returns (data, scale): data (n, c, H*hd) int8 for int8 or
    (n, c, H*hd//2) packed int8 for int4; scale (n, H*hd) f32 — the layout
    ``repro_torch.kernels.kv_quant`` dequantizes on the device.
    """
    n, c, H, hd = k.shape
    d = H * hd
    q = quantize(k.reshape(n, c, d), codec, group=c)
    return q.data, q.scale.reshape(n, d)


def dequantize_chunks(data: np.ndarray, scale: np.ndarray, codec: str,
                      kv_heads: int, head_dim: int, dtype=np.float16
                      ) -> np.ndarray:
    """Host-side inverse of :func:`quantize_chunks`: (n, c, dq) payload and
    (n, d) scales -> (n, c, kv_heads, head_dim) in ``dtype``."""
    n, c = data.shape[:2]
    d = kv_heads * head_dim
    q = QuantizedKV(data, np.asarray(scale)[:, None, :], codec, (n, c, d))
    out = dequantize(q, group=c, dtype=np.float32)
    return out.astype(dtype).reshape(n, c, kv_heads, head_dim)


def quantization_rmse(x: np.ndarray, codec: str = "int4",
                      group: int = 64) -> float:
    xq = dequantize(quantize(x, codec, group), group, np.float32)
    return float(np.sqrt(np.mean((xq - x) ** 2)))
