"""Shared model building blocks (norms, rotary embeddings, activations),
ported from ``repro.models.common`` with the same f32 compute points."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: F.relu(x).square(),
    }[name]


def scale_like(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s`` with ``s`` first rounded to x's dtype, as JAX multiplies
    an array by a weakly-typed Python float."""
    return x * torch.tensor(s, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """NeoX-style rotation (first half / second half pairing).
    x: (..., S, H, hd), pos: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    angles = pos.float()[..., None] * freqs                 # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positions_for(cfg, batch: int, seq: int, device=None, offset: int = 0
                  ) -> torch.Tensor:
    """Default position ids (B, S) starting at ``offset`` (a prefill chunk
    starts where the previous one ended); M-RoPE text mode repeats them
    3x."""
    pos = torch.arange(offset, offset + seq, dtype=torch.int32,
                       device=device)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.rope == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


def rotate(cfg, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet (ROADMAP A11)")
    return apply_rope(x, pos, cfg.rope_theta)
