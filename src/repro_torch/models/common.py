"""Shared model building blocks (norms, rotary embeddings, activations),
ported from ``repro.models.common`` with the same f32 compute points."""

from __future__ import annotations

from typing import Optional, Tuple

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


def mrope_sections(hd: int) -> Tuple[int, int, int]:
    """Qwen2-VL M-RoPE: (temporal, height, width) sections of hd/2."""
    half = hd // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float
                ) -> torch.Tensor:
    """M-RoPE.  x: (B, S, H, hd); pos3: (3, B, S) (t/h/w position ids).
    Each rotary frequency takes its angle from the stream of its section
    (:func:`mrope_sections`); the pairing is NeoX's, as in
    :func:`apply_rope`."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    # each frequency's stream, built on the host (no data-dependent
    # output shape, so the step also traces under FakeTensorMode)
    sec_id = torch.tensor([i for i, n in enumerate(mrope_sections(hd))
                           for _ in range(n)], device=x.device)
    pos = pos3.to(x.device)[sec_id]                          # (hd/2, B, S)
    angles = pos.movedim(0, -1).float() * freqs              # (B, S, hd/2)
    cos = torch.cos(angles)[..., None, :]
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
        return apply_mrope(x, pos, cfg.rope_theta)
    return apply_rope(x, pos, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  z_weight: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """Mean token cross-entropy in f32; targets == -1 are ignored.

    The gold logit is a masked reduction (iota-compare + sum) as in the
    reference, not a gather: its backward is an elementwise product, so it
    adds in a fixed order on the card, where a gather's backward scatters
    with atomics.  Returns (loss, {"nll", "tokens", "accuracy"})."""
    logits = logits.float()
    mask = (targets >= 0) if valid is None else valid & (targets >= 0)
    safe_t = targets.clamp(min=0)
    lse = torch.logsumexp(logits, dim=-1)
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    onehot = vocab_iota == safe_t[..., None]
    gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    nll = (lse - gold) * mask
    denom = mask.sum().clamp(min=1)
    loss = nll.sum() / denom
    metrics = {"nll": loss, "tokens": denom}
    if z_weight:
        loss = loss + (z_weight * lse.square() * mask).sum() / denom
    acc = (logits.argmax(dim=-1) == targets) & mask
    metrics["accuracy"] = acc.sum() / denom
    return loss, metrics
