"""Mamba (selective SSM) block — Jamba's recurrent layer, ported from
``repro.models.ssm``.

Prefill runs the selective scan over time in f32, chunk by chunk: each
chunk of the sequence builds its discretized ``(a, b·x)`` pairs
``(B, T, d_inner, d_state)``, scans them with a log-depth (Hillis–Steele)
scan in torch ops and carries the last state into the next chunk, so the
scan's memory is bounded by the chunk and not the prompt (the reference's
associative scan holds the whole ``(B, S, d_inner, d_state)`` tensor:
3.76 GB for one 3584-token prompt at Jamba's width).  Decode is the
single-step recurrence on the carried (conv window, SSM state).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

# f32 bytes of one chunk's (a, b·x) tensor: the chunk length follows
SCAN_CHUNK_BYTES = 256 << 20


def _dims(cfg) -> Tuple[int, int, int, int]:
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_in, m.d_state, m.d_conv, dt_rank


def mamba_params(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_in, ds, dc, dtr = _dims(cfg)
    return {
        "in_proj": ParamDef((d, 2 * d_in), ("embed", "ffn")),
        "conv_w": ParamDef((dc, d_in), (None, "ffn")),
        "conv_b": ParamDef((d_in,), ("ffn",), init="zeros"),
        "x_proj": ParamDef((d_in, dtr + 2 * ds), ("ffn", None)),
        "dt_proj": ParamDef((dtr, d_in), (None, "ffn")),
        "dt_bias": ParamDef((d_in,), ("ffn",), init="zeros"),
        "a_log": ParamDef((d_in, ds), ("ffn", None), init="ones",
                          dtype="float32"),
        "d_skip": ParamDef((d_in,), ("ffn",), init="ones", dtype="float32"),
        "out_proj": ParamDef((d_in, d), ("ffn", "embed")),
    }


def mamba_cache_defs(cfg, batch: int) -> Dict[str, ParamDef]:
    d_in, ds, dc, _ = _dims(cfg)
    return {
        "conv": ParamDef((batch, dc - 1, d_in), ("batch", None, "ffn"),
                         init="zeros"),
        "state": ParamDef((batch, d_in, ds), ("batch", "ffn", None),
                          init="zeros", dtype="float32"),
    }


def _ssm_inputs(p, cfg, xc: torch.Tensor):
    """xc: post-conv activations (..., d_in) -> (dt, Bc, Cc, A)."""
    d_in, ds, _, dtr = _dims(cfg)
    proj = xc @ p["x_proj"]
    dt, Bc, Cc = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])          # (..., d_in)
    A = -torch.exp(p["a_log"].float())                         # (d_in, ds)
    return dt, Bc, Cc, A


def _scan_chunk(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                ) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` over dim 1 of
    ``a``/``b`` (B, T, d_in, ds) from ``h0`` (B, d_in, ds), by doubling:
    after the step at distance ``d`` each row holds the composition of
    its last ``2d`` updates (the reference's associative combine)."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a * h0[:, None] + b


def _conv(p, cfg, xw: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time then SiLU.  xw (B, dc - 1 + S,
    d_in): the ``d_conv - 1`` pre-conv rows before the first output row
    (the conv window), then the S rows -> (B, S, d_in)."""
    dc = _dims(cfg)[2]
    S = xw.shape[1] - (dc - 1)
    xc = xw[:, 0:S] * p["conv_w"][0]
    for i in range(1, dc):
        xc = xc + xw[:, i:i + S] * p["conv_w"][i]
    return F.silu(xc + p["conv_b"])


def mamba_prefill(p, cfg, x: torch.Tensor, length: Optional[int] = None,
                  state: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The block over the prompt and the decode state it leaves.

    x: (B, S, d) -> (y (B, S, d), {"conv", "state"}): the state after
    position ``length - 1`` (all of ``S`` when None, so bucket-padding
    rows never reach it), exactly what stepping :func:`mamba_decode`
    over the first ``length`` tokens leaves.  ``state`` (a decode cache)
    is the layer's state before ``x``'s first row, zeros when None, so a
    chunk of a prompt goes on from the chunk before it.  The returned
    leaves own their memory: no view keeps the scan's chunk alive."""
    B, S, d = x.shape
    d_in, ds, dc, _ = _dims(cfg)
    n = S if length is None else int(length)
    xz = x @ p["in_proj"]
    xr, z = xz.chunk(2, dim=-1)                                # (B,S,d_in)
    if state is None:
        prev = xr.new_zeros((B, dc - 1, d_in))
        h = torch.zeros((B, d_in, ds), dtype=torch.float32, device=x.device)
    else:
        prev, h = state["conv"].to(xr.dtype), state["state"]
    xw = torch.cat([prev, xr], dim=1)                    # (B,dc-1+S,d_in)
    xc = _conv(p, cfg, xw)
    dt, Bc, Cc, A = _ssm_inputs(p, cfg, xc)
    dt32, xc32 = dt.float(), xc.float()
    T = max(1, SCAN_CHUNK_BYTES // (B * d_in * ds * 4))
    h_n = h
    ys = []
    for s0 in range(0, S, T):
        sl = slice(s0, min(S, s0 + T))
        a = torch.exp(dt32[:, sl, :, None] * A)              # (B,T,d_in,ds)
        bx = (dt32[:, sl] * xc32[:, sl])[..., None] \
            * Bc[:, sl].float()[:, :, None, :]
        hs = _scan_chunk(a, bx, h)
        ys.append(torch.einsum("bsdz,bsz->bsd", hs, Cc[:, sl].float()))
        if s0 <= n - 1 < sl.stop:
            h_n = hs[:, n - 1 - s0].clone()
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + xc32 * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    # the conv window: the last d_conv - 1 pre-conv rows before `length`
    conv = xw[:, n:n + dc - 1].clone()
    return y @ p["out_proj"], {"conv": conv, "state": h_n}


def mamba_train(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the forward over the whole sequence."""
    return mamba_prefill(p, cfg, x)[0]


def mamba_decode(p, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step.  x: (B, 1, d); cache: {"conv", "state"}.
    Returns (out (B, 1, d), the new cache); ``cache`` is not written."""
    xz = (x @ p["in_proj"])[:, 0]
    xr, z = xz.chunk(2, dim=-1)                                # (B,d_in)
    window = torch.cat([cache["conv"], xr[:, None]], dim=1)    # (B,dc,d_in)
    xc = F.silu(torch.einsum("bcd,cd->bd", window, p["conv_w"])
                + p["conv_b"])
    dt, Bc, Cc, A = _ssm_inputs(p, cfg, xc)
    dt32 = dt.float()
    a = torch.exp(dt32[..., None] * A)                         # (B,d_in,ds)
    bx = (dt32 * xc.float())[..., None] * Bc.float()[:, None, :]
    h = cache["state"] * a + bx
    y = torch.einsum("bdz,bz->bd", h, Cc.float())
    y = y + xc.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv": window[:, 1:], "state": h}
