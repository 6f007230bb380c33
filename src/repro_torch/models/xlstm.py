"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
[arXiv:2405.04517], ported from ``repro.models.xlstm``.

Both run the exact stabilized recurrences step by step over time, as the
reference's ``lax.scan`` does: the projections of every token are one
batched product, the recurrence a loop of torch ops in f32.  Decode
carries the fixed-size state; these stacks have no KV cache, so LeoAM does
not apply to them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg) -> Tuple[int, int]:
    d_in = 2 * cfg.d_model
    return d_in, d_in // cfg.n_heads


def mlstm_params(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_in, _ = _mlstm_dims(cfg)
    H = cfg.n_heads
    return {
        "in_proj": ParamDef((d, 2 * d_in), ("embed", "ffn")),
        "wq": ParamDef((d_in, d_in), ("ffn", None)),
        "wk": ParamDef((d_in, d_in), ("ffn", None)),
        "wv": ParamDef((d_in, d_in), ("ffn", None)),
        "w_if": ParamDef((d_in, 2 * H), ("ffn", None)),   # input+forget gates
        "b_if": ParamDef((2 * H,), (None,), init="zeros"),
        "out_proj": ParamDef((d_in, d), ("ffn", "embed")),
    }


def mlstm_cache_defs(cfg, batch: int) -> Dict[str, ParamDef]:
    _, dh = _mlstm_dims(cfg)
    H = cfg.n_heads
    return {
        "C": ParamDef((batch, H, dh, dh), ("batch", "kv", None, None),
                      init="zeros", dtype="float32"),
        "n": ParamDef((batch, H, dh), ("batch", "kv", None),
                      init="zeros", dtype="float32"),
        "m": ParamDef((batch, H), ("batch", "kv"), init="zeros",
                      dtype="float32"),
    }


def _mlstm_qkvg(p, cfg, x: torch.Tensor):
    """x: (..., d) -> q, k, v (..., H, dh), gates (..., H), z (..., d_in)."""
    _, dh = _mlstm_dims(cfg)
    H = cfg.n_heads
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    lead = xi.shape[:-1]
    q = (xi @ p["wq"]).reshape(*lead, H, dh)
    k = (xi @ p["wk"]).reshape(*lead, H, dh)
    # the reference divides by jnp.sqrt(dh): a weakly-typed f32 scalar
    k = k / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(k.dtype)
    v = (xi @ p["wv"]).reshape(*lead, H, dh)
    gates = (xi @ p["w_if"] + p["b_if"]).float()
    i_raw, f_raw = gates.chunk(2, dim=-1)                       # (..., H)
    return q, k, v, i_raw, f_raw, z


def _mlstm_step(carry, qkvif):
    """Stabilized mLSTM recurrence (paper eq. 19-27)."""
    C, n, m = carry
    q, k, v, i_raw, f_raw = qkvif
    logf = F.logsigmoid(f_raw)                                  # (B,H)
    m_new = torch.maximum(logf + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(logf + m - m_new)
    k32, v32, q32 = k.float(), v.float(), q.float()
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        k32[..., :, None] * v32[..., None, :])                  # (B,H,dk,dv)
    n = f_g[..., None] * n + i_g[..., None] * k32
    num = torch.einsum("bhkv,bhk->bhv", C, q32)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, q32).abs(), min=1.0)
    h = num / den[..., None]
    return (C, n, m_new), h


def mlstm_prefill(p, cfg, x: torch.Tensor, length: Optional[int] = None,
                  state: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y (B, S, d), the decode state after position
    ``length - 1``; all ``S`` when None).  ``state`` (a decode cache) is
    the state before ``x``'s first row, zeros when None."""
    B, S, _ = x.shape
    d_in, dh = _mlstm_dims(cfg)
    H = cfg.n_heads
    n_keep = S if length is None else int(length)
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(p, cfg, x)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        carry = (torch.zeros((B, H, dh, dh), **f32),
                 torch.zeros((B, H, dh), **f32), torch.zeros((B, H), **f32))
    else:
        carry = (state["C"], state["n"], state["m"])
    state = carry
    hs = []
    for t in range(S):
        carry, h = _mlstm_step(carry, (q[:, t], k[:, t], v[:, t],
                                       i_raw[:, t], f_raw[:, t]))
        hs.append(h)
        if t == n_keep - 1:
            state = carry
    h = torch.stack(hs, dim=1).reshape(B, S, d_in).to(x.dtype)
    y = (h * F.silu(z)) @ p["out_proj"]
    return y, dict(zip(("C", "n", "m"), state))


def mlstm_train(p, cfg, x: torch.Tensor) -> torch.Tensor:
    return mlstm_prefill(p, cfg, x)[0]


def mlstm_decode(p, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
    """x: (B, 1, d) -> (out (B, 1, d), the new state); ``cache`` is not
    written."""
    B = x.shape[0]
    d_in, _ = _mlstm_dims(cfg)
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(p, cfg, x[:, 0])
    carry = (cache["C"], cache["n"], cache["m"])
    carry, h = _mlstm_step(carry, (q, k, v, i_raw, f_raw))
    h = h.reshape(B, d_in).to(x.dtype)
    out = ((h * F.silu(z)) @ p["out_proj"])[:, None]
    return out, dict(zip(("C", "n", "m"), carry))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_params(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    ffp = int(d * 4 / 3)
    return {
        "w_in": ParamDef((d, 4 * d), ("embed", "ffn")),          # z,i,f,o
        "r_in": ParamDef((H, dh, 4 * dh), ("kv", None, None)),   # block-diag R
        "b_in": ParamDef((4 * d,), (None,), init="zeros"),
        "ff_gate": ParamDef((d, ffp), ("embed", "ffn")),
        "ff_up": ParamDef((d, ffp), ("embed", "ffn")),
        "ff_down": ParamDef((ffp, d), ("ffn", "embed")),
    }


def slstm_cache_defs(cfg, batch: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    return {nm: ParamDef((batch, d), ("batch", None), init="zeros",
                         dtype="float32") for nm in ("h", "c", "n", "m")}


def _slstm_step(p, cfg, carry, pre_in: torch.Tensor, dtype: torch.dtype):
    """One stabilized sLSTM step (paper eq. 8-18).  ``pre_in``: the
    token's input projection ``x_t @ w_in + b_in`` (B, 4d) in f32."""
    h_prev, c_prev, n_prev, m_prev = carry
    B, d = h_prev.shape
    H = cfg.n_heads
    dh = d // H
    rec = torch.einsum("bhk,hkj->bhj", h_prev.reshape(B, H, dh).to(dtype),
                       p["r_in"])                               # (B,H,4*dh)
    # regroup per-head [z,i,f,o] blocks into gate-major (B, 4d) like w_in
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
    pre = pre_in + rec.float()
    z_r, i_r, f_r, o_r = pre.chunk(4, dim=-1)                   # (B, d)
    logf = F.logsigmoid(f_r)
    m_new = torch.maximum(logf + m_prev, i_r)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(logf + m_prev - m_new)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    c = f_g * c_prev + i_g * z
    n = f_g * n_prev + i_g
    h = o * c / torch.clamp(n, min=1.0)
    return (h, c, n, m_new), h


def _slstm_out(p, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    g = F.gelu((x + h) @ p["ff_gate"], approximate="tanh")
    return (g * ((x + h) @ p["ff_up"])) @ p["ff_down"] + h


def slstm_prefill(p, cfg, x: torch.Tensor, length: Optional[int] = None,
                  state: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y (B, S, d), the decode state after position
    ``length - 1``; all ``S`` when None).  ``state`` (a decode cache) is
    the state before ``x``'s first row, zeros when None."""
    B, S, d = x.shape
    n_keep = S if length is None else int(length)
    pre_in = (x @ p["w_in"] + p["b_in"]).float()               # (B, S, 4d)
    carry = tuple(torch.zeros((B, d), dtype=torch.float32, device=x.device)
                  for _ in range(4)) if state is None else \
        tuple(state[nm] for nm in ("h", "c", "n", "m"))
    state = carry
    hs = []
    for t in range(S):
        carry, h = _slstm_step(p, cfg, carry, pre_in[:, t], x.dtype)
        hs.append(h)
        if t == n_keep - 1:
            state = carry
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_out(p, x, h), dict(zip(("h", "c", "n", "m"), state))


def slstm_train(p, cfg, x: torch.Tensor) -> torch.Tensor:
    return slstm_prefill(p, cfg, x)[0]


def slstm_decode(p, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
    """x: (B, 1, d) -> (out (B, 1, d), the new state); ``cache`` is not
    written."""
    carry = (cache["h"], cache["c"], cache["n"], cache["m"])
    pre_in = (x[:, 0] @ p["w_in"] + p["b_in"]).float()
    carry, h = _slstm_step(p, cfg, carry, pre_in, x.dtype)
    out = _slstm_out(p, x, h[:, None].to(x.dtype))
    return out, dict(zip(("h", "c", "n", "m"), carry))
