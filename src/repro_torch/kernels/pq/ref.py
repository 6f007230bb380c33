"""Plain PyTorch versions of the PQ k-means kernels (B4 assign, B5 update).

The arithmetic order is fixed so the CUDA kernels can repeat it bitwise.
Assign: ``|c_k|^2`` and ``x . c_k`` are sequential sums over the dsub
lanes, one tensor op per product and per add (eager PyTorch never
contracts them into fused multiply-adds), then ``d = |c_k|^2 - 2 x . c_k``
and the first minimal index, over row tiles so the (m, tile, K)
temporaries stay small at a full layer's N.  Update: B5's summation order
(runs of rows, folded by block, then over blocks), see
:func:`pq_update_ref`."""

from __future__ import annotations

from typing import Tuple

import torch

TILE_ROWS = 8192
# B5's order (csrc/pq_kmeans.cu kUpdateRunRows, kUpdateWarps): rows are
# summed in runs of UPDATE_RUN_ROWS, UPDATE_WARPS runs to a block
UPDATE_RUN_ROWS = 1024
UPDATE_WARPS = 4


def centroid_norms(cb: torch.Tensor) -> torch.Tensor:
    """cb: (m, K, dsub) f32 -> (m, K): c_0*c_0 + c_1*c_1 + ..., in lane
    order."""
    cn = cb[..., 0] * cb[..., 0]
    for lane in range(1, cb.shape[-1]):
        cn = cn + cb[..., lane] * cb[..., lane]
    return cn


def pq_assign_ref(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """x: (m, N, dsub); cb: (m, K, dsub) -> codes (m, N) int32, the first
    index of the least ``|c_k|^2 - 2 x . c_k``."""
    x = x.float()
    cb = cb.float()
    m, N, dsub = x.shape
    cn = centroid_norms(cb)[:, None, :]                    # (m, 1, K)
    codes = torch.empty((m, N), dtype=torch.int32, device=x.device)
    for s in range(0, N, TILE_ROWS):
        xt = x[:, s:s + TILE_ROWS]
        dot = xt[:, :, None, 0] * cb[:, None, :, 0]        # (m, T, K)
        for lane in range(1, dsub):
            dot = dot + xt[:, :, None, lane] * cb[:, None, :, lane]
        d = cn - 2.0 * dot
        codes[:, s:s + TILE_ROWS] = torch.argmin(d, dim=-1).to(torch.int32)
    return codes


def pq_update_ref(x: torch.Tensor, codes: torch.Tensor, n_centroids: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (m, N, dsub); codes: (m, N) -> (sums (m, K, dsub), counts (m, K))
    f32.  A code outside [0, K) (the padding sentinel K) adds nothing.

    The sums follow B5's order exactly: the rows of a subspace fall into
    runs of UPDATE_RUN_ROWS consecutive rows, each summed in row order
    from +0.0; the runs fall into blocks of UPDATE_WARPS runs, each folded
    left in order from +0.0; the blocks of a subspace are folded left in
    order from +0.0.  Vectorised over (subspace, run): step s adds row s
    of every run by index assignment (no index repeats within a step), so
    the loop runs min(UPDATE_RUN_ROWS, N) times, never over N.  Counts are
    integers."""
    x = x.float()
    m, N, dsub = x.shape
    K = int(n_centroids)
    dev = x.device
    S, W = UPDATE_RUN_ROWS, UPDATE_WARPS
    T = -(-N // (S * W))                  # blocks of a subspace
    R = T * W                             # runs, the empty tail ones too
    codes = codes.long()
    ok = (codes >= 0) & (codes < K)
    counts = torch.bincount(
        (codes + (K + 1) * torch.arange(m, device=dev)[:, None])
        .masked_fill(~ok, K).reshape(-1), minlength=m * (K + 1))
    counts = counts.reshape(m, K + 1)[:, :K].float()
    # bucket K of every (subspace, run) takes the rows that add nothing
    pad = R * S - N
    xr = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(m * R, S, dsub)
    cr = torch.nn.functional.pad(torch.where(ok, codes, K), (0, pad),
                                 value=K).reshape(m * R, S)
    idx = cr + (K + 1) * torch.arange(m * R, device=dev)[:, None]
    acc = torch.zeros((m * R * (K + 1), dsub), dtype=torch.float32,
                      device=dev)
    for s in range(min(S, N)):
        i = idx[:, s]
        acc[i] = acc[i] + xr[:, s]
    runs = acc.reshape(m, T, W, K + 1, dsub)[:, :, :, :K]
    part = torch.zeros((m, T, K, dsub), dtype=torch.float32, device=dev)
    for w in range(W):
        part = part + runs[:, :, w]
    sums = torch.zeros((m, K, dsub), dtype=torch.float32, device=dev)
    for t in range(T):
        sums = sums + part[:, t]
    return sums, counts


# B4's screen: the constants of csrc/pq_kmeans.cu (kEpsC1, kEpsC2,
# kEpsDelta, kEpsFull) and their derivation there.  A row's screened
# distances are within eps = EPS_C1 |x|_2 max_k |c_k|_2 + EPS_C2 max_k
# |cn_k| + EPS_DELTA of the exact ones.
EPS_C1 = 4.0e-3
EPS_C2 = 2.0 ** -17
EPS_DELTA = 1.0e-30
EPS_FULL = 1.0e30


def tf32_round(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """f32 values with their mantissa cut to TF32's 10 bits, by masking:
    ``"trunc"`` drops the low 13 bits, ``"nearest"`` rounds half away from
    zero first (PTX ``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000
    elif rounding != "trunc":
        raise ValueError(f"rounding must be 'trunc' or 'nearest': {rounding}")
    return (bits & ~0x1FFF).view(torch.float32)


def _round_up_f32(v: torch.Tensor) -> torch.Tensor:
    """f64 -> the least f32 >= v."""
    f = v.float()
    return torch.where(f.double() < v, torch.nextafter(
        f, torch.full_like(f, float("inf"))), f)


def screened_distances(x: torch.Tensor, cb: torch.Tensor, rounding: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, N, K) distances: the exact chain of :func:`pq_assign_ref`, and
    the screen's ``d~ = -2 acc`` with acc the sum of the TF32 products and
    ``-cn / 2`` (the kernel's C input), here summed in f64 and rounded to
    f32 once — one of the orders the kernel's bound admits."""
    x = x.float()
    cb = cb.float()
    cn = centroid_norms(cb)                                  # (m, K)
    dot = x[:, :, None, 0] * cb[:, None, :, 0]
    for lane in range(1, x.shape[-1]):
        dot = dot + x[:, :, None, lane] * cb[:, None, :, lane]
    d = cn[:, None, :] - 2.0 * dot
    acc = (torch.einsum("mnl,mkl->mnk", tf32_round(x, rounding).double(),
                        tf32_round(cb, rounding).double())
           - 0.5 * cn.double()[:, None, :]).float()
    return d, -2.0 * acc


def screen_eps(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(m, N) f32 eps of each row, rounded up as the kernel rounds it."""
    x = x.float()
    cb = cb.float()
    xn = x.double().pow(2).sum(-1).sqrt()                    # (m, N)
    cmax = cb.double().pow(2).sum(-1).sqrt().amax(-1)        # (m,)
    cnmax = centroid_norms(cb).double().abs().amax(-1)
    return _round_up_f32(EPS_C1 * xn * cmax[:, None]
                         + EPS_C2 * cnmax[:, None] + EPS_DELTA)


def pq_assign_screened_ref(x: torch.Tensor, cb: torch.Tensor, *,
                           rounding: str = "nearest",
                           eps_scale: float = 1.0):
    """The CUDA kernel's screen in plain PyTorch (used by the tests): the
    screened distances of :func:`screened_distances`, the candidates
    ``d~ <= d~_min + 2 eps`` (every centroid where eps exceeds
    ``EPS_FULL`` or is NaN), and the first index of the least exact
    distance among them.  ``eps_scale`` scales eps, so a test can show
    that a smaller one gets codes wrong.  Returns (codes (m, N) int32,
    mean candidates per row)."""
    m, N, _ = x.shape
    d, dt = screened_distances(x, cb, rounding)
    eps = screen_eps(x, cb)
    full = ~(eps <= EPS_FULL)
    thr = dt.amin(-1).double() + 2.0 * eps_scale * eps.double()
    cand = (dt.double() <= thr[..., None]) | full[..., None]
    inf = torch.full_like(d, float("inf"))
    codes = torch.argmin(torch.where(cand, d, inf), dim=-1).to(torch.int32)
    return codes, cand.sum().item() / max(1, m * N)
