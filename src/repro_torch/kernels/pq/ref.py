"""Plain PyTorch versions of the PQ k-means kernels (B4 assign, B5 update).

The arithmetic order is fixed so the CUDA kernel can repeat it bitwise:
``|c_k|^2`` and ``x . c_k`` are sequential sums over the dsub lanes, one
tensor op per product and per add (eager PyTorch never contracts them
into fused multiply-adds), then ``d = |c_k|^2 - 2 x . c_k`` and the first
minimal index.  Both work over row tiles so the (m, tile, K) temporaries
stay small at a full layer's N."""

from __future__ import annotations

from typing import Tuple

import torch

TILE_ROWS = 8192


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
    f32.  The one-hot product per row tile, added over tiles in order; an
    out-of-range code (the padding sentinel K) matches no centroid and adds
    nothing."""
    x = x.float()
    m, N, dsub = x.shape
    ks = torch.arange(n_centroids, device=x.device)
    sums = torch.zeros((m, n_centroids, dsub), dtype=torch.float32,
                       device=x.device)
    counts = torch.zeros((m, n_centroids), dtype=torch.float32,
                         device=x.device)
    for s in range(0, N, TILE_ROWS):
        onehot = (codes[:, s:s + TILE_ROWS, None].long() == ks).float()
        sums = sums + torch.bmm(onehot.transpose(1, 2), x[:, s:s + TILE_ROWS])
        counts = counts + onehot.sum(1)
    return sums, counts
