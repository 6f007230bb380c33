"""Chunk importance bounds from KV abstracts (paper §4.2–4.3).

For a chunk whose keys lie in the box [kmin, kmax] the dot product q·k is
bounded by ub = Σ_d max(q_d·kmax_d, q_d·kmin_d) = q⁺·kmax + q⁻·kmin (and
lb symmetrically); GQA sums the bound over the q heads of a kv group.  The
engine's evaluate stage calls :func:`chunk_bounds_gqa_matmul`, which runs
kernel B1 (``repro_torch.kernels.chunk_bounds``) on a CUDA tensor.

MLA bounds live in latent space: with W_UK absorbed into the query, q_lat
against the ``ckv`` box plus q_rope against the ``krope`` box is exactly
the bound of concat(q_lat, q_rope) against the concatenated latent box, one
logical kv head.  The engine runs that on kernel B1's latent variant
(``kernels.chunk_bounds.ops.chunk_bounds_latent``); :func:`chunk_bounds_mla`
is the reference's split form, kept as the plain check.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.chunk_bounds.ops import chunk_bounds_gqa


def chunk_bounds_gqa_matmul(q: torch.Tensor, kmax: torch.Tensor,
                            kmin: torch.Tensor, *, impl: Optional[str] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, hd) scaled query; kmax/kmin: (B, nc, Hkv, hd) f32.
    Returns (ub, lb): (B, Hkv, nc) f32, group-summed."""
    return chunk_bounds_gqa(q, kmax, kmin, impl=impl)


def chunk_bounds_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     cmax: torch.Tensor, cmin: torch.Tensor,
                     rmax: torch.Tensor, rmin: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's split MLA bound.  q_lat: (B, H, r); q_rope: (B, H,
    rope); cmax/cmin: (B, nc, r) latent boxes; rmax/rmin: (B, nc, rope)
    rope-key boxes.  Returns (ub, lb): (B, nc) f32 summed over heads."""
    def part(qq, hi_box, lo_box):
        qq = qq.float()
        qp, qn = torch.clamp(qq, min=0.0), torch.clamp(qq, max=0.0)
        hi_box, lo_box = hi_box.float(), lo_box.float()
        ub = (torch.einsum("bhr,bcr->bhc", qp, hi_box)
              + torch.einsum("bhr,bcr->bhc", qn, lo_box))
        lb = (torch.einsum("bhr,bcr->bhc", qp, lo_box)
              + torch.einsum("bhr,bcr->bhc", qn, hi_box))
        return ub, lb
    ub_c, lb_c = part(q_lat, cmax, cmin)
    ub_r, lb_r = part(q_rope, rmax, rmin)
    return (ub_c + ub_r).sum(dim=1), (lb_c + lb_r).sum(dim=1)
