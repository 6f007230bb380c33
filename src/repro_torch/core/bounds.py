"""Chunk importance bounds from KV abstracts (paper §4.2–4.3).

For a chunk whose keys lie in the box [kmin, kmax] the dot product q·k is
bounded by ub = Σ_d max(q_d·kmax_d, q_d·kmin_d) = q⁺·kmax + q⁻·kmin (and
lb symmetrically); GQA sums the bound over the q heads of a kv group.
:func:`chunk_bounds_gqa` is the per-coordinate (corner) form, the plain
check of the matmul form :func:`chunk_bounds_gqa_matmul`, which the
engine's evaluate stage and ``lm.decode_step``'s pyramid descent call and
which runs kernel B1 (``repro_torch.kernels.chunk_bounds``) on a CUDA
tensor.

MLA bounds live in latent space: with W_UK absorbed into the query, q_lat
against the ``ckv`` box plus q_rope against the ``krope`` box is exactly
the bound of concat(q_lat, q_rope) against the concatenated latent box, one
logical kv head.  The engine runs that on kernel B1's latent variant
(``kernels.chunk_bounds.ops.chunk_bounds_latent``); :func:`chunk_bounds_mla`
is the reference's split form, which ``pyramid_select_mla`` runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.chunk_bounds import ops as b1


def box_bounds(q: torch.Tensor, kmax: torch.Tensor, kmin: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic box bound.  q: (..., H, hd); kmax/kmin: (..., nc, hd)
    broadcastable against q's batch dims.  Returns (ub, lb): (..., H, nc)
    f32."""
    q = q.float()
    hi = torch.einsum("...hd,...cd->...hcd", q, kmax.float())
    lo = torch.einsum("...hd,...cd->...hcd", q, kmin.float())
    return torch.maximum(hi, lo).sum(dim=-1), torch.minimum(hi, lo).sum(dim=-1)


def chunk_bounds_gqa(q: torch.Tensor, kmax: torch.Tensor, kmin: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA chunk bounds, per-coordinate form.  q: (B, H, hd) scaled and
    roped; kmax/kmin: (B, nc, Hkv, hd).  Returns (ub, lb): (B, Hkv, nc)
    f32, group-summed."""
    B, H, hd = q.shape
    Hkv = kmax.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd).float()
    km = kmax.transpose(1, 2).float()                   # (B, Hkv, nc, hd)
    kn = kmin.transpose(1, 2).float()
    hi = torch.einsum("bkgd,bkcd->bkgcd", qg, km)       # per coordinate
    lo = torch.einsum("bkgd,bkcd->bkgcd", qg, kn)
    return (torch.maximum(hi, lo).sum(dim=(-1, 2)),     # Σ_d then Σ_group
            torch.minimum(hi, lo).sum(dim=(-1, 2)))


def positive_negative_split(q: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q = q⁺ + q⁻: ub = q⁺·kmax + q⁻·kmin, two matmuls."""
    return torch.clamp(q, min=0.0), torch.clamp(q, max=0.0)


def chunk_bounds_gqa_matmul(q: torch.Tensor, kmax: torch.Tensor,
                            kmin: torch.Tensor, *, impl: Optional[str] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, hd) scaled query; kmax/kmin: (B, nc, Hkv, hd) f32.
    Returns (ub, lb): (B, Hkv, nc) f32, group-summed (kernel B1 on a CUDA
    tensor)."""
    return b1.chunk_bounds_gqa(q, kmax, kmin, impl=impl)


def chunk_bounds_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     cmax: torch.Tensor, cmin: torch.Tensor,
                     rmax: torch.Tensor, rmin: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's split MLA bound.  q_lat: (B, H, r); q_rope: (B, H,
    rope); cmax/cmin: (B, nc, r) latent boxes; rmax/rmin: (B, nc, rope)
    rope-key boxes.  Returns (ub, lb): (B, nc) f32 summed over heads."""
    def part(qq, hi_box, lo_box):
        qp, qn = positive_negative_split(qq.float())
        hi_box, lo_box = hi_box.float(), lo_box.float()
        ub = (torch.einsum("bhr,bcr->bhc", qp, hi_box)
              + torch.einsum("bhr,bcr->bhc", qn, lo_box))
        lb = (torch.einsum("bhr,bcr->bhc", qp, lo_box)
              + torch.einsum("bhr,bcr->bhc", qn, hi_box))
        return ub, lb
    ub_c, lb_c = part(q_lat, cmax, cmin)
    ub_r, lb_r = part(q_rope, rmax, rmin)
    return (ub_c + ub_r).sum(dim=1), (lb_c + lb_r).sum(dim=1)
