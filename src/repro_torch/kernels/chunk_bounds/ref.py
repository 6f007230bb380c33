"""Plain PyTorch versions of the chunk_bounds kernel (both layouts)."""

from __future__ import annotations

from typing import Tuple

import torch


def chunk_bounds_ref(q: torch.Tensor, kmax: torch.Tensor, kmin: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pallas contract.  q: (B, Hkv, G, hd); kmax/kmin: (B, Hkv, nc, hd).

    Returns (ub, lb): (B, Hkv, nc) f32 — group-summed box bounds:
        ub = Σ_g (q⁺·kmax + q⁻·kmin),  lb = Σ_g (q⁺·kmin + q⁻·kmax)
    """
    q = q.float()
    kmax = kmax.float()
    kmin = kmin.float()
    qp = torch.clamp(q, min=0.0)
    qn = torch.clamp(q, max=0.0)
    ub = (torch.einsum("bkgd,bkcd->bkgc", qp, kmax)
          + torch.einsum("bkgd,bkcd->bkgc", qn, kmin)).sum(dim=2)
    lb = (torch.einsum("bkgd,bkcd->bkgc", qp, kmin)
          + torch.einsum("bkgd,bkcd->bkgc", qn, kmax)).sum(dim=2)
    return ub, lb


def chunk_bounds_gqa_ref(q: torch.Tensor, kmax: torch.Tensor,
                         kmin: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Engine layout.  q: (B, H, hd); kmax/kmin: (B, nc, Hkv, hd) (the tier
    store's abstract stack) -> (ub, lb) (B, Hkv, nc) f32."""
    B, H, hd = q.shape
    Hkv = kmax.shape[2]
    return chunk_bounds_ref(q.reshape(B, Hkv, H // Hkv, hd),
                            kmax.transpose(1, 2), kmin.transpose(1, 2))
