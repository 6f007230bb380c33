"""Chunk importance bounds from KV abstracts (paper §4.2–4.3).

For a chunk whose keys lie in the box [kmin, kmax] the dot product q·k is
bounded by ub = Σ_d max(q_d·kmax_d, q_d·kmin_d) = q⁺·kmax + q⁻·kmin (and
lb symmetrically); GQA sums the bound over the q heads of a kv group.  The
engine's evaluate stage calls :func:`chunk_bounds_gqa_matmul`, which runs
kernel B1 (``repro_torch.kernels.chunk_bounds``) on a CUDA tensor.
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
