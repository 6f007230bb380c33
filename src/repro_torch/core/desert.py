"""Attention-desert statistics and the Eq.(2) chunk-size policy (paper §3.5,
§4.2 "Dynamic chunk resizing").

``A(m) = m · Σ_{i=0}^{log2(n/m)-1} (2ρ)^i`` is the expected number of chunk
evaluations when the tree splits with probability ρ (the layer's
important-token density) at each level.  The optimal initial chunk count m*
minimizes A — dense layers (early layers / early decode steps, Insight 2)
get finer initial chunks; sparse layers get coarse ones.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def eval_cost(n: int, m: int, rho: float) -> float:
    """A(m) from Eq.(2); n tokens, m initial chunks, density rho."""
    if m >= n:
        return float(n)
    levels = int(math.log2(n // m)) if n % m == 0 else int(math.log2(n / m))
    x = 2.0 * rho
    if abs(x - 1.0) < 1e-9:
        s = levels
    else:
        s = (x ** levels - 1.0) / (x - 1.0)
    return m * max(s, 1.0)


def optimal_chunk_count(n: int, rho: float, *, floor: int = 8,
                        cap: int = 512,
                        candidates: Optional[Sequence[int]] = None) -> int:
    """argmin_m A(m) over power-of-two chunk counts (Eq. 3 extremum).

    When 2ρ >= 1 the geometric series diverges — every split at least
    doubles the work, so descending never pays and the optimum is the
    finest practical granularity (the paper's Insight-2 conclusion: early
    dense layers get initial chunk size 8 instead of 64).
    """
    if 2.0 * rho >= 1.0:
        return max(1, n // floor)
    if candidates is None:
        candidates = [m for m in (1 << i for i in range(
            0, int(math.log2(max(n, 2))) + 1))
            if floor <= n // m <= cap]
        candidates = candidates or [max(1, n // cap)]
    costs = [eval_cost(n, m, rho) for m in candidates]
    return int(candidates[int(np.argmin(costs))])


def optimal_chunk_size(n: int, rho: float, *, floor: int = 8,
                       cap: int = 512) -> int:
    m = optimal_chunk_count(n, rho, floor=floor, cap=cap)
    size = max(1, n // m)
    # clamp to practical sizes (transfer granularity / MXU alignment)
    size = max(floor, min(cap, size))
    # round to power of two
    return 1 << int(round(math.log2(size)))


def desert_rate(importance: np.ndarray, chunk: int, rate: float = 0.10) -> float:
    """Fraction of chunks containing no top-``rate`` token (paper Fig. 7)."""
    n = len(importance)
    k = max(1, int(n * rate))
    top = set(np.argsort(-importance)[:k].tolist())
    n_chunks = math.ceil(n / chunk)
    deserts = 0
    for c in range(n_chunks):
        if not any(t in top for t in range(c * chunk, min((c + 1) * chunk, n))):
            deserts += 1
    return deserts / n_chunks


def layer_density_schedule(n_layers: int, *, early_layers: int = 2,
                           early_rho: float = 0.5, late_rho: float = 0.1
                           ) -> np.ndarray:
    """Offline ρ(l) prior per the paper's Insight 2 (first layers are dense)."""
    rho = np.full(n_layers, late_rho)
    rho[:early_layers] = early_rho
    return rho


def chunk_size_schedule(n: int, n_layers: int, *, early_layers: int = 2,
                        early_rho: float = 0.5, late_rho: float = 0.1,
                        floor: int = 8, cap: int = 512) -> np.ndarray:
    rhos = layer_density_schedule(n_layers, early_layers=early_layers,
                                  early_rho=early_rho, late_rho=late_rho)
    return np.array([optimal_chunk_size(n, r, floor=floor, cap=cap)
                     for r in rhos])
