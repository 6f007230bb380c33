"""Three-tier KV placement planning + LKA accounting (paper §4.1, §4.3).

The planner decides, per layer, what fraction of KV lives on each tier
(GPU-resident working set / CPU / disk) subject to capacities, implementing
the paper's placement rules:

* the first ``early_layers`` layers never go to disk (their attention is
  dense — §4.3 "KV Management and optimization under LKA");
* a token access-frequency table keeps hot tokens off the disk tier;
* the disk keeps full replicas, so CPU→disk eviction costs no write I/O;
* KV abstracts (2 key vectors per chunk) are stored next to the data.

``lka_transfer_ratio`` is the paper's r = α + 2/n' (Fig. 11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TierSpec:
    gpu_bytes: float
    cpu_bytes: float
    disk_bytes: float = float("inf")


@dataclass
class LayerPlacement:
    gpu_frac: float
    cpu_frac: float
    disk_frac: float

    def __post_init__(self):
        s = self.gpu_frac + self.cpu_frac + self.disk_frac
        assert abs(s - 1.0) < 1e-6, s


def lka_transfer_ratio(alpha: float, chunk: int) -> float:
    """r = α + 2/n' — fraction of disk KV bytes moved per evaluation+fetch."""
    return alpha + 2.0 / chunk


def plan_placement(kv_bytes_per_layer: float, n_layers: int, spec: TierSpec, *,
                   early_layers: int = 2, importance_rate: float = 0.1,
                   hot_frac: float = 0.05) -> List[LayerPlacement]:
    """Greedy capacity-aware placement.

    GPU gets each layer's working set (importance_rate + hot tokens), early
    layers are pinned to GPU/CPU only; remaining bytes spill to CPU then disk.
    """
    placements: List[LayerPlacement] = []
    gpu_left, cpu_left = spec.gpu_bytes, spec.cpu_bytes
    for layer in range(n_layers):
        want_gpu = kv_bytes_per_layer * min(1.0, importance_rate + hot_frac)
        g = min(want_gpu, max(gpu_left, 0.0))
        gpu_left -= g
        rest = kv_bytes_per_layer - g
        if layer < early_layers:
            c = min(rest, max(cpu_left, 0.0))
            cpu_left -= c
            d = rest - c
            if d > 1e-9:  # overflow of a pinned layer: spill to CPU anyway
                c += d
                d = 0.0
        else:
            c = min(rest, max(cpu_left, 0.0))
            cpu_left -= c
            d = rest - c
        placements.append(LayerPlacement(g / kv_bytes_per_layer,
                                         c / kv_bytes_per_layer,
                                         d / kv_bytes_per_layer))
    return placements


@dataclass
class AccessTable:
    """Token access-frequency table (EMA) for hot-token pinning (§4.3)."""

    n_tokens: int
    decay: float = 0.9
    counts: np.ndarray = field(init=False)

    def __post_init__(self):
        self.counts = np.zeros(self.n_tokens, dtype=np.float64)

    def record(self, token_ids: np.ndarray) -> None:
        self.counts *= self.decay
        np.add.at(self.counts, np.asarray(token_ids, dtype=np.int64), 1.0)

    def grow(self, n: int) -> None:
        if n > self.n_tokens:
            self.counts = np.concatenate(
                [self.counts, np.zeros(n - self.n_tokens)])
            self.n_tokens = n

    def hot_tokens(self, frac: float) -> np.ndarray:
        k = max(1, int(self.n_tokens * frac))
        return np.argsort(-self.counts)[:k]

    def hot_mask(self, frac: float) -> np.ndarray:
        mask = np.zeros(self.n_tokens, dtype=bool)
        mask[self.hot_tokens(frac)] = True
        return mask


def kv_bytes(seq: int, n_kv_heads: int, head_dim: int, *,
             dtype_bytes: int = 2, factor: int = 2) -> float:
    """Bytes of one layer's KV cache for one sequence (K and V)."""
    return float(factor * seq * n_kv_heads * head_dim * dtype_bytes)


def abstract_overhead(chunk: int) -> float:
    """Extra storage fraction from abstracts: 2 key vectors per chunk on K+V
    (paper §6.5: <1.6% at chunk=64 — 2/(2·64) = 1.56%)."""
    return 2.0 / (2.0 * chunk)


def shared_prefix_savings(hit_chunks: int, n_layers: int, chunk_bytes: float,
                          abstract_bytes: float) -> float:
    """Tier bytes a warm-prefix admission does NOT write or duplicate:
    per adopted chunk, every layer skips its disk replica AND its LKA
    abstract (both computed once by the registrant and shared by
    reference).  The store accumulates this into ``bytes_deduped``."""
    return float(hit_chunks) * n_layers * (chunk_bytes + abstract_bytes)
