"""IAKM — Importance-aware Adaptive KV Management (paper §4.2), host side.

The numpy selection functions of ``repro.core.adaptive``, copied so the
port never imports the JAX package:

* :func:`tree_select` — the paper's exact host-side algorithm: a max-heap of
  variable-size chunks ordered by upper bound; pop → confirm / split; desert
  runs merge into coarse chunks.  Exact top-T with provably correct
  confirmation rules; evaluation count is the paper's cost metric.
* :func:`tree_select_chunks` / :func:`flat_select_chunks` — the chunk-level
  fast paths the serving engine runs, equal to the per-token forms
  (:func:`tree_select`, :func:`flat_chunk_select`) they are tested against.

and the device-side pyramid refinement of ``lm.decode_step``'s in-model
sparse path, in torch:

* :func:`pyramid_select_gqa` / :func:`pyramid_select_mla` — the
  fixed-shape equivalent: descend the abstract pyramid coarse→fine keeping
  a bounded candidate beam per level.  Staying coarse == merge, descending
  == split.  On a CUDA tensor the GQA bounds run on kernel B1: the
  coarsest level through its strided entry on the cache's (B, nc, Hkv, hd)
  leaves, the finer levels' gathered (B, Hkv, C, hd) boxes through its
  Pallas-contract entry.  The top-k is a stable descending sort, so ties
  (forced sink/recent nodes at +inf, sentinel chunks past the length) go
  to the lower position, as ``jax.lax.top_k`` breaks them — the order of
  the ids feeds the next level's children and B2's summation order.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.abstracts import Pyramid
from repro_torch.core.bounds import chunk_bounds_gqa_matmul, chunk_bounds_mla
from repro_torch.kernels.chunk_bounds import ops as b1


# ---------------------------------------------------------------------------
# Host-side exact tree selection (paper Fig. 10)
# ---------------------------------------------------------------------------


@dataclass
class TreeSelectResult:
    selected: np.ndarray            # sorted token indices, len == budget
    evaluations: int                # chunk-bound evaluations performed
    partition: List[Tuple[int, int, bool]]  # (lo, hi, important) final chunks
    transfer_tokens: int            # tokens fetched (selected segments only)

    @property
    def transfer_ratio(self) -> float:
        """Fraction of fetched tokens that are truly wanted (paper's metric)."""
        return len(self.selected) / max(1, self.transfer_tokens)


def tree_select(scores: np.ndarray, budget: int, chunk: int,
                max_merge_span: Optional[int] = None) -> TreeSelectResult:
    """Exact top-``budget`` token selection with minimal chunk evaluations.

    ``scores`` are per-token importance values (attention-mass proxy); one
    "evaluation" computes a chunk's (ub, lb) from its abstract.  Branch and
    bound: the max-ub segment on the heap either (a) is a single token →
    confirmed, (b) has lb >= every other segment's ub → wholly confirmed
    (the paper's "at least 4 important tokens in Chunk₇¹" step), or (c) is
    split in two (two new evaluations).  Unpopped segments form the
    attention desert and are merged for the next step's partition.
    """
    n = len(scores)
    budget = min(budget, n)
    n_chunks = math.ceil(n / chunk)
    evals = 0

    # heap of (-ub, lo, hi, lb); ub/lb from the chunk "abstract"
    heap: List[Tuple[float, int, int, float]] = []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, n)
        seg = scores[lo:hi]
        evals += 1
        heapq.heappush(heap, (-float(seg.max()), lo, hi, float(seg.min())))

    selected: List[int] = []
    confirmed_segs: List[Tuple[int, int]] = []
    while len(selected) < budget and heap:
        nub, lo, hi, lb = heapq.heappop(heap)
        size = hi - lo
        remaining = budget - len(selected)
        next_ub = -heap[0][0] if heap else -np.inf
        if size == 1:
            selected.append(lo)
            confirmed_segs.append((lo, hi))
            continue
        if lb >= next_ub and size <= remaining:
            # whole segment provably in the top set
            selected.extend(range(lo, hi))
            confirmed_segs.append((lo, hi))
            continue
        mid = lo + size // 2
        for a, b in ((lo, mid), (mid, hi)):
            seg = scores[a:b]
            evals += 1
            heapq.heappush(heap, (-float(seg.max()), a, b, float(seg.min())))

    selected_arr = np.array(sorted(selected), dtype=np.int64)

    # Final partition: confirmed segments + merged desert runs.
    span_cap = max_merge_span or (chunk * 8)
    important = np.zeros(n, dtype=bool)
    important[selected_arr] = True
    partition: List[Tuple[int, int, bool]] = []
    i = 0
    while i < n:
        j = i
        flag = bool(important[i])
        cap = n if flag else min(n, i + span_cap)
        while j < cap and (j == i or important[j] == flag):
            j += 1
            if flag and j < n and not important[j]:
                break
        partition.append((i, j, flag))
        i = j
    transfer = sum(hi - lo for lo, hi, imp in partition if imp)
    return TreeSelectResult(selected_arr, evals, partition, transfer)


def tree_select_chunks(chunk_ub: np.ndarray, length: int, budget: int,
                       chunk: int) -> Tuple[List[int], int]:
    """Chunk-level fast path for :func:`tree_select` on per-chunk scores.

    Equivalent to ``tree_select(np.repeat(chunk_ub, chunk)[:length], budget,
    chunk)`` followed by ``{t // chunk for t in selected}`` — but O(n_chunks
    log n_chunks + log chunk) instead of O(length): with scores constant
    inside a chunk every segment has lb == ub, so the branch-and-bound
    confirmation rule collapses to "take the whole segment iff it fits the
    remaining budget, else split".  Heap keys match ``tree_select``'s
    ``(-ub, lo, hi, lb)`` exactly (lo breaks ties), so the selected chunk
    set AND the evaluation count are identical to the per-token path.

    Returns (sorted selected chunk ids, evaluations).
    """
    n = int(length)
    budget = min(budget, n)
    n_chunks = math.ceil(n / chunk)
    evals = n_chunks
    heap: List[Tuple[float, int, int]] = []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, n)
        heapq.heappush(heap, (-float(chunk_ub[c]), lo, hi))
    taken = 0
    sel: set = set()
    while taken < budget and heap:
        nub, lo, hi = heapq.heappop(heap)
        size = hi - lo
        # lb == ub == -nub, and the popped segment is the heap max, so the
        # per-token rule "lb >= next_ub and size <= remaining" is just the
        # size check; size == 1 is its degenerate case.
        if size <= budget - taken:
            taken += size
            sel.add(lo // chunk)
            continue
        mid = lo + size // 2
        evals += 2
        heapq.heappush(heap, (nub, lo, mid))
        heapq.heappush(heap, (nub, mid, hi))
    return sorted(sel), evals


def flat_select_chunks(chunk_ub: np.ndarray, length: int, budget: int,
                       chunk: int) -> Tuple[List[int], int]:
    """Chunk-level fast path for :func:`flat_chunk_select` on chunk scores.

    The Quest-like baseline takes chunks in score order until ``budget``
    tokens are covered; with per-token scores constant inside a chunk the
    top-``budget`` token set is exactly the tokens of that chunk prefix, so
    no per-token array is needed.  Ties across chunks follow the same
    ``np.argsort(-ubs)`` call the per-token path makes.
    """
    n = int(length)
    budget = min(budget, n)
    n_chunks = math.ceil(n / chunk)
    order = np.argsort(-np.asarray(chunk_ub[:n_chunks]))
    sel: List[int] = []
    covered = 0
    for c in order:
        if covered >= budget:
            break
        sel.append(int(c))
        covered += min(chunk, n - int(c) * chunk)
    return sorted(sel), n_chunks


def flat_chunk_select(scores: np.ndarray, budget: int, chunk: int
                      ) -> TreeSelectResult:
    """Quest-like fixed-chunk baseline: score every chunk, take top chunks."""
    n = len(scores)
    n_chunks = math.ceil(n / chunk)
    ubs = np.array([scores[c * chunk: (c + 1) * chunk].max() for c in range(n_chunks)])
    order = np.argsort(-ubs)
    picked: List[int] = []
    transfer = 0
    top_tokens = set(np.argsort(-scores)[:budget].tolist())
    chosen = []
    for c in order:
        if len(picked) >= budget:
            break
        lo, hi = c * chunk, min((c + 1) * chunk, n)
        chosen.append((lo, hi, True))
        transfer += hi - lo
        picked.extend(t for t in range(lo, hi) if t in top_tokens)
    hit = np.array(sorted(set(picked)), dtype=np.int64)
    res = TreeSelectResult(hit, n_chunks, chosen, transfer)
    return res


# ---------------------------------------------------------------------------
# Device-side pyramid refinement (fixed shapes)
# ---------------------------------------------------------------------------


def _beam_sizes(levels: int, budget: int, nc: Sequence[int], rf: int,
                forced: int) -> List[int]:
    """Candidates kept per level (index 0 = finest)."""
    out = []
    for lvl in range(levels):
        want = rf * max(1, -(-budget // (1 << lvl))) + forced
        out.append(min(nc[lvl], want))
    return out


def _top_k(ub: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` largest along the last axis, largest first,
    ties to the lower position (``jax.lax.top_k``'s order)."""
    return torch.sort(ub, dim=-1, descending=True, stable=True)[1][..., :k]


def _ub_gathered(q4: torch.Tensor, km: torch.Tensor, kn: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """ub for gathered boxes.  q4: (B, Hkv, G, hd); km/kn: (B, Hkv, C, hd)
    -> (B, Hkv, C) f32, group-summed: kernel B1's Pallas-contract entry
    (its plain version on the CPU is the reference's q⁺/q⁻ einsums)."""
    return b1.chunk_bounds(q4, km.float(), kn.float(), impl=impl)[0]


def _force_bias(ub: torch.Tensor, ids: torch.Tensor, lvl: int, nc0: int,
                sink_chunks: int, recent_chunks: int, n_valid0,
                chunk_offset: int = 0) -> torch.Tensor:
    """+inf bias for sink/recent nodes so they always survive the beam.

    ``chunk_offset`` / ``n_valid0`` are in GLOBAL base-chunk units: under
    sequence sharding only the shard that owns the global sink (or the
    tail) forces those chunks."""
    span = 1 << lvl
    gids = ids.long() * span                    # first base chunk of node
    if chunk_offset:
        gids = gids + chunk_offset              # ... in global units
    forced = torch.zeros_like(ub, dtype=torch.bool)
    if sink_chunks:
        forced = forced | (gids < sink_chunks)
    if recent_chunks:
        # the node covers [gids, gids + span): force it if it meets the tail
        forced = forced | ((gids + span) > (n_valid0 - recent_chunks))
    forced = forced & (gids < n_valid0)
    return torch.where(forced, torch.full_like(ub, float("inf")), ub)


def _take(a: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (B, Hkv, C) of a (B, Hkv, nc, hd) tensor."""
    return torch.gather(a, 2, ids.long()[..., None].expand(
        *ids.shape, a.shape[-1]))


def pyramid_select_gqa(q: torch.Tensor, pyr: Pyramid, budget: int, *,
                       rf: int = 2, sink_chunks: int = 1,
                       recent_chunks: int = 2, n_valid0=None,
                       chunk_offset: int = 0, impl: Optional[str] = None
                       ) -> torch.Tensor:
    """Select ``budget`` base chunks per (batch, kv head).

    q: (B, H, hd) scaled and roped.  Returns int32 ids (B, Hkv, budget),
    local to the pyramid.  ``n_valid0``: the GLOBAL count of base chunks
    that hold a token; ``chunk_offset``: this shard's global base-chunk
    offset (0 when unsharded)."""
    L = pyr.levels
    B, H, hd = q.shape
    Hkv = pyr.kmax[0].shape[2]
    nc = [pyr.kmax[lvl].shape[1] for lvl in range(L)]
    budget = min(budget, nc[0])
    if n_valid0 is None:
        n_valid0 = nc[0]
    beams = _beam_sizes(L, budget, nc, rf, sink_chunks + recent_chunks)
    q4 = q.reshape(B, Hkv, H // Hkv, hd)

    # coarsest level: score everything
    ub, _ = chunk_bounds_gqa_matmul(q, pyr.kmax[L - 1], pyr.kmin[L - 1],
                                    impl=impl)
    ids = torch.arange(nc[L - 1], dtype=torch.int32,
                       device=q.device).expand(ub.shape)
    ub = _force_bias(ub, ids, L - 1, nc[0], sink_chunks, recent_chunks,
                     n_valid0, chunk_offset)
    ids = torch.gather(ids, -1, _top_k(ub, beams[L - 1]))

    for lvl in range(L - 2, -1, -1):
        ids = torch.cat([ids * 2, ids * 2 + 1], dim=-1)       # children
        km = pyr.kmax[lvl].transpose(1, 2)                  # (B,Hkv,nc,hd)
        kn = pyr.kmin[lvl].transpose(1, 2)
        ub = _ub_gathered(q4, _take(km, ids), _take(kn, ids), impl=impl)
        ub = _force_bias(ub, ids, lvl, nc[0], sink_chunks, recent_chunks,
                         n_valid0, chunk_offset)
        width = beams[lvl] if lvl > 0 else budget
        ids = torch.gather(ids, -1, _top_k(ub, min(width, ids.shape[-1])))
    return ids.to(torch.int32)


def flat_select_gqa(q: torch.Tensor, kmax0: torch.Tensor,
                    kmin0: torch.Tensor, budget: int, *,
                    sink_chunks: int = 1, recent_chunks: int = 2,
                    n_valid0=None, chunk_offset: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Quest-like baseline: score all base chunks, top-k.  Same
    interface."""
    ub, _ = chunk_bounds_gqa_matmul(q, kmax0, kmin0, impl=impl)
    nc0 = ub.shape[-1]
    if n_valid0 is None:
        n_valid0 = nc0
    ids = torch.arange(nc0, dtype=torch.int32, device=q.device).expand(
        ub.shape)
    ub = _force_bias(ub, ids, 0, nc0, sink_chunks, recent_chunks, n_valid0,
                     chunk_offset)
    return _top_k(ub, min(budget, nc0)).to(torch.int32)


def pyramid_select_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                       pyr_c: Pyramid, pyr_r: Pyramid, budget: int, *,
                       rf: int = 2, sink_chunks: int = 1,
                       recent_chunks: int = 2, n_valid0=None,
                       chunk_offset: int = 0) -> torch.Tensor:
    """MLA variant: boxes over the compressed latent (+ rope key), the
    reference's split bound in torch ops.  pyr_c levels: (B, nc, 1, r);
    pyr_r: (B, nc, 1, rope).  Returns (B, 1, k) int32."""
    L = pyr_c.levels
    nc = [pyr_c.kmax[lvl].shape[1] for lvl in range(L)]
    budget = min(budget, nc[0])
    if n_valid0 is None:
        n_valid0 = nc[0]
    beams = _beam_sizes(L, budget, nc, rf, sink_chunks + recent_chunks)

    def score(lvl, ids=None):
        boxes = [pyr_c.kmax[lvl][:, :, 0], pyr_c.kmin[lvl][:, :, 0],
                 pyr_r.kmax[lvl][:, :, 0], pyr_r.kmin[lvl][:, :, 0]]
        if ids is not None:                               # (B, 1, C)
            boxes = [_take(a[:, None], ids)[:, 0] for a in boxes]
        ub, _ = chunk_bounds_mla(q_lat, q_rope, *boxes)
        return ub[:, None]                                # (B, 1, nc)

    ub = score(L - 1)
    ids = torch.arange(nc[L - 1], dtype=torch.int32,
                       device=q_lat.device).expand(ub.shape)
    ub = _force_bias(ub, ids, L - 1, nc[0], sink_chunks, recent_chunks,
                     n_valid0, chunk_offset)
    ids = torch.gather(ids, -1, _top_k(ub, beams[L - 1]))
    for lvl in range(L - 2, -1, -1):
        ids = torch.cat([ids * 2, ids * 2 + 1], dim=-1)
        ub = _force_bias(score(lvl, ids), ids, lvl, nc[0], sink_chunks,
                         recent_chunks, n_valid0, chunk_offset)
        width = beams[lvl] if lvl > 0 else budget
        ids = torch.gather(ids, -1, _top_k(ub, min(width, ids.shape[-1])))
    return ids.to(torch.int32)


def pyramid_eval_count(levels: int, nc0: int, budget: int, rf: int = 2,
                       forced: int = 3) -> int:
    """Analytic number of chunk-bound evaluations for the pyramid
    descent."""
    nc = [max(1, nc0 >> lvl) for lvl in range(levels)]
    beams = _beam_sizes(levels, budget, nc, rf, forced)
    total = nc[levels - 1]
    for lvl in range(levels - 2, -1, -1):
        total += 2 * beams[lvl + 1]
    return total
