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

The device-side pyramid refinement (``pyramid_select_gqa``) belongs to
``lm.decode_step``'s in-model sparse path, a later slice of the port.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


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
