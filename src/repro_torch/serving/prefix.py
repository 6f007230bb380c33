"""Content-addressable shared-prefix index for the tiered KV store.

Cross-request KV reuse (KVDrive-style): requests that share a
chunk-aligned token prefix — system prompts, few-shot preambles, RAG
documents — should pay prefill FLOPs and tier bytes ONCE.  This module
is the pure-bookkeeping half: chain hashes over chunk-aligned token
spans, and a refcounted ``hash -> (arena row, chunk)`` index whose
entries live in *arena rows* — extra pseudo-sequence rows appended to
every per-sequence array of :class:`~repro_torch.serving.offload.TieredKVStore`
(disk replica + sidecar, host copies, device-pool slots, abstracts).

Design points:

* **Chain hashing.** ``h_c = sha1(h_{c-1} || tokens_c)``, so a chunk
  hash commits to the entire prefix before it.  Equal hashes therefore
  imply equal (position, prefix, chunk-tokens) — a matched chunk can be
  adopted at the *same* chunk index without any position translation.
  The partial tail chunk is hashed too (with an explicit length marker,
  so a 10-token tail never collides with a 16-token chunk that extends
  it): sharing the tail is what makes the first decode append into a
  shared chunk exercise copy-on-write.
* **Refcounts, not ownership.** Every sequence that adopts a chunk (and
  the sequence that registered it) holds one reference per ``(row,
  chunk)``.  Zero references means *evictable*, not *gone*: entries stay
  warm-cached and are only reclaimed — whole rows at a time, LRU — when
  a new registration needs an arena row and none is free.
* **Publish-after-fence.** Registration writes chunk payloads into the
  arena row during normal ingest; the index entry becomes visible to
  other requests only at ``publish()``, which the store calls after the
  write-behind disk writes are fenced.  A concurrent registration of the
  same content loses the publish race benignly: its row simply stays
  private to its registrant and is reclaimed once released.

The store serializes every call under its own ``_lock``; this class has
no locking of its own and must stay numpy/stdlib-only (lock-friendly per
INVARIANTS.md I1).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = ["chunk_hashes", "PrefixIndex"]


def chunk_hashes(tokens: np.ndarray, chunk: int) -> List[bytes]:
    """Chained per-chunk digests of a token prefix.

    Returns one digest per (possibly partial) chunk of ``tokens``.  Full
    chunks hash their token bytes; the final partial chunk (if any)
    additionally commits to its length so that a short tail and a longer
    chunk sharing its first tokens never alias.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int64))
    n = toks.shape[0]
    out: List[bytes] = []
    prev = b"leoam-prefix-v1"
    for c0 in range(0, n, chunk):
        span = toks[c0:c0 + chunk]
        h = hashlib.sha1(prev)
        h.update(span.tobytes())
        if span.shape[0] < chunk:
            h.update(b"|tail:%d" % span.shape[0])
        prev = h.digest()
        out.append(prev)
    return out


class PrefixIndex:
    """Refcounted content-addressable map of shared prefix chunks.

    All state is plain Python/numpy; the owning store's ``_lock``
    serializes access.  ``(row, c)`` keys name a chunk ``c`` stored in
    arena row ``row``.
    """

    def __init__(self, rows: Iterable[int]):
        # LIFO so the lowest row indices are handed out first (stable,
        # test-friendly ordering).
        self.free_rows: List[int] = sorted(rows, reverse=True)
        self.entries: Dict[bytes, Tuple[int, int]] = {}   # hash -> (row, c)
        self.entry_of: Dict[Tuple[int, int], bytes] = {}  # (row, c) -> hash
        self.refs: Dict[Tuple[int, int], int] = {}        # live adopters
        self.row_chunks: Dict[int, Set[int]] = {}         # row -> chunk ids
        self._tick = 0
        self.row_tick: Dict[int, int] = {}                # row -> last use
        # hit-rate accounting (request-granular lookups, chunk-granular
        # hit/miss tallies; read back via TieredKVStore.prefix_stats()).
        self.lookups = 0
        self.hit_chunks = 0
        self.miss_chunks = 0
        self.evicted_rows = 0

    # -- lookup ---------------------------------------------------------

    def match(self, hashes: Sequence[bytes],
              record: bool = True) -> List[Tuple[int, int]]:
        """Longest resident prefix of ``hashes`` as ``[(row, c), ...]``.

        The chain construction guarantees a hit at position ``c`` was
        registered at chunk index ``c``; the scan stops at the first
        miss (a later stray hit could not share the same prefix).
        """
        out: List[Tuple[int, int]] = []
        for c, h in enumerate(hashes):
            loc = self.entries.get(h)
            if loc is None:
                break
            assert loc[1] == c, "chain hash matched at a foreign position"
            out.append(loc)
        if record:
            self.lookups += 1
            self.hit_chunks += len(out)
            self.miss_chunks += len(hashes) - len(out)
        return out

    # -- refcounts ------------------------------------------------------

    def acquire(self, keys: Iterable[Tuple[int, int]]) -> None:
        for key in keys:
            self.refs[key] = self.refs.get(key, 0) + 1
            self._touch(key[0])

    def decref(self, keys: Iterable[Tuple[int, int]]) -> None:
        for key in keys:
            n = self.refs.get(key, 0)
            assert n > 0, f"refcount underflow on shared chunk {key}"
            if n == 1:
                del self.refs[key]
            else:
                self.refs[key] = n - 1

    def ref_count(self, key: Tuple[int, int]) -> int:
        return self.refs.get(key, 0)

    def _touch(self, row: int) -> None:
        self._tick += 1
        self.row_tick[row] = self._tick

    # -- registration ---------------------------------------------------

    def alloc_row(self) -> Optional[Tuple[int, List[int]]]:
        """Hand out an arena row for a new registration.

        Prefers free rows; under pressure evicts the least-recently-used
        row whose every chunk has zero references (zero-ref rows are
        cache, not garbage — they are reclaimed only here).  Returns
        ``(row, [chunks the caller must scrub])`` or ``None`` when every
        row is pinned by live references.
        """
        if self.free_rows:
            row = self.free_rows.pop()
            return row, []
        victim = None
        for row, chunks in self.row_chunks.items():
            if any(self.refs.get((row, c), 0) for c in chunks):
                continue
            if victim is None or self.row_tick.get(row, 0) < \
                    self.row_tick.get(victim, 0):
                victim = row
        if victim is None:
            return None
        chunks = sorted(self.row_chunks.pop(victim))
        for c in chunks:
            h = self.entry_of.pop((victim, c), None)
            if h is not None and self.entries.get(h) == (victim, c):
                del self.entries[h]
        self.row_tick.pop(victim, None)
        self.evicted_rows += 1
        return victim, chunks

    def plan(self, row: int, chunks: Iterable[int]) -> None:
        """Reserve ``chunks`` of ``row`` for an in-flight registration."""
        self.row_chunks[row] = set(chunks)
        self._touch(row)

    def publish(self, row: int, c: int, h: bytes) -> bool:
        """Make ``(row, c)`` adoptable under hash ``h``.

        First registrant wins: if ``h`` is already published (a
        concurrent registration of the same content landed first) the
        entry is left alone and the caller's copy stays private to its
        registrant — reclaimed by ``alloc_row`` once released.
        """
        if h in self.entries:
            return False
        self.entries[h] = (row, c)
        self.entry_of[(row, c)] = h
        self._touch(row)
        return True

    # -- stats ----------------------------------------------------------

    def shared_chunks(self) -> int:
        return len(self.entries)

    def live_refs(self) -> int:
        return sum(self.refs.values())
