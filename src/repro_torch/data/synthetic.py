"""Deterministic synthetic corpus + packing + sharded host loader, copied
from ``repro.data.synthetic`` (numpy only): the same seeds give the same
batches, bit for bit.

No external datasets ship with the container, so the pipeline generates a
reproducible token stream (hash-seeded Zipf-ish n-gram chains — enough
structure for a small LM to measurably learn) and exercises the full path a
real deployment needs: document sampling → EOS packing → fixed-length
batches → per-host sharding → async device prefetch.
"""

from __future__ import annotations

import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

EOS = 1
PAD = 0


@dataclass(frozen=True)
class DataCfg:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 512
    ngram: int = 3


class SyntheticCorpus:
    """Markov-chain documents with a Zipfian unigram backbone."""

    def __init__(self, cfg: DataCfg):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(2, V)  # 0=pad, 1=eos reserved
        probs = 1.0 / ranks ** 1.1
        self._uni = np.concatenate([[0.0, 0.0], probs / probs.sum()])
        self._uni = self._uni / self._uni.sum()
        # rng.choice(V, p=self._uni) draws one random_sample() and looks it
        # up in this cdf (numpy's own steps); built once here, where choice
        # would rebuild and re-check it over all V on every call
        self._cdf = self._uni.cumsum()
        self._cdf /= self._cdf[-1]
        # per-context offsets make the stream learnable (hash-mixed bigrams)
        self._mix_a = rng.randint(1, 2**31 - 1)
        self._mix_b = rng.randint(1, 2**31 - 1)

    def document(self, doc_id: int) -> np.ndarray:
        rng = np.random.RandomState((self.cfg.seed * 1_000_003 + doc_id)
                                    % (2**31 - 1))
        n = max(8, int(rng.exponential(self.cfg.mean_doc_len)))
        V = self.cfg.vocab_size
        toks = np.empty(n, np.int32)
        prev = rng.randint(2, V)
        for i in range(n):
            # bigram determinism with unigram noise: next token is a hash of
            # prev 70% of the time -> learnable structure
            if rng.rand() < 0.7:
                t = 2 + (prev * self._mix_a + self._mix_b) % (V - 2)
            else:
                t = int(self._cdf.searchsorted(rng.random_sample(),
                                               side="right"))
            toks[i] = t
            prev = int(t)
        return toks


def pack_documents(corpus: SyntheticCorpus, seq_len: int, start_doc: int,
                   n_seqs: int) -> Tuple[np.ndarray, int]:
    """Greedy EOS-separated packing into (n_seqs, seq_len+1) buffers."""
    out = np.full((n_seqs, seq_len + 1), PAD, np.int32)
    doc = start_doc
    row, col = 0, 0
    buf = corpus.document(doc)
    off = 0
    while row < n_seqs:
        take = min(len(buf) - off, seq_len + 1 - col)
        out[row, col: col + take] = buf[off: off + take]
        col += take
        off += take
        if off >= len(buf):
            doc += 1
            buf = corpus.document(doc)
            off = 0
            if col < seq_len + 1:
                out[row, col] = EOS
                col += 1
        if col >= seq_len + 1:
            row += 1
            col = 0
    return out, doc


class ShardedLoader:
    """Per-host shard of the global batch with background prefetch."""

    def __init__(self, cfg: DataCfg, *, host_id: int = 0, n_hosts: int = 1,
                 prefetch: int = 2):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // n_hosts
        self.corpus = SyntheticCorpus(cfg)
        self._doc = host_id * 1_000_000  # disjoint doc ranges per host
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self) -> Dict[str, np.ndarray]:
        packed, self._doc = pack_documents(
            self.corpus, self.cfg.seq_len, self._doc, self.local_batch)
        tokens = packed[:, :-1]
        targets = packed[:, 1:].copy()
        targets[targets == PAD] = -1            # ignore padding in the loss
        return {"tokens": tokens, "targets": targets}

    def _worker(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make_batch(), timeout=0.5)
            except queue_mod.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
