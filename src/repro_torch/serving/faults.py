"""Deterministic seeded fault injection for the tiered serving stack.

The serving stack's three fragile boundaries — disk memmap I/O, packed
sidecar payloads, and the admission/prefetch executors — are treated as
infallible by a correctness-only reproduction, but they are exactly the
slow, *unreliable* part of a commodity GPU-CPU-Disk hierarchy.  This
module gives tests (and soak harnesses) a way to make them fail **on
purpose and reproducibly**:

* a :class:`FaultPlan` maps ``(site, call-index) -> fault kind``.  Every
  choke point in :mod:`repro_torch.serving.offload` consults the plan exactly
  once per physical I/O attempt (``FaultPlan.check``), so a schedule is
  a deterministic function of the call sequence — two runs of the same
  engine configuration with the same plan inject byte-identical faults.
* :func:`FaultPlan.from_seed` derives a schedule from a single integer,
  which is what the chaos property test fuzzes over.
* the typed exceptions below are the *vocabulary* of the fault domain:
  the store raises them, the engine contains them.  They live here (not
  in ``offload.py``) so the engine/scheduler can catch them without
  importing store internals.

Fault sites (the choke points that consult the plan):

=================  =====================================================
``disk_read``      coalesced fp16-replica memmap gather (``_stage_disk``
                   / ``fetch_chunks``)
``sidecar_read``   coalesced packed int4/int8 sidecar gather
                   (``_read_sidecar``)
``pq_read``        coalesced PQ-code memmap gather
                   (``read_abstracts_pq_batch``) — degrades importance
                   evaluation to the min/max boxes, never fails a round
``disk_write``     cold-ingest replica/sidecar landing (``_ingest_cold``)
``worker``         executor work item entry (ingest worker body)
``pressure``       resource-pressure monitor sample
                   (``overload.PressureMonitor.sample``) — forces
                   watermark transitions: ``latency`` ⇒ at least yellow,
                   ``io_error`` ⇒ red
=================  =====================================================

Fault kinds:

=============  ========================================================
``io_error``   raise :class:`TransientDiskError`; the store retries
               with bounded backoff, so a *single* scheduled index
               models a transient error (the retry consumes the next,
               presumably clean, index) and ``io_retries + 1``
               *consecutive* indices model a persistent failure that
               exhausts the retry budget and degrades.
``latency``    sleep ``latency_s`` at the choke point (a seek storm /
               SSD GC pause); never changes values, only timing.
``bitflip``    flip one bit of the first targeted chunk's stored bytes
               *before* the read — the checksum layer must catch it.
``exception``  raise :class:`WorkerFault` (an arbitrary bug in an
               executor work item).
=============  ========================================================
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "FaultPlan", "FaultEvent", "FAULT_SITES", "FAULT_KINDS",
    "TransientDiskError", "DiskIOExhausted", "WorkerFault",
    "ChunkLostError", "IngestError", "AdmissionError",
    "RejectedOverload",
]

FAULT_SITES = ("disk_read", "sidecar_read", "pq_read", "disk_write",
               "worker", "pressure")
FAULT_KINDS = ("io_error", "latency", "bitflip", "exception")

# Default per-site kind pools for seeded schedules.  Read sites run on
# the decode thread, whose contract is: transient errors retry, media
# corruption degrades via checksums — arbitrary exceptions belong to the
# executor boundary ("worker"), where the engine's per-seq fence contains
# them.  Keeping "exception" off read sites mirrors where real faults
# live and keeps the chaos test's containment obligations well-defined.
_SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    "disk_read": ("io_error", "latency", "bitflip"),
    "sidecar_read": ("io_error", "latency", "bitflip"),
    "pq_read": ("io_error", "latency", "bitflip"),
    "disk_write": ("io_error", "latency"),
    "worker": ("exception", "latency"),
    # the pressure site never raises: the monitor maps "latency" to a
    # forced yellow watermark and "io_error" to a forced red — chaos
    # tests use it to drive preemption/shed transitions on demand
    "pressure": ("latency", "io_error"),
}


# ---------------------------------------------------------------------------
# typed exceptions — the fault domain's vocabulary
# ---------------------------------------------------------------------------

class TransientDiskError(IOError):
    """An injected (or real) transient disk error; the store retries it."""


class DiskIOExhausted(IOError):
    """A disk operation failed past the bounded retry budget.

    Raised by the store's retry wrapper; callers degrade (fp16 fallback,
    recompute-from-prompt, or seq-level failure) instead of letting it
    reach ``decode_round`` raw.
    """


class WorkerFault(RuntimeError):
    """An injected exception inside an executor work item — stands in for
    an arbitrary bug on a worker thread."""


class ChunkLostError(RuntimeError):
    """One or more disk replicas failed checksum verification (or stayed
    unreadable past the retry budget).

    ``keys`` is ``[(seq, phys_row, chunk), ...]`` for ONE store layer
    ``layer``: the billing seq that requested the read, the physical
    storage row (== seq unless the chunk lives in a shared prefix-arena
    row), and the chunk index.  The engine recovers by recomputing the
    affected prompt span (bitwise-identical, PR-4 chunked prefill) or by
    failing just the affected sequence.
    """

    def __init__(self, layer: int, keys: List[Tuple[int, int, int]]):
        self.layer = int(layer)
        self.keys = list(keys)
        super().__init__(
            f"disk-lost chunks at layer {layer}: "
            f"{[(s, p, c) for s, p, c in self.keys]}")


class IngestError(RuntimeError):
    """A sequence's write-behind cold ingest failed.

    Raised by ``ingest_fence`` AFTER all of the seq's futures have been
    awaited (so no write is still in flight when the caller reclaims the
    row); wraps the first underlying failure as ``cause``.
    """

    def __init__(self, seq: int, cause: BaseException):
        self.seq = int(seq)
        self.cause = cause
        super().__init__(f"cold ingest failed for seq {seq}: {cause!r}")


class RejectedOverload(RuntimeError):
    """A queued request was shed under red resource pressure.

    The structured terminal state of load shedding (scheduler policy §3c):
    the request never admitted, so no slot/tier state exists for it —
    ``reasons`` carries the monitor signals that tripped red (e.g.
    ``{"queue", "pool"}``) so clients and audits can distinguish shed
    causes.  Stored on ``Request.error`` / the rejected list, never
    raised across the scheduler boundary.
    """

    def __init__(self, rid: int, reasons: Tuple[str, ...] = ()):
        self.rid = int(rid)
        self.reasons = tuple(reasons)
        super().__init__(
            f"request {rid} shed under red overload pressure "
            f"({', '.join(self.reasons) or 'forced'})")


class AdmissionError(RuntimeError):
    """An async admission work item failed for sequence ``sid``.

    The slot is NOT yet reclaimed when this surfaces from the admission
    future — the scheduler (decode thread) must call
    ``engine.abort_admission(sid)`` to drain and recycle it.
    """

    def __init__(self, sid: int, cause: BaseException):
        self.sid = int(sid)
        self.cause = cause
        super().__init__(f"admission failed for seq {sid}: {cause!r}")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclass
class FaultEvent:
    """One fault that actually fired: ``site``, the per-site call index it
    fired at, the ``kind`` injected, and the choke point's opaque ``key``
    (for read sites: the ``(layer, phys_row, chunk)`` the fault landed
    on — what the chaos test uses to classify affected sequences)."""

    site: str
    index: int
    kind: str
    key: Any = None


@dataclass
class FaultPlan:
    """A deterministic ``(site, call-index) -> kind`` fault schedule.

    ``schedule`` maps each site name to ``{call_index: kind}``.  Call
    indices count *physical attempts* at the choke point (retries
    re-consult the plan at the next index), starting at 0, per site.
    Thread-safe: the per-site counters live behind one lock, so worker
    and decode threads draw a single global order per site.
    """

    schedule: Dict[str, Dict[int, str]] = field(default_factory=dict)
    latency_s: float = 0.0
    fired: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {s: 0 for s in self.schedule}
        for site in self.schedule:
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r}")
            for kind in self.schedule[site].values():
                if kind not in FAULT_KINDS:
                    raise ValueError(f"unknown fault kind {kind!r}")

    @classmethod
    def from_seed(cls, seed: int, *, rate: float = 0.02,
                  horizon: int = 400, latency_s: float = 0.0,
                  sites: Tuple[str, ...] = FAULT_SITES,
                  kinds: Optional[Tuple[str, ...]] = None) -> "FaultPlan":
        """Derive a schedule from one integer: each of the first
        ``horizon`` call indices at each site fails with probability
        ``rate``, with a kind drawn uniformly from that site's pool
        (``_SITE_KINDS``) — or from ``kinds`` when given explicitly."""
        rng = np.random.RandomState(int(seed) & 0x7FFFFFFF)
        schedule: Dict[str, Dict[int, str]] = {}
        for site in sites:
            pool = kinds if kinds is not None \
                else _SITE_KINDS.get(site, FAULT_KINDS)
            hits = {}
            for idx in np.nonzero(rng.random_sample(horizon) < rate)[0]:
                hits[int(idx)] = pool[int(rng.randint(len(pool)))]
            if hits:
                schedule[site] = hits
        return cls(schedule=schedule, latency_s=latency_s)

    def check(self, site: str, key: Any = None) -> Optional[str]:
        """Consume one call index at ``site``; return the scheduled fault
        kind (recording a :class:`FaultEvent`) or ``None``."""
        with self._lock:
            n = self._calls.get(site, 0)
            self._calls[site] = n + 1
            kind = self.schedule.get(site, {}).get(n)
            if kind is not None:
                self.fired.append(FaultEvent(site, n, kind, key))
            return kind

    def record_key(self, key: Any) -> None:
        """Back-fill the key of the most recent fired event (used by
        bitflip choke points that pick the victim after the draw)."""
        with self._lock:
            if self.fired:
                self.fired[-1].key = key

    def calls(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._calls)

    def fired_events(self) -> List[FaultEvent]:
        with self._lock:
            return list(self.fired)
