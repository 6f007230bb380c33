"""Overload control: resource-pressure watermarks and a trace-driven
load harness.

A single commodity GPU serving long-context traffic saturates three
resources long before compute: device pool slots (the working-set arena),
host KV bytes (the staging tier), and disk free space (the write-through
replica tier).  :class:`PressureMonitor` samples all three plus the
admission-queue depth every scheduler round and folds them into one of
three watermark states:

* **green** — headroom everywhere: admit freely, resume preempted work;
* **yellow** — some signal crossed its soft watermark: the scheduler
  pauses admission (resource pressure) or preempts low-priority work
  (queue pressure) — see ``ContinuousBatcher._apply_pressure``;
* **red** — a hard watermark crossed: queued requests shed with a
  structured :class:`~repro_torch.serving.faults.RejectedOverload`.

The state STRINGS are the contract with the scheduler (it mirrors them as
``_GREEN/_YELLOW/_RED`` rather than importing this module, so this module
can import the scheduler for :class:`LoadHarness` without a cycle).

The monitor is also a fault site (``"pressure"``): a
:class:`~repro_torch.serving.faults.FaultPlan` can force watermark transitions
(``latency`` ⇒ at least yellow, ``io_error`` ⇒ red) without any real
resource being exhausted — the chaos tests drive the whole
preempt/shed/resume path deterministically that way.

:class:`LoadHarness` replays a seeded bursty trace
(:func:`repro_torch.serving.trace.gen_trace`) against the REAL
:class:`~repro_torch.serving.scheduler.ContinuousBatcher` in wall-clock time
and reports p50/p99 TTFT, throughput and **goodput** — the fraction of
submitted requests that completed within their deadline.  Its numbers are
meant to be held against the analytic
:func:`repro_torch.serving.simulator.simulate_trace_goodput` run on the
same trace.
"""

from __future__ import annotations

import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Set, Tuple

import numpy as np

from repro_torch.serving.sanitizer import any_thread
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.serving.trace import Arrival

__all__ = ["GREEN", "YELLOW", "RED", "WatermarkCfg", "PressureMonitor",
           "LoadHarness"]

# watermark states — string values mirrored by scheduler._GREEN/_YELLOW/
# _RED (the contract; see module docstring)
GREEN, YELLOW, RED = "green", "yellow", "red"

_SEVERITY = {GREEN: 0, YELLOW: 1, RED: 2}


@dataclass
class WatermarkCfg:
    """Soft (yellow) and hard (red) watermarks per pressure signal.

    Defaults are deliberately permissive: the pool-fraction gates are OFF
    (a full pool is NORMAL steady state — the pool evicts LRU; a strict
    ``< 0.0`` never fires), the host-byte gates are unbounded, and the
    disk gates sit low enough that only a genuinely full filesystem
    trips them.  Production/test setups tighten whichever signals they
    actually want to react to."""

    pool_free_yellow: float = 0.0      # pool free-slot FRACTION below
    pool_free_red: float = 0.0         # which the state trips (strict <;
                                       # 0.0 = disabled)
    host_bytes_yellow: float = float("inf")
    host_bytes_red: float = float("inf")
                                       # store.host_bytes() above which
                                       # the staging tier is pressured
    disk_free_yellow: float = 64 << 20 # disk free bytes BELOW which the
    disk_free_red: float = 16 << 20    # replica tier is at risk
    queue_yellow: int = 8              # admission-queue depth; red
    queue_red: int = 32                # shedding drains back down to the
                                       # yellow watermark


class PressureMonitor:
    """Samples device-pool occupancy, host staging bytes, disk free
    space and queue depth against :class:`WatermarkCfg`; returns the
    WORST state crossed plus the set of signal names that crossed
    (``{"pool", "host", "disk", "queue", "forced"}``).

    ``disk_free_fn`` overrides the ``shutil.disk_usage(store._root)``
    probe (tests inject scripted values); ``fault_plan`` hooks the
    ``"pressure"`` site — a planned ``latency`` fault forces at least
    yellow, ``io_error`` forces red (the site never raises)."""

    def __init__(self, engine, cfg: Optional[WatermarkCfg] = None, *,
                 fault_plan=None,
                 disk_free_fn: Optional[Callable[[], float]] = None):
        self.engine = engine
        self.cfg = cfg or WatermarkCfg()
        self.faults = fault_plan
        self._disk_free_fn = disk_free_fn
        self.samples = 0
        self.forced = 0                # fault-injected transitions
        self.state_counts: Dict[str, int] = {GREEN: 0, YELLOW: 0, RED: 0}
        self.last_signals: Dict[str, float] = {}

    def _disk_free(self) -> Optional[float]:
        if self._disk_free_fn is not None:
            return float(self._disk_free_fn())
        root = getattr(getattr(self.engine, "store", None), "_root", None)
        if root is None:
            return None
        try:
            return float(shutil.disk_usage(root).free)
        except OSError:
            return None                # store torn down mid-sample

    @any_thread
    def sample(self, queue_depth: int = 0) -> Tuple[str, Set[str]]:
        self.samples += 1
        cfg = self.cfg
        state, reasons = GREEN, set()

        def trip(to: str, why: str) -> None:
            nonlocal state
            if _SEVERITY[to] > _SEVERITY[state]:
                state = to
            reasons.add(why)

        if self.faults is not None:
            kind = self.faults.check("pressure", self.samples)
            if kind is not None:
                self.forced += 1
                trip(RED if kind == "io_error" else YELLOW, "forced")
        pool = self.engine.pool_stats() \
            if hasattr(self.engine, "pool_stats") else {}
        slots = pool.get("slots") or 0
        if slots:
            frac = pool.get("free_slots", 0) / slots
            self.last_signals["pool_free_frac"] = frac
            if frac < cfg.pool_free_red:
                trip(RED, "pool")
            elif frac < cfg.pool_free_yellow:
                trip(YELLOW, "pool")
        store = getattr(self.engine, "store", None)
        if store is not None and hasattr(store, "host_bytes"):
            hb = float(store.host_bytes())
            self.last_signals["host_bytes"] = hb
            if hb > cfg.host_bytes_red:
                trip(RED, "host")
            elif hb > cfg.host_bytes_yellow:
                trip(YELLOW, "host")
        free = self._disk_free()
        if free is not None:
            self.last_signals["disk_free_bytes"] = free
            if free < cfg.disk_free_red:
                trip(RED, "disk")
            elif free < cfg.disk_free_yellow:
                trip(YELLOW, "disk")
        self.last_signals["queue_depth"] = float(queue_depth)
        if queue_depth > cfg.queue_red:
            trip(RED, "queue")
        elif queue_depth > cfg.queue_yellow:
            trip(YELLOW, "queue")
        self.state_counts[state] += 1
        return state, reasons


class LoadHarness:
    """Replay an arrival trace against a live :class:`ContinuousBatcher`.

    Arrivals submit at ``t * time_scale`` wall seconds after start
    (``time_scale=0`` submits everything up front — the as-fast-as-
    possible mode the CI smoke uses); the decode loop steps whenever
    work is pending, so measured TTFT/goodput include real queueing,
    admission, preemption and shedding effects.  Prompt token ids are
    drawn from a seeded RNG; prompt lengths are clamped to what the
    engine's ``max_len`` admits next to the arrival's decode budget."""

    def __init__(self, batcher: ContinuousBatcher,
                 arrivals: Iterable[Arrival], *, time_scale: float = 1.0,
                 seed: int = 0, vocab: int = 32000,
                 max_rounds: int = 100_000):
        self.batcher = batcher
        self.arrivals = sorted(arrivals, key=lambda a: a.t)
        self.time_scale = float(time_scale)
        self.vocab = int(vocab)
        self.max_rounds = int(max_rounds)
        self._rng = np.random.RandomState(int(seed) & 0x7FFFFFFF)
        self.rounds = 0

    def _make_request(self, rid: int, a: Arrival) -> Request:
        n = int(a.prompt_len)
        eng = self.batcher.engine
        if eng is not None and hasattr(eng, "ecfg"):
            # decode appends past the prompt: leave room for max_new + 1
            n = max(1, min(n, int(eng.ecfg.max_len) - int(a.max_new) - 1))
        prompt = self._rng.randint(1, self.vocab, size=n).astype(np.int32)
        return Request(rid=rid, prompt=prompt, max_new=int(a.max_new),
                       deadline_s=a.deadline_s, priority=int(a.priority))

    def run(self) -> Dict[str, float]:
        b = self.batcher
        t0 = time.perf_counter()
        i = 0
        while i < len(self.arrivals) or b.pending_work:
            if self.rounds >= self.max_rounds:
                break
            now = time.perf_counter() - t0
            while i < len(self.arrivals) \
                    and self.arrivals[i].t * self.time_scale <= now:
                b.submit(self._make_request(i, self.arrivals[i]))
                i += 1
            if b.pending_work:
                b.step()
                self.rounds += 1
            elif i < len(self.arrivals):
                # idle until the next arrival is due
                due = self.arrivals[i].t * self.time_scale
                time.sleep(min(max(due - (time.perf_counter() - t0), 0.0),
                               0.01))
        return self.result()

    def result(self) -> Dict[str, float]:
        """Batcher stats plus the goodput row: completed-within-deadline
        over submitted.  Deadline enforcement is the scheduler's (an
        expired request is cancelled, i.e. lands in ``failed``), so a
        request that completed WITH a deadline met it by construction;
        deadline-free completions count as within."""
        st = dict(self.batcher.stats())
        submitted = st.get("requests_submitted", 0.0)
        st["goodput"] = st.get("requests_completed", 0.0) \
            / max(1.0, submitted)
        st["harness_rounds"] = float(self.rounds)
        return st
