"""Continuous-batching request scheduler for the LeoAM serving engine.

Admission is KV-budget-aware across the three tiers.  Two admission
policies:

* **analytic** (legacy / non-pooled engines): a request is admitted when
  its max_len worth of chunks fits the configured device budget — the
  worst-case estimate, which leaves most of the device slab idle;
* **pool-aware** (batched engine with a device chunk pool): admission is
  driven off the engine's LIVE ``pool_stats()`` — a request is charged its
  worst-case per-ROUND working set (``engine.admission_need_chunks``,
  selection budget + forced sink/recent/hot chunks per layer) against the
  actual pool slot count, optionally gated on the pool hit rate so a
  thrashing pool pauses admission.  Per-round working sets are far below
  max_len chunk counts, so the same device budget serves more concurrent
  sequences.

Decode proceeds in rounds over all active requests; finished requests
retire immediately and the queue backfills — the standard continuous-
batching loop.  With ``overlap_admission=True`` (batched mode) admission
runs UNDER decode: queued requests prefill on the engine's admission
worker while the active batch keeps decoding, and join the next round
after their prefill future resolves — TTFT for queued requests drops by
roughly the decode time they no longer wait out.

With ``chunked_admission=True`` admission instead runs CHUNKED on the
decode thread: the engine's resumable chunked prefill advances by at most
``prefill_round_tokens`` prompt tokens between consecutive decode rounds,
so the decode-latency spike a very long prompt causes while admitting is
bounded by the budget instead of its whole prefill.  With
``adaptive_prefill_budget=True`` that budget is re-derived every round
from the measured decode-round and chunk-step EWMAs through
``pipeline.chunked_admission_model`` — the largest budget whose predicted
round gap stays within ``target_stall_frac`` of an idle round — so the
stall bound tracks batch composition; the derived figure is exported by
:meth:`ContinuousBatcher.stats` as ``prefill_round_tokens``.  Either overlap mode
can be paced (``pace_admission=True``): the scheduler EWMAs decode round
time, keeps an idle baseline from rounds with no admission in flight, and
holds admission work while the running EWMA exceeds the baseline by more
than ``max_round_inflation`` — overlap only spends host cycles when the
host has headroom.  The gate state is exported by :meth:`stats`.

Two drive modes:

* **batched** (pass ``engine=BatchedLeoAMEngine(...)``): every round is ONE
  ``decode_round`` over all active sequences against the shared multi-tier
  store — importance evaluation, promotion I/O and the working-set
  attention dispatch amortize across the batch (the paper's large-batch
  speedup regime).
* **legacy** (pass ``make_engine=...``): one single-sequence engine per
  request, stepped in a Python loop — kept for A/B benchmarking and
  backward compatibility.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pipeline import chunked_admission_model
from repro_torch.serving.faults import AdmissionError, RejectedOverload
from repro_torch.serving.sanitizer import any_thread, decode_thread_only
from repro_torch.serving.spans import span

# pressure watermark states (mirrored by serving.overload — the monitor
# lives there; the string values are the contract, so the scheduler never
# imports overload.py and LoadHarness can import the scheduler freely)
_GREEN, _YELLOW, _RED = "green", "yellow", "red"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None  # wall-clock budget from submit; an
                                       # expired request is cancelled at
                                       # whatever lifecycle stage it is in
                                       # (queued / mid-admission / decoding)
    out: List[int] = field(default_factory=list)
    t_submit: float = field(default_factory=time.perf_counter)
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    error: Optional[str] = None        # terminal failure/cancellation
                                       # reason (None = completed normally)
    degraded: bool = False             # served with degraded numerics (a
                                       # corrupt sidecar fell back to the
                                       # lossless fp16 replica)
    sid: Optional[int] = None          # engine slot the request decoded in
                                       # (observability: lets audits map
                                       # store/fault events back to the
                                       # request; slots are reused)
    priority: int = 0                  # scheduling class (higher = more
                                       # important): overload preemption
                                       # picks victims lowest-class-first
                                       # and red-pressure shedding drops
                                       # lowest-class-newest-first
    t_admit: Optional[float] = None    # when the request left the queue
                                       # (queue wait = t_admit - t_submit)
    t_suspend: Optional[float] = None  # set while preempted (suspended)
    suspended_s: float = 0.0           # total time spent suspended so far
    rejected_overload: Optional[RejectedOverload] = None
                                       # structured shed result (red
                                       # pressure); error carries the text

    @property
    def done(self) -> bool:
        if self.out and self.eos_id is not None and self.out[-1] == self.eos_id:
            return True
        return len(self.out) >= self.max_new

    @property
    def paused_s(self) -> float:
        """Wall time this request has spent preempted (suspended) — its
        deadline clock stops while swapped out (I7: preemption must not
        silently consume the victim's latency budget)."""
        p = self.suspended_s
        if self.t_suspend is not None:
            p += time.perf_counter() - self.t_suspend
        return p

    @property
    def expired(self) -> bool:
        return (self.deadline_s is not None
                and time.perf_counter() - self.t_submit - self.paused_s
                > self.deadline_s)


@dataclass
class SchedulerCfg:
    max_active: int = 4
    device_chunk_budget: int = 512     # total device-resident chunks
    chunk: int = 64
    overlap_admission: bool = False    # admit under decode: prefill queued
                                       # requests on the engine's admission
                                       # worker while rounds run
    prefill_ahead: int = 1             # async admissions may run this far
                                       # ahead of a free decode slot (the
                                       # engine needs max_active +
                                       # prefill_ahead sequence slots); a
                                       # retired slot is backfilled by an
                                       # ALREADY-PREFILLED request, so the
                                       # batch never starves while a
                                       # prefill runs
    pool_aware: bool = True            # drive admission off live
                                       # engine.pool_stats() when the
                                       # engine has a device chunk pool
    min_pool_hit_rate: float = 0.0     # hold admission while the warm pool
                                       # hit rate sits below this (0 = off)
    hit_rate_warmup: int = 64          # pool lookups before the gate arms
    chunked_admission: bool = False    # admit via the engine's resumable
                                       # chunked prefill: chunk steps run
                                       # BETWEEN decode rounds under a
                                       # per-round token budget, so a long
                                       # prompt never stalls the round
                                       # loop for its whole prefill
    prefill_round_tokens: int = 64     # chunked mode: max prompt tokens
                                       # advanced between two decode rounds
                                       # (the decode-stall bound); lifted
                                       # when nothing is decoding
    adaptive_prefill_budget: bool = False
                                       # derive the per-round prefill token
                                       # budget each round from the
                                       # measured decode-round EWMA and the
                                       # measured chunk-step time, via
                                       # pipeline.chunked_admission_model:
                                       # the largest budget whose predicted
                                       # max round gap stays within
                                       # target_stall_frac of an idle
                                       # round — so the stall bound holds
                                       # as batch composition changes
                                       # instead of being a static guess
    target_stall_frac: float = 0.5     # adaptive mode: tolerated round-gap
                                       # inflation (gap <= idle_round *
                                       # (1 + frac)) the derived budget
                                       # must respect
    pace_admission: bool = False       # contention-aware pacing: hold
                                       # admission work (async prefills /
                                       # chunk steps) while the decode
                                       # round EWMA sits above the idle
                                       # baseline by max_round_inflation
    max_round_inflation: float = 0.5   # tolerated round-time inflation
                                       # before the pacing gate closes
    ewma_alpha: float = 0.25           # round-time EWMA smoothing
    max_queue: int = 0                 # bounded admission-queue
                                       # backpressure: submit() rejects
                                       # (returns False, req.error set)
                                       # once this many requests wait;
                                       # 0 = unbounded (legacy behavior)
    aging_s: float = 5.0               # anti-starvation clock: a suspended
                                       # request gains one effective
                                       # priority class per aging_s
                                       # seconds preempted; once it
                                       # out-ranks the weakest active
                                       # victim it swaps back in even
                                       # under sustained yellow pressure
                                       # (0 disables aging)
    credit_prefix: bool = True         # when the engine runs the shared-
                                       # prefix cache, credit a request's
                                       # predicted warm span (chunks whose
                                       # device-pool slot already exists)
                                       # against its device-chunk charge —
                                       # warm requests don't re-buy slots
                                       # their prefix already owns


class ContinuousBatcher:
    """Continuous batching over LeoAM engines.

    ``active`` maps rid -> (request, handle, last token); ``handle`` is the
    per-request engine in legacy mode or the shared engine's sequence id in
    batched mode.  ``_pending`` holds (request, future) pairs admitted
    asynchronously whose prefill has not resolved yet; ``_ready`` holds
    resolved admissions waiting for a free decode slot (their first token
    already exists — TTFT stops there).  Both own engine slots and count
    against every admission budget.
    """

    def __init__(self, make_engine: Optional[Callable[[], "object"]] = None,
                 cfg: Optional[SchedulerCfg] = None, *, engine=None,
                 monitor=None):
        if (make_engine is None) == (engine is None):
            raise ValueError(
                "pass exactly one of make_engine= (legacy per-request "
                "engines) or engine= (shared batched engine) — got "
                f"make_engine={make_engine!r}, engine={engine!r}")
        self.make_engine = make_engine
        self.engine = engine
        self.cfg = cfg or SchedulerCfg()
        # optional resource-pressure monitor (serving.overload): any object
        # with sample(queue_depth) -> (state, reasons) where state is
        # "green" / "yellow" / "red".  None = no overload control (legacy)
        self.monitor = monitor
        if monitor is not None and engine is None:
            raise ValueError(
                "overload control (monitor=) needs the shared batched "
                "engine: legacy per-request engines have no "
                "suspend/resume surface")
        if self.cfg.chunked_admission and self.cfg.overlap_admission:
            raise ValueError(
                "SchedulerCfg(chunked_admission=True, "
                "overlap_admission=True): chunked and overlapped "
                "admission are exclusive modes — chunked admission "
                "already interleaves prefill chunks with decode rounds "
                "on the decode thread; pick one")
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, tuple] = {}
        self._pending: List[Tuple[Request, "object"]] = []
        self._ready: List[Tuple[Request, "object", int]] = []
        # in-flight chunked admissions (own an engine slot; advanced
        # between decode rounds under the per-round token budget)
        self._chunked: List[Tuple[Request, "object"]] = []
        self.finished: List[Request] = []
        # contention-aware admission pacing state (EWMA of decode round
        # time vs the idle baseline measured with no admission in flight)
        self._round_ewma: Optional[float] = None
        self._idle_ewma: Optional[float] = None
        self._gate_open = True
        self._gated_rounds = 0
        # adaptive prefill budget state: EWMA of one chunk step's wall
        # time + the tokens it advanced, and the budget derived last round.
        # The very first chunk step is discarded (jit-compile time, seconds
        # vs ~ms steady-state — seeding the EWMA with it would pin the
        # derived budget at one chunk for tens of rounds after a cold start)
        self._chunk_ewma: Optional[float] = None
        self._chunk_steps = 0
        self._chunk_tokens: Optional[int] = None
        self._derived_budget: Optional[int] = None
        # per-rid predicted warm-prefix device-chunk credit, frozen at
        # first sight so a request's charge stays stable across rounds
        # even as the shared-prefix index churns underneath it
        self._prefix_credit: Dict[int, int] = {}
        # fault-domain request accounting: rejected submissions (bounded
        # queue) and cancelled requests (deadline expiry) — surfaced
        # through stats() next to the engine/store fault counters
        self.rejected: List[Request] = []
        self._requests_rejected = 0
        self._requests_cancelled = 0
        # overload-control state: preempted requests parked with their
        # engine slot ({rid: (req, sid, last tok)}); the admission pause
        # flag (resource yellow/red closes it); watermark observability
        self._suspended: Dict[int, Tuple[Request, "object", int]] = {}
        self._admission_paused = False
        self._pressure_state = _GREEN
        self._pressure_rounds = {_GREEN: 0, _YELLOW: 0, _RED: 0}
        self._requests_submitted = 0
        self._suspensions = 0
        self._resumes = 0

    @any_thread
    def submit(self, req: Request) -> bool:
        """Enqueue a request; returns False (with ``req.error`` set) when
        the bounded queue is full — structured backpressure instead of an
        unbounded deque under overload.  The length check and append are
        not atomic together, so the bound is approximate by at most the
        number of concurrent producers (each submit adds one)."""
        self._requests_submitted += 1
        if self.cfg.max_queue > 0 and len(self.queue) >= self.cfg.max_queue:
            req.error = (f"rejected: admission queue at "
                         f"max_queue={self.cfg.max_queue}")
            req.t_done = time.perf_counter()
            self.rejected.append(req)
            self._requests_rejected += 1
            return False
        # deque.append is atomic; any producer thread may enqueue
        self.queue.append(req)
        return True

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def _pool_mode(self) -> bool:
        return (self.cfg.pool_aware and self.engine is not None
                and getattr(getattr(self.engine, "store", None),
                            "use_pool", False)
                and hasattr(self.engine, "pool_stats"))

    def _chunks_needed(self, req: Request) -> int:
        return (len(req.prompt) + req.max_new + self.cfg.chunk - 1) \
            // self.cfg.chunk

    def _need(self, req: Request) -> int:
        """Device chunks a request is charged at admission: its per-round
        working set in pool mode, its analytic max_len worst case else.
        With the shared-prefix cache on, chunks whose device slot the
        warm prefix already holds are credited back (floor of 1 chunk —
        even a full hit recomputes its last prompt chunk)."""
        if self._pool_mode():
            need = self.engine.admission_need_chunks(len(req.prompt),
                                                     req.max_new)
            need -= self._device_prefix_credit(req, need)
            return need
        return self._chunks_needed(req)

    def _device_prefix_credit(self, req: Request, need: int) -> int:
        """Predicted warm-span device chunks, memoized per rid."""
        store = getattr(self.engine, "store", None)
        if (not self.cfg.credit_prefix or store is None
                or getattr(store, "_prefix", None) is None):
            return 0
        if req.rid not in self._prefix_credit:
            probe = store.prefix_probe(req.prompt)
            self._prefix_credit[req.rid] = int(probe["device_hits"])
        return min(self._prefix_credit[req.rid], max(need - 1, 0))

    def _device_chunks_used(self) -> int:
        reqs = [r for r, _, _ in self.active.values()] \
            + [r for r, _ in self._pending] \
            + [r for r, _ in self._chunked] \
            + [r for r, _, _ in self._ready]
        return sum(self._need(r) for r in reqs)

    def _overlap(self) -> bool:
        return (self.cfg.overlap_admission and self.engine is not None
                and hasattr(self.engine, "add_sequence_async"))

    def _chunked_mode(self) -> bool:
        return (self.cfg.chunked_admission and self.engine is not None
                and hasattr(self.engine, "begin_admission"))

    def _can_admit(self) -> bool:
        if self._admission_paused:
            return False               # resource pressure: hold admission
        # async/chunked admissions may run prefill_ahead past the decode
        # slots: the ready queue backfills a retiring slot with zero
        # prefill stall
        ahead = self._overlap() or self._chunked_mode()
        cap = self.cfg.max_active + (self.cfg.prefill_ahead if ahead else 0)
        if not self.queue or \
                len(self.active) + len(self._pending) + len(self._chunked) \
                + len(self._ready) >= cap:
            return False
        if self._pool_mode():
            ps = self.engine.pool_stats()
            budget = ps["slots"] or self.cfg.device_chunk_budget
            looks = ps["hits"] + ps["misses"]
            if (self.cfg.min_pool_hit_rate > 0.0 and self.active
                    and looks >= self.cfg.hit_rate_warmup
                    and ps["hit_rate"] < self.cfg.min_pool_hit_rate):
                return False           # pool is thrashing: hold admission
        else:
            budget = self.cfg.device_chunk_budget
        if self._device_chunks_used() + self._need(self.queue[0]) > budget:
            return False
        return self.engine is None or self.engine.free_slots > 0

    def _admit(self) -> None:
        overlap = self._overlap()
        chunked = self._chunked_mode()
        while self._can_admit():
            if (self.cfg.pace_admission and not self._gate_open
                    and self.active and (overlap or chunked)):
                break                  # host has no headroom: hold overlap
            req = self.queue.popleft()
            req.t_admit = time.perf_counter()
            if chunked:
                adm = self.engine.begin_admission(req.prompt)
                self._chunked.append((req, adm))
                continue
            if overlap:
                fut = self.engine.add_sequence_async(req.prompt)
                self._pending.append((req, fut))
                continue
            if self.engine is not None:
                handle, tok = self.engine.add_sequence(req.prompt)
                req.sid = handle
            else:
                handle = self.make_engine()
                tok = handle.prefill(req.prompt)
            req.t_first = time.perf_counter()
            req.out.append(tok)
            self.active[req.rid] = (req, handle, tok)

    def _activate_ready(self) -> None:
        while self._ready and len(self.active) < self.cfg.max_active:
            req, sid, tok = self._ready.pop(0)
            self.active[req.rid] = (req, sid, tok)

    def _collect_admitted(self, block: bool = False) -> None:
        """Resolve async admissions (TTFT stops when the prefill future
        lands) and activate ready requests as decode slots allow.
        ``block`` waits for at least the first pending future — used when
        nothing is decoding, so the loop always makes progress."""
        still = []
        for i, (req, fut) in enumerate(self._pending):
            if fut.done() or (block and i == 0 and not self._ready):
                try:
                    sid, tok = fut.result()
                except AdmissionError as e:
                    # the admission worker failed mid-prefill: reclaim
                    # exactly that slot (drain its write-behind futures,
                    # release pool/arena holds) and fail just this request
                    self.engine.abort_admission(e.sid)
                    req.error = f"admission failed: {e.cause!r}"
                    req.t_done = time.perf_counter()
                    self._prefix_credit.pop(req.rid, None)
                    self.finished.append(req)
                    continue
                req.sid = sid
                req.t_first = time.perf_counter()
                req.out.append(tok)
                self._ready.append((req, sid, tok))
            else:
                still.append((req, fut))
        self._pending = still
        self._activate_ready()

    def _prefill_budget(self) -> int:
        """Per-round prefill token budget.  Static by default; with
        ``adaptive_prefill_budget`` it is re-derived EVERY round from the
        measured chunk-step and idle-round EWMAs through
        :func:`pipeline.chunked_admission_model`: the largest
        chunks-per-round whose predicted max round gap (idle round + k
        chunk steps) stays within ``target_stall_frac`` of an idle round —
        the stall bound then holds as batch composition (and therefore
        round time) changes, instead of trusting a static token guess."""
        cfg = self.cfg
        if not cfg.adaptive_prefill_budget:
            self._derived_budget = cfg.prefill_round_tokens
            return cfg.prefill_round_tokens
        base = self._idle_ewma if self._idle_ewma is not None \
            else self._round_ewma
        if base is None or self._chunk_ewma is None or not self._chunk_tokens:
            # no measurements yet (first admission / first rounds): fall
            # back to the configured static budget until EWMAs exist
            self._derived_budget = cfg.prefill_round_tokens
            return cfg.prefill_round_tokens
        chunk_s = max(self._chunk_ewma, 1e-9)
        k = max(1, int(cfg.target_stall_frac * base / chunk_s))
        while k > 1 and chunked_admission_model(
                chunk_s, k, base, k)["max_round_gap_chunked_s"] \
                > base * (1.0 + cfg.target_stall_frac):
            k -= 1
        self._derived_budget = k * self._chunk_tokens
        return self._derived_budget

    def _advance_chunked(self) -> None:
        """Advance in-flight chunked admissions under the per-round prefill
        token budget — decode rounds run between chunk steps, so the max
        decode stall a long prompt causes is bounded by the budget.  With
        no active decode the budget lifts (nothing to stall) but only one
        admission drains, so arrivals keep joining in order."""
        if not self._chunked:
            return
        if self.cfg.pace_admission and not self._gate_open and self.active:
            self._gated_rounds += 1
            return
        budget = self._prefill_budget() if self.active else None
        while self._chunked:
            if budget is not None and budget <= 0:
                break
            req, adm = self._chunked[0]
            t0 = time.perf_counter()
            did = adm.step()
            if did:
                dt = time.perf_counter() - t0
                self._chunk_steps += 1
                if self._chunk_steps > 1:      # step 1 is the jit compile
                    a = self.cfg.ewma_alpha
                    self._chunk_ewma = dt if self._chunk_ewma is None else \
                        (1 - a) * self._chunk_ewma + a * dt
                # full chunk size (the final chunk of a prompt is shorter)
                self._chunk_tokens = max(self._chunk_tokens or 0, did)
            if budget is not None:
                budget -= did
            if adm.done:
                self._chunked.pop(0)
                sid, tok = adm.result
                req.sid = sid
                req.t_first = time.perf_counter()
                req.out.append(tok)
                self._ready.append((req, sid, tok))
                if budget is None:
                    break              # drained one admission; that's
                                       # enough progress for an idle loop
        self._activate_ready()

    def _note_round(self, dt: float, admission_active: bool) -> None:
        """Feed one decode round's wall time into the pacing EWMAs and
        update the gate: rounds with no admission in flight refresh the
        idle baseline; the gate closes while the running EWMA exceeds the
        baseline by more than ``max_round_inflation``."""
        a = self.cfg.ewma_alpha
        self._round_ewma = dt if self._round_ewma is None else \
            (1 - a) * self._round_ewma + a * dt
        if not admission_active:
            self._idle_ewma = dt if self._idle_ewma is None else \
                (1 - a) * self._idle_ewma + a * dt
        if self.cfg.pace_admission:
            if self._idle_ewma is None:
                self._gate_open = True
            else:
                self._gate_open = (
                    self._round_ewma
                    <= self._idle_ewma * (1.0 + self.cfg.max_round_inflation))

    # ------------------------------------------------------------------
    # Overload control: watermark policy, preemption, shedding
    # ------------------------------------------------------------------
    def _eff_priority(self, req: Request, now: float) -> float:
        """Effective scheduling class: the static priority plus one class
        per ``aging_s`` seconds spent suspended — the anti-starvation
        clock that guarantees every preempted request eventually
        out-ranks a sustained-yellow victim and swaps back in."""
        if req.t_suspend is None or self.cfg.aging_s <= 0:
            return float(req.priority)
        return req.priority + (now - req.t_suspend) / self.cfg.aging_s

    def _victim_rid(self) -> Optional[int]:
        """Preemption victim among active requests: lowest priority class
        first, longest remaining decode (max_new - produced) as the
        tie-break — the request whose eviction frees capacity for the
        longest time at the smallest class cost."""
        if not self.active:
            return None
        return min(self.active,
                   key=lambda rid: (self.active[rid][0].priority,
                                    -(self.active[rid][0].max_new
                                      - len(self.active[rid][0].out))))

    def _suspend(self, rid: int) -> None:
        """Preempt one active request: the engine swaps its whole working
        set down-tier (slot retained), the request parks in
        ``_suspended`` and its deadline clock stops."""
        req, sid, tok = self.active.pop(rid)
        self.engine.suspend_sequence(sid)
        req.t_suspend = time.perf_counter()
        self._suspended[rid] = (req, sid, tok)
        self._suspensions += 1

    def _resume(self, rid: int) -> None:
        """Un-park one suspended request: re-stage its working set and
        restart its deadline clock; it rejoins the next decode round."""
        req, sid, tok = self._suspended.pop(rid)
        self.engine.resume_sequence(sid)
        req.suspended_s += time.perf_counter() - req.t_suspend
        req.t_suspend = None
        self.active[rid] = (req, sid, tok)
        self._resumes += 1

    def _shed_queue(self, reasons) -> None:
        """Red pressure: shed queued requests — lowest priority class
        first, newest arrival first within a class — down to the
        monitor's yellow queue watermark, each with a structured
        :class:`RejectedOverload` terminal result."""
        floor = getattr(getattr(self.monitor, "cfg", None),
                        "queue_yellow", 0)
        while len(self.queue) > max(0, floor):
            victim = min(self.queue,
                         key=lambda r: (r.priority, -r.t_submit))
            try:
                self.queue.remove(victim)
            except ValueError:
                break                  # raced a producer; try next round
            exc = RejectedOverload(victim.rid, tuple(sorted(reasons)))
            victim.rejected_overload = exc
            victim.error = str(exc)
            victim.t_done = time.perf_counter()
            self.rejected.append(victim)
            self._requests_rejected += 1

    def _apply_pressure(self) -> None:
        """One watermark-policy step (runs at the top of every round):

        * **green** — resume suspended requests (highest effective class
          first) into free decode seats before fresh admissions backfill.
        * **yellow from queue depth only** — capacity is fine but demand
          is piling up: priority preemption.  While the best queued
          request strictly out-ranks the weakest active victim and no
          seat is free, suspend the victim and move that request to the
          queue head; admission stays open so it backfills immediately.
        * **yellow from resources** (pool/host/disk) — pause admission
          and suspend the weakest victim (keeping at least one active)
          so the tier store stops thrashing.
        * **red** — shed the queue down to the yellow watermark with
          structured ``RejectedOverload`` results, plus the yellow
          actions.

        Anti-starvation: under sustained yellow a suspended request's
        effective class grows (``aging_s``); once it out-ranks the
        weakest active victim by a full class it swaps back in.  And
        whenever nothing is active or mid-admission, one suspended
        request force-resumes regardless of pressure — the loop always
        makes progress (no-starvation half of I7)."""
        if self.monitor is None:
            return
        state, reasons = self.monitor.sample(len(self.queue))
        self._pressure_state = state
        self._pressure_rounds[state] = \
            self._pressure_rounds.get(state, 0) + 1
        now = time.perf_counter()
        resource = bool(set(reasons) - {"queue"})
        self._admission_paused = state == _RED or (state == _YELLOW
                                                   and resource)
        if state == _RED:
            self._shed_queue(reasons)
        if state == _GREEN:
            while self._suspended and len(self.active) < self.cfg.max_active:
                rid = max(self._suspended,
                          key=lambda r: self._eff_priority(
                              self._suspended[r][0], now))
                self._resume(rid)
        elif resource:
            # resource pressure: drain the batch one victim per round,
            # never below a single active sequence (forward progress)
            if len(self.active) > 1:
                victim = self._victim_rid()
                if victim is not None:
                    self._suspend(victim)
        elif self.queue:
            # queue-only yellow: priority preemption.  Suspending frees a
            # decode seat (not an engine slot), so it only helps when
            # seats are the constraint and a slot exists for the admit.
            while (self.queue and self.active
                   and len(self.active) >= self.cfg.max_active
                   and self.engine.free_slots > 0):
                best = max(self.queue,
                           key=lambda r: (r.priority, -r.t_submit))
                victim = self._victim_rid()
                if victim is None or \
                        best.priority <= self.active[victim][0].priority:
                    break
                self._suspend(victim)
                try:
                    self.queue.remove(best)
                    self.queue.appendleft(best)
                except ValueError:
                    pass               # raced a producer; order stands
        if state == _YELLOW and self._suspended and self.active \
                and self.cfg.aging_s > 0:
            # aged swap: the most-starved suspended request trades places
            # with the weakest victim once a full class ahead of it
            rid_s = max(self._suspended,
                        key=lambda r: self._eff_priority(
                            self._suspended[r][0], now))
            victim = self._victim_rid()
            if victim is not None and \
                    self._eff_priority(self._suspended[rid_s][0], now) \
                    > self.active[victim][0].priority + 1.0:
                self._suspend(victim)
                self._resume(rid_s)
        if self._suspended and not self.active and not self._pending \
                and not self._ready and not self._chunked \
                and (not self.queue or self._admission_paused):
            # termination safety: nothing else can make progress — an
            # open queue is about to backfill via _admit, but with it
            # empty (or admission paused) one suspended request resumes
            # even under red pressure, so the loop never stalls
            rid = max(self._suspended,
                      key=lambda r: self._eff_priority(
                          self._suspended[r][0], now))
            self._resume(rid)

    def _cancel(self, req: Request, reason: str) -> None:
        """Terminal cancellation bookkeeping shared by every deadline
        path — the caller has already released whatever the request
        held."""
        req.error = reason
        req.t_done = time.perf_counter()
        self._prefix_credit.pop(req.rid, None)
        self.finished.append(req)
        self._requests_cancelled += 1

    def _sweep_deadlines(self) -> None:
        """Cancel every expired request at whatever lifecycle stage it
        reached: queued requests just drop; mid-admission requests drain
        their ingest/prefetch futures and release pool slots + prefix-
        arena refcounts (``abort_admission`` / ``ChunkedAdmission.cancel``
        — I1–I5 hold throughout); active/ready ones release normally.  A
        pending async admission is only reclaimed once its future has
        resolved — the slot is worker-owned until then (checked again
        next round)."""
        if not any(r.expired for r in
                   list(self.queue)
                   + [r for r, *_ in self._pending + self._ready
                      + self._chunked]
                   + [r for r, _, _ in self.active.values()]
                   + [r for r, _, _ in self._suspended.values()]):
            return
        for r in list(self.queue):      # remove in place: submit() may be
            if r.expired:               # appending from another thread
                try:
                    self.queue.remove(r)
                except ValueError:
                    continue
                self._cancel(r, "deadline expired while queued")
        still_p = []
        for req, fut in self._pending:
            if req.expired and fut.done():
                try:
                    sid, _tok = fut.result()
                    self.engine.release(sid)
                except AdmissionError as e:
                    self.engine.abort_admission(e.sid)
                self._cancel(req, "deadline expired during admission")
            else:
                still_p.append((req, fut))
        self._pending = still_p
        still_r = []
        for req, sid, tok in self._ready:
            if req.expired:
                self.engine.release(sid)
                self._cancel(req, "deadline expired before first round")
            else:
                still_r.append((req, sid, tok))
        self._ready = still_r
        still_c = []
        for req, adm in self._chunked:
            if req.expired:
                adm.cancel()
                self._cancel(req, "deadline expired mid-admission")
            else:
                still_c.append((req, adm))
        self._chunked = still_c
        for rid in [rid for rid, (req, _, _) in self.active.items()
                    if req.expired]:
            req, handle, _ = self.active.pop(rid)
            if self.engine is not None:
                self.engine.release(handle)
            elif hasattr(handle, "store") and handle.store is not None:
                handle.store.close()
            self._cancel(req, "deadline expired while decoding")
        # a suspended request's deadline clock is paused (paused_s), so
        # this only fires when the budget was already spent pre-suspend;
        # engine.release also un-parks the suspended slot
        for rid in [rid for rid, (req, _, _) in self._suspended.items()
                    if req.expired]:
            req, sid, _ = self._suspended.pop(rid)
            req.suspended_s += time.perf_counter() - req.t_suspend
            req.t_suspend = None
            self.engine.release(sid)
            self._cancel(req, "deadline expired while preempted")

    def _retire(self, rids: List[int]) -> None:
        store = getattr(self.engine, "store", None) \
            if self.engine is not None else None
        for rid in rids:
            req, handle, _ = self.active.pop(rid)
            req.t_done = time.perf_counter()
            self._prefix_credit.pop(rid, None)
            # degraded-numerics flag must be read BEFORE release: the
            # store clears per-slot fault state when the slot recycles
            if store is not None and hasattr(store, "degraded_seqs"):
                req.degraded = handle in store.degraded_seqs
            self.finished.append(req)
            if self.engine is not None:
                self.engine.release(handle)
            elif hasattr(handle, "store") and handle.store is not None:
                handle.store.close()

    @property
    def pending_work(self) -> bool:
        """True while any request is queued, decoding, or mid-admission —
        the loop condition :meth:`run` uses (public, so external drivers
        don't reach into the admission queues)."""
        return bool(self.queue or self.active or self._pending
                    or self._ready or self._chunked or self._suspended)

    @decode_thread_only
    def step(self) -> int:
        """One decode round over all active requests; returns #active."""
        with span("leoam.step"):
            self._sweep_deadlines()
            self._apply_pressure()
            self._admit()
            self._collect_admitted(
                block=not self.active and bool(self._pending))
            retired = [rid for rid, (req, _, _) in self.active.items()
                       if req.done]
            live = {rid: v for rid, v in self.active.items()
                    if rid not in retired}
            admission_active = bool(self._pending) or bool(self._chunked)
            if self.engine is not None and live:
                # ONE batched decode round for every live sequence; async
                # admissions prefill underneath it on the admission worker
                t0 = time.perf_counter()
                toks = self.engine.decode_round(
                    {sid: tok for (_, sid, tok) in live.values()})
                self._note_round(time.perf_counter() - t0, admission_active)
                for rid, (req, sid, _) in live.items():
                    if sid not in toks:
                        # the engine contained this sequence's failure
                        # (fail_sequence already drained and recycled
                        # the slot — releasing again would double-free);
                        # surface the terminal state on just this request
                        req.error = self.engine.failed.pop(
                            sid, "sequence failed")
                        req.t_done = time.perf_counter()
                        self._prefix_credit.pop(rid, None)
                        self.active.pop(rid)
                        self.finished.append(req)
                        continue
                    tok = toks[sid]
                    req.out.append(tok)
                    self.active[rid] = (req, sid, tok)
                    if req.done:
                        retired.append(rid)
            else:
                for rid, (req, eng, tok) in list(live.items()):
                    tok = eng.decode_step(tok)
                    req.out.append(tok)
                    self.active[rid] = (req, eng, tok)
                    if req.done:
                        retired.append(rid)
            self._retire(retired)
            # chunked admissions advance HERE, between decode rounds, under
            # the per-round prefill token budget
            self._advance_chunked()
            self._admit()
            self._collect_admitted(
                block=not self.active and bool(self._pending))
            return len(self.active)

    def run(self, max_rounds: int = 10_000) -> List[Request]:
        rounds = 0
        while self.pending_work and rounds < max_rounds:
            self.step()
            rounds += 1
        return self.finished

    def stats(self) -> Dict[str, float]:
        """Fleet metrics over finished requests: p50/p95 TTFT and
        per-request decode tok/s alongside the means.  Requests may finish
        out of submit order (continuous batching retires early finishers
        first), so the makespan is guarded to stay positive and every
        per-request rate divides by a clamped span."""
        pacing = {"admission_gate_open": float(self._gate_open),
                  "gated_rounds": float(self._gated_rounds)}
        if self._round_ewma is not None:
            pacing["round_ewma_s"] = float(self._round_ewma)
        if self._idle_ewma is not None:
            pacing["idle_round_ewma_s"] = float(self._idle_ewma)
        # the per-round prefill budget actually in force (static, or the
        # last adaptively derived figure) + the chunk-step EWMA behind it
        if self._derived_budget is not None:
            pacing["prefill_round_tokens"] = float(self._derived_budget)
        if self._chunk_ewma is not None:
            pacing["chunk_step_ewma_s"] = float(self._chunk_ewma)
        store = getattr(self.engine, "store", None)
        if store is not None and hasattr(store, "prefix_stats"):
            pacing.update(store.prefix_stats())
        if self.engine is not None and hasattr(self.engine, "fault_stats"):
            pacing.update(self.engine.fault_stats())
        pacing["requests_cancelled"] = float(self._requests_cancelled)
        pacing["requests_rejected"] = float(self._requests_rejected)
        # terminal accounting: every submitted request must land in
        # exactly one of {completed, shed, failed}; at quiescence
        # (pending_work False) unaccounted is ZERO — the overload bench
        # gates on it
        completed = sum(1 for r in self.finished if r.error is None)
        failed = sum(1 for r in self.finished if r.error is not None)
        shed = len(self.rejected)
        pacing["requests_submitted"] = float(self._requests_submitted)
        pacing["requests_completed"] = float(completed)
        pacing["requests_failed"] = float(failed)
        pacing["requests_shed"] = float(shed)
        pacing["requests_unaccounted"] = float(
            self._requests_submitted - completed - failed - shed)
        # overload-control observability (stats() is Dict[str, float]:
        # the state exports as its watermark level, 0/1/2)
        pacing["pressure_level"] = float(
            {_GREEN: 0, _YELLOW: 1, _RED: 2}.get(self._pressure_state, 0))
        for st, n in self._pressure_rounds.items():
            pacing[f"pressure_rounds_{st}"] = float(n)
        pacing["suspensions"] = float(self._suspensions)
        pacing["resumes"] = float(self._resumes)
        pacing["suspended_now"] = float(len(self._suspended))
        waited = np.array([r.t_admit - r.t_submit for r in self.finished
                           if r.t_admit is not None])
        if len(waited):
            pacing["p50_queue_wait_s"] = float(np.percentile(waited, 50))
            pacing["p95_queue_wait_s"] = float(np.percentile(waited, 95))
            pacing["p99_queue_wait_s"] = float(np.percentile(waited, 99))
        done = [r for r in self.finished
                if r.t_first is not None and r.t_done is not None]
        if not done:
            return pacing
        ttft = np.array([r.t_first - r.t_submit for r in done])
        lat = np.array([r.t_done - r.t_submit for r in done])
        # per-request decode rate: tokens after the first, over the decode
        # span (first-token to done); 1-token requests never decoded
        dec = np.array([(len(r.out) - 1) / max(r.t_done - r.t_first, 1e-9)
                        for r in done if len(r.out) > 1])
        toks = sum(len(r.out) for r in done)
        span = max(max(r.t_done for r in done)
                   - min(r.t_submit for r in done), 1e-9)
        out = {**pacing,
               "requests": len(done),
               "mean_ttft_s": float(ttft.mean()),
               "p50_ttft_s": float(np.percentile(ttft, 50)),
               "p95_ttft_s": float(np.percentile(ttft, 95)),
               "p99_ttft_s": float(np.percentile(ttft, 99)),
               "mean_latency_s": float(lat.mean()),
               "p95_latency_s": float(np.percentile(lat, 95)),
               "p99_latency_s": float(np.percentile(lat, 99)),
               "throughput_tok_s": toks / span}
        if len(dec):
            out.update({"mean_decode_tok_s": float(dec.mean()),
                        "p50_decode_tok_s": float(np.percentile(dec, 50)),
                        "p95_decode_tok_s": float(np.percentile(dec, 95)),
                        "p05_decode_tok_s": float(np.percentile(dec, 5))})
        return out
