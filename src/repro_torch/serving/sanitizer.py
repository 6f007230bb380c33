"""Runtime sync-sanitizer + thread-ownership markers for the tiered engine.

The serving stack's concurrency contracts (docstrings in ``engine.py`` /
``offload.py``, catalogued in ``docs/INVARIANTS.md``) are enforced twice:

* statically by ``python -m repro_torch.analysis`` (the ``leolint``
  passes, with PyTorch's host-device sync points, read the ownership
  decorators below straight off the AST and walk the call graph from
  every executor entry point);
* dynamically by this module when ``EngineCfg(debug_sync=True)`` — the
  decorators become live owning-thread assertions, store/pool mutating
  entry points get a concurrent-mutation (epoch) guard, and the store's
  locks are wrapped in :class:`TrackedLock`, which records the lock
  acquisition graph per thread and fails on the first cycle instead of
  leaving a latent ABBA deadlock for production traffic to find.

Ownership classes (strict to permissive):

* ``@decode_thread_only`` — must never execute on a worker thread (the
  DTP prefetch / admission / requant executors, thread names
  ``leoam-*``).  These functions mutate state the decode thread reads
  WITHOUT the store lock (the device pool slab, the engine's slot
  free-list), so a worker calling one is a data race even if it happens
  to win today.
* ``@worker_thread`` — runs on executor workers (and inline on the decode
  thread in the serial modes).  May call ``@worker_thread`` /
  ``@any_thread`` code; a reachable call into ``@decode_thread_only``
  code is rejected by the static pass and (via the thread-name check) at
  runtime.
* ``@any_thread`` — safe from every thread; every touched structure is
  lock-protected.

All checks compile to a single integer compare when the sanitizer is
disabled (the default), so decorated hot-path functions cost one ``if``
per call.  ``benchmarks/run.py`` refuses to produce measured numbers with
the sanitizer live; its overhead is recorded by the fig13 bench instead.
"""

from __future__ import annotations

import os
import threading
from functools import wraps
from typing import Dict, List, Optional, Set, Tuple

DECODE_THREAD_ONLY = "decode_thread_only"
WORKER_THREAD = "worker_thread"
ANY_THREAD = "any_thread"

#: thread-name prefix shared by every serving executor (DTP prefetch,
#: admission, write-behind ingest, requant) — the runtime worker test.
WORKER_PREFIX = "leoam-"

OWNERSHIP_ATTR = "__leolint_ownership__"


class SyncViolation(AssertionError):
    """A concurrency contract was broken under ``debug_sync=True``."""


# ----------------------------------------------------------------------
# Activation (refcounted: every debug_sync store/engine enables on build
# and disables on close, so overlapping debug engines compose)
# ----------------------------------------------------------------------
_enabled = 0
_state_lock = threading.Lock()


def enable() -> None:
    global _enabled
    with _state_lock:
        _enabled += 1


def disable() -> None:
    global _enabled
    with _state_lock:
        _enabled = max(0, _enabled - 1)


def active() -> bool:
    """True while at least one ``debug_sync`` store/engine is live (or the
    ``REPRO_DEBUG_SYNC`` escape hatch is set)."""
    return _enabled > 0 or bool(int(os.environ.get("REPRO_DEBUG_SYNC", "0")))


class _TLS(threading.local):
    def __init__(self):
        self.held: List[str] = []        # TrackedLock names, outermost first
        self.registered_worker = False


_tls = _TLS()


def register_worker_thread() -> None:
    """Mark the CURRENT thread as a worker for the sanitizer — for test
    doubles / external executors whose threads are not named ``leoam-*``."""
    _tls.registered_worker = True


def _is_worker_thread() -> bool:
    return (_tls.registered_worker
            or threading.current_thread().name.startswith(WORKER_PREFIX))


# ----------------------------------------------------------------------
# Concurrent-mutation (epoch) guard
# ----------------------------------------------------------------------
# per-object mutation bookkeeping: id(obj) -> [owner thread ident, depth,
# epoch].  The decode-thread-only mutators are NOT lock-protected (that is
# the point of the ownership contract), so two threads interleaving inside
# one is a real race — the guard turns the interleaving into a hard error
# with both thread names in the message instead of silent corruption.
_mut: Dict[int, List] = {}
_mut_lock = threading.Lock()


def _mutation_enter(obj, fname: str) -> None:
    me = threading.get_ident()
    name = threading.current_thread().name
    with _mut_lock:
        ent = _mut.get(id(obj))
        if ent is None:
            _mut[id(obj)] = [me, 1, 0, name]
        elif ent[0] == me:
            ent[1] += 1
        else:
            raise SyncViolation(
                f"concurrent mutation: {type(obj).__name__}.{fname} entered "
                f"on thread '{name}' while thread '{ent[3]}' is still inside "
                f"a decode-thread-only mutator of the same object (epoch "
                f"{ent[2]}) — the decode thread must stay the sole mutator")


def _mutation_exit(obj) -> None:
    with _mut_lock:
        ent = _mut.get(id(obj))
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] <= 0:
            ent[2] += 1
            if ent[2] > 1 << 30:       # bounded bookkeeping on long runs
                ent[2] = 0
            ent[0] = None
            del _mut[id(obj)]


# ----------------------------------------------------------------------
# Ownership decorators
# ----------------------------------------------------------------------
def _mark(fn, ownership: str):
    setattr(fn, OWNERSHIP_ATTR, ownership)
    return fn


def decode_thread_only(fn):
    """The function mutates (or publishes) state the decode thread reads
    without the store lock; only the decode thread may run it.  Under
    ``debug_sync`` a call from a worker thread raises
    :class:`SyncViolation`, and concurrent entry from two threads trips
    the epoch guard even when neither is a named worker."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        if _enabled:
            if _is_worker_thread():
                raise SyncViolation(
                    f"{fn.__qualname__} is decode-thread-only but ran on "
                    f"worker thread "
                    f"'{threading.current_thread().name}' — route this "
                    f"mutation through the decode thread (pending_place / "
                    f"deferred-fold pattern)")
            if args and not isinstance(args[0], (int, float, str, bytes)):
                _mutation_enter(args[0], fn.__name__)
                try:
                    return fn(*args, **kwargs)
                finally:
                    _mutation_exit(args[0])
        return fn(*args, **kwargs)

    return _mark(wrapper, DECODE_THREAD_ONLY)


def worker_thread(fn):
    """The function is an executor work item (or runs inline in the serial
    modes).  Marker for the static pass; runtime cost is one compare."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return _mark(wrapper, WORKER_THREAD)


def any_thread(fn):
    """Explicitly safe from every thread (all touched state is
    lock-protected).  Marker for the static pass."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return _mark(wrapper, ANY_THREAD)


# ----------------------------------------------------------------------
# Lock-order tracker
# ----------------------------------------------------------------------
class LockOrderTracker:
    """Directed lock-acquisition graph shared by every :class:`TrackedLock`.

    Each first acquisition of lock B while holding lock A records the edge
    A→B; an acquisition that would close a cycle (a path B→…→A already
    exists) raises immediately — the two call sites jointly form an ABBA
    deadlock waiting for the right schedule."""

    def __init__(self):
        self._edges: Dict[str, Set[str]] = {}
        self._lock = threading.Lock()

    def _path(self, src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    def on_acquire(self, name: str, held: List[str]) -> None:
        with self._lock:
            for h in held:
                if h == name:
                    continue
                if name not in self._edges.setdefault(h, set()):
                    if self._path(name, h):
                        raise SyncViolation(
                            f"lock-order cycle: acquiring '{name}' while "
                            f"holding '{h}', but the reverse order "
                            f"'{name}'->…->'{h}' was already recorded — "
                            f"these call sites can deadlock")
                    self._edges[h].add(name)

    def edges(self) -> Dict[str, Set[str]]:
        with self._lock:
            return {k: set(v) for k, v in self._edges.items()}


_TRACKER = LockOrderTracker()


class TrackedLock:
    """Context-manager wrapper over a ``threading`` lock that feeds the
    process-wide :class:`LockOrderTracker` and the per-thread held-lock
    stack.  API-compatible with the wrapped lock for ``with`` use."""

    def __init__(self, lock, name: str, tracker: LockOrderTracker = None):
        self._lock = lock
        self.name = name
        self._tracker = tracker or _TRACKER

    def acquire(self, *a, **kw):
        # record BEFORE blocking: a would-deadlock acquisition must raise
        # rather than hang the sanitized run
        self._tracker.on_acquire(self.name, _tls.held)
        ok = self._lock.acquire(*a, **kw)
        if ok:
            _tls.held.append(self.name)
        return ok

    def release(self):
        self._lock.release()
        for i in range(len(_tls.held) - 1, -1, -1):
            if _tls.held[i] == self.name:
                del _tls.held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def held_locks() -> Tuple[str, ...]:
    """The current thread's tracked-lock stack (diagnostics / tests)."""
    return tuple(_tls.held)


def lock_order_edges() -> Dict[str, Set[str]]:
    """The recorded acquisition graph (diagnostics / tests)."""
    return _TRACKER.edges()
