"""Profiler ranges and the store lock's wait clock for the serving path.

``span("leoam.<part>")`` is ``torch.profiler.record_function`` while a
``torch.profiler`` session is active, and one shared no-op context
otherwise: the check is a single read of the profiler's process-wide
flag, and a site with no session allocates nothing and opens no range.
The ranges land in the session's kineto trace beside the device's kernels
and copies, so each idle gap of the device can be put down to the
innermost program span around it.  A range opened on a worker thread is
recorded only by a session that profiles every thread
(``_ExperimentalConfig(profile_all_threads=True)``); one that profiles
the thread that started it sees the decode thread's ranges alone.

The spans, by where they open (the ``round_profiles`` key each one times
beside it, where there is one):

* scheduler: ``leoam.step`` (``ContinuousBatcher.step``);
* decode round: ``leoam.round``; per attention layer ``leoam.dense``
  (``dense_s``), ``leoam.evaluate`` (``eval_s``) around
  ``leoam.eval_wait``, ``leoam.eval_read``, ``leoam.eval_bounds`` and
  ``leoam.eval_select`` (``eval_*_s``), ``leoam.fetch`` around
  ``leoam.gather`` and ``leoam.upload`` (``gather_s``, ``upload_s``),
  ``leoam.append`` around ``leoam.append_copy`` and
  ``leoam.append_store`` (``append_*_s``); then ``leoam.logits``
  (``logits_s``);
* admission: ``leoam.admit`` around ``leoam.prefill`` and
  ``leoam.ingest``, inside which the store's ``leoam.ingest_cast`` (the
  cast, pad and stack under the store lock);
* worker threads: ``leoam.prefetch`` (the next layer's abstract reads and
  disk staging) and ``leoam.ingest_cold`` around ``leoam.crc`` and
  ``leoam.write``.

:class:`Laps` adds consecutive stretches of the host clock to a
profile's keys; :class:`WaitTimedLock` times how long threads other than
the serving workers were blocked taking a lock (``round_profiles``'
``lock_wait_s``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from repro_torch.serving.sanitizer import WORKER_PREFIX

_OFF = contextlib.nullcontext()


def active() -> bool:
    """True while a ``torch.profiler`` session runs in this process."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A profiler range named ``name`` while a session is active, else a
    shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class Laps:
    """Consecutive stretches of the host clock (``time.perf_counter``):
    :meth:`lap` ends the running stretch, adds it to ``prof[key]`` (or to
    nothing, with no key) and starts the next one, so the parts of a
    round share their end points."""

    __slots__ = ("prof", "t")

    def __init__(self, prof):
        self.prof = prof
        self.t = time.perf_counter()

    def lap(self, key=None) -> float:
        """End the running stretch; returns the clock's reading."""
        t = time.perf_counter()
        if key is not None:
            self.prof[key] += t - self.t
        self.t = t
        return t


class WaitTimedLock:
    """A lock that adds up, in ``wait_s``, the seconds threads other than
    the serving workers (``leoam-*``) spent blocked acquiring it.

    The first try does not block; the blocking acquire is timed only when
    that try fails, so an uncontended acquire reads no clock.  It wraps
    any lock with ``acquire(blocking, timeout)`` and ``release()``, and
    the sanitizer's ``TrackedLock`` wraps it in turn."""

    def __init__(self, lock):
        self._lock = lock
        self.wait_s = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(True, timeout)
        if not threading.current_thread().name.startswith(WORKER_PREFIX):
            self.wait_s += time.perf_counter() - t0
        return ok

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False
