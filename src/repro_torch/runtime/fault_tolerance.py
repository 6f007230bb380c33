"""Fault-tolerant training loop: retry-with-restore, straggler telemetry
(copied from ``repro.runtime.fault_tolerance``, framework-free).

``run_with_restarts`` wraps a step loop so transient worker failures restart
from the latest checkpoint instead of killing the job — the behaviour a
1000-node deployment needs from its controller.  Failure injection hooks are
exercised by tests/test_torch_train_step.py.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger("repro_torch.runtime")


@dataclass
class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than ``threshold``x EMA.

    On a real pod this feeds the controller's slow-host eviction; here it is
    the telemetry layer (per-step timing is also what §Perf iterations read).
    """
    alpha: float = 0.1
    threshold: float = 2.0
    ema: Optional[float] = None
    flagged: List[Tuple[int, float]] = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if slow:
            self.flagged.append((step, dt))
            log.warning("straggler step %d: %.3fs (ema %.3fs)", step, dt, self.ema)
        return slow


@dataclass
class RestartStats:
    restarts: int = 0
    failed_steps: List[int] = field(default_factory=list)


def run_with_restarts(step_fn: Callable[[int, Any], Any], state: Any, *,
                      n_steps: int, checkpointer, save_every: int,
                      restore_fn: Callable[[Any], Tuple[Any, int]],
                      max_restarts: int = 3,
                      monitor: Optional[StragglerMonitor] = None,
                      start_step: int = 0) -> Tuple[Any, RestartStats]:
    """Run ``step_fn(step, state) -> state`` with checkpoint/restart.

    On an exception the state is rolled back to the latest checkpoint via
    ``restore_fn`` and execution resumes from that step.  ``step_fn`` owns
    the device work; everything here is host control flow.
    """
    stats = RestartStats()
    step = start_step
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(step, state)
            dt = time.perf_counter() - t0
            if monitor is not None:
                monitor.record(step, dt)
            step += 1
            if save_every and step % save_every == 0:
                checkpointer.save(step, state)
        except Exception as e:  # noqa: BLE001 — controller-level catch
            stats.restarts += 1
            stats.failed_steps.append(step)
            if stats.restarts > max_restarts:
                log.error("exceeded max_restarts=%d; giving up", max_restarts)
                raise
            log.warning("step %d failed (%s); restoring latest checkpoint",
                        step, type(e).__name__)
            checkpointer.wait()
            state, restored_step = restore_fn(state)
            step = restored_step
    checkpointer.wait()
    return state, stats
