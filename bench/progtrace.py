"""Reading the program's own spans in a ``--trace 1`` run (kineto events).

The program opens ``leoam.*`` host ranges (``torch.profiler.
record_function``, only while a profiler runs) around the parts of its
decode round, its admission and its tier store.  From the traced
stretch's raw events this yields:

* ``idle_gaps``: the device's idle gaps by the innermost ``leoam.*`` span
  of the decode thread (the thread that ran ``leoam.round``) open at each
  gap's midpoint, or ``outside leoam spans``; the device's busy intervals
  are ``bench.devtrace``'s (kernels, copies and fills, not the host
  ranges' mirrors);
* ``round_launches``: for each complete ``leoam.round``, the CUDA runtime
  calls that launch a kernel or queue a copy or fill (``cudaLaunchKernel*``,
  ``cuLaunchKernel*``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``) made on
  the round's thread inside it.  A round cut by the trace's end ends when
  the trace stops, after every event's start; a complete one ends before
  some later event starts.

A program without these spans yields its gaps all outside them and no
round.

The benchmark's own line does not carry these readings; one traced run
of a cell with them added under ``program``:

    python3 bench/progtrace.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import bisect  # noqa: E402
import heapq  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import devtrace, harness  # noqa: E402
from bench.devtrace import _merge, _ns  # noqa: E402

PREFIX = "leoam."
OUTSIDE = "outside leoam spans"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
QUEUED = ("cudaMemcpyAsync", "cudaMemsetAsync")

# (name, thread, start ns, end ns)
Event = Tuple[str, int, float, float]


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a finished ``torch.profiler``
    session, with each event's thread."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        t0 = _ns(e, "start")
        ev = (e.name(), e.start_thread_id(), t0, t0 + _ns(e, "duration"))
        (dev if e.device_type() == cuda else host).append(ev)
    return dev, host


def analyze(dev: List[Event], host: List[Event]) -> Dict:
    """``idle_gaps`` ([[span, s], ...], most first), ``idle_s`` and
    ``round_launches`` (one count per complete round, in order)."""
    names = {n for n, _, _, _ in host}
    busy = _merge([(a, b) for n, _, a, b in dev
                   if n not in names and not n.startswith("bench.")])
    rounds = sorted((a, b, t) for n, t, a, b in host
                    if n == PREFIX + "round")
    threads = {t for _, _, t in rounds}
    spans = sorted((a, b, n) for n, t, a, b in host
                   if n.startswith(PREFIX) and (not threads or t in threads))
    gaps: Dict[str, float] = defaultdict(float)
    active: List[Tuple[float, float, str]] = []   # (-start, end, name)
    i = 0
    # the innermost span holding a gap's midpoint is the one that started
    # last among those still open there (the midpoints come in order)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        while i < len(spans) and spans[i][0] <= mid:
            heapq.heappush(active, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        gaps[active[0][2] if active else OUTSIDE] += (s1 - e0) * 1e-9
    horizon = max((a for _, _, a, _ in dev + host), default=0.0)
    launches: Dict[int, List[float]] = defaultdict(list)
    for n, t, a, _ in host:
        if n.startswith(LAUNCHES) or n in QUEUED:
            launches[t].append(a)
    for starts in launches.values():
        starts.sort()
    per_round = [bisect.bisect_right(launches[t], r1)
                 - bisect.bisect_left(launches[t], r0)
                 for r0, r1, t in rounds if r1 < horizon]
    return {"idle_gaps": [[n, s] for n, s in
                          sorted(gaps.items(), key=lambda kv: -kv[1])],
            "idle_s": sum(gaps.values()), "round_launches": per_round}


def read(prof) -> Dict:
    """:func:`analyze` over a finished session's events."""
    return analyze(*events(prof))


def traced_run(workload: str, seed: int, seconds: float,
               **kw) -> Dict:
    """``harness.run`` with ``trace`` on; its result line gains
    ``program``, :func:`read` over the session it traced (None where it
    traced none, as off a CUDA device)."""
    sessions = []
    stop = devtrace.stop

    def keep(prof):
        sessions.append(prof)
        return stop(prof)

    devtrace.stop = keep
    try:
        res = harness.run(workload, seed, seconds, True, **kw)["result"]
    finally:
        devtrace.stop = stop
    res["program"] = read(sessions[-1]) if sessions else None
    return res


def main(argv: List[str], t_process: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_env()
    import torch
    if not torch.cuda.is_available():
        print("error: a traced run needs a CUDA device", file=sys.stderr)
        return 2
    res = traced_run(args.workload, args.seed, args.seconds,
                     t_process=t_process)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
