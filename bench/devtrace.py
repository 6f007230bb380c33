"""Reading the device trace of a ``--trace 1`` run (``torch.profiler``).

The profiler traces a fixed stretch at the start of the window.  Its raw
events (kineto) are read directly, without building the profiler's event
tree: every CUDA-side event (kernels, copies, fills) gives the device's
busy intervals and the time of each kernel by name; the benchmark's own
``bench.*`` host spans (``torch.profiler.record_function`` around the
calls into each layer) name what the host was doing in the device's idle
gaps.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

KERNELS = {
    "b1": ("chunk_bounds_kernel",),
    "b2": ("sd_scores_kernel", "sd_pv_kernel"),
    "b1_latent": ("chunk_bounds_latent_kernel",),
    "b2_latent": ("lat_scores_kernel", "lat_pv_kernel"),
}


def start() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def stop(prof: torch.profiler.profile) -> float:
    """Stop tracing once the device has drained; returns the host time
    at which the traced window ended."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    prof.__exit__(None, None, None)
    return t


def _ns(e, what: str) -> float:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, f"{what}_us")()) * 1e3


def _raw(prof) -> Tuple[List[Tuple[str, float, float]],
                        List[Tuple[str, float, float]]]:
    """(device events, host events) as (name, start ns, end ns).  The
    host's ``record_function`` ranges are mirrored on the device's
    timeline as annotations; they are host spans, not device work."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        t0 = _ns(e, "start")
        t1 = t0 + _ns(e, "duration")
        (dev if e.device_type() == cuda else host).append((e.name(), t0, t1))
    names = {n for n, _, _ in host}
    dev = [x for x in dev if x[0] not in names
           and not x[0].startswith("bench.")]
    return dev, host


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def analyze(prof, window_s: float) -> Dict:
    """busy_s, per-kernel-family device seconds, the top device ops and
    the idle gaps by the host span they fall in."""
    dev, host = _raw(prof)
    busy = _merge([(a, b) for _, a, b in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in dev:
        by_name[name] += (b - a) * 1e-9
    families = {fam: sum(s for n, s in by_name.items()
                         if any(k in n for k in keys))
                for fam, keys in KERNELS.items()}
    counts = {fam: sum(1 for n, _, _ in dev if any(k in n for k in keys))
              for fam, keys in KERNELS.items()}
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted(((a, b, n) for n, a, b in host if n.startswith("bench.")))
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
        gaps[active[0][2] if active else "outside bench spans"] += \
            (s1 - e0) * 1e-9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s,
            "kernel_s": families, "kernel_calls": counts,
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
