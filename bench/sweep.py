"""The knee of an open-loop cell: the highest offered rate it sustains
without a growing backlog, found once on the chip.

    python3 bench/sweep.py --workload deepseek.admit_rag \
        --spec bench/pending/deepseek.admit_rag.json --rates 0.3,0.5 --seconds 60

One process, one engine: for each rate, arrivals at that rate for
``--seconds`` (after ``warm_s`` of the same load), then the queue left at
the close, the requests completed a second and the TTFT median and 95th
percentile of the requests due in the window.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--spec", default=None,
                    help="the file the cell is in (default BENCHMARK.json)")
    args = ap.parse_args(argv)
    harness.set_env()
    import numpy as np
    import torch
    from bench import generator, weights
    from repro_torch.models import lm
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    from repro_torch.serving.scheduler import ContinuousBatcher, SchedulerCfg
    ctx = harness.load_cell(args.workload, args.spec)
    model, mix = ctx["model"], ctx["mix"]
    arch = harness.build_arch(model)
    params = weights.make(lm.param_defs(arch), args.seed,
                          getattr(torch, arch.dtype), "cuda")
    ecfg = EngineCfg(**model["port"]["engine"])
    scfg = SchedulerCfg(**{**model["port"].get("scheduler", {}),
                           **mix["scheduler"]})
    eng = BatchedLeoAMEngine(arch, params, ecfg,
                             max_seqs=scfg.max_active + scfg.prefill_ahead,
                             device="cuda",
                             store_root=tempfile.mkdtemp(prefix="bench-"))
    batcher = ContinuousBatcher(engine=eng, cfg=scfg)
    plan = generator.open_arrivals(mix, args.seed, arch.vocab_size)
    harness._warm_open(eng, batcher, plan, mix, arch)
    for rate in [float(r) for r in args.rates.split(",")]:
        plan = generator.open_arrivals(mix, args.seed, arch.vocab_size,
                                       rate=rate)
        stamps = harness.Stamps()
        m = {**mix, "drain_s": 0.0}
        box = {}

        def on_open():
            return time.perf_counter()

        def on_step():
            if "q" not in box and time.perf_counter() >= t_close[0]:
                box["q"] = len(batcher.queue)

        t_close = [time.perf_counter() + float(mix["warm_s"]) + args.seconds]
        out = harness.drive_open(batcher, stamps, plan, m, args.seconds,
                                 on_open, on_step)
        meas = out["measured"]
        ttft = [stamps.times[r][0] - stamps.due[r] if stamps.times[r]
                else float("inf") for r in meas]
        done = sum(1 for r in meas if stamps.reqs[r].t_done is not None
                   and stamps.reqs[r].t_done <= out["t_close"])
        print(json.dumps({
            "rate": rate, "due": len(meas), "completed_in_window": done,
            "completed_per_s": done / args.seconds,
            "queue_at_close": box.get("q"),
            "ttft_p50_s": float(np.median(ttft)) if ttft else None,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else None,
            "late_p95_s": float(np.percentile(out["lateness_s"], 95))}),
            flush=True)
    eng.store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
