"""The control of ``correct``, and the readings its limits are set from.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

For each seed, in one process: one run of the cell (the program's
readings: the widest and the mean gap of a served token below the
reference's best, the share of the reference's top chunks its evaluation
left out), then the reference put in the program's place and computed in
float8 e4m3 (the control's readings: the same gaps of the token that
float8 puts first, at each position of the same prompts and served
tokens), judged by the cell's checks as a run is: ``control_correct``
has to read false.  ``--look`` also reads the reference in bfloat16, the
configuration's own precision, as a witness; ``--spec`` names a cell
waiting in ``bench/pending/``.  Prints one JSON line a seed and a last
line with the program's most and the control's least of each number.
The benchmark's own runs never run the control.
"""

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402


NUMBERS = ("widest_gap", "mean_gap", "selection_miss_share")


def readings(workload, seed, seconds, *, device="cuda", overrides=None,
             look=False, spec_file=None):
    from bench import reference
    out = harness.run(workload, seed, seconds, False, device=device,
                      overrides=overrides, keep=True, spec_file=spec_file)
    t = time.perf_counter()
    ctrl = reference.logits(out["ref_model"], out["layers"], out["head"],
                            out["samples"], precision="fp8")
    res = out["result"]
    served = [reference.served_tensor(s) for s in out["samples"]]
    firsts = [c.argmax(dim=-1) for c in ctrl]
    # the control takes the program's place in the served tokens; it
    # attends over the program's selections, so those numbers stay
    numbers = {**out["numbers"],
               "widest_gap": reference.widest_gap(out["ref_rows"], firsts),
               "mean_gap": reference.mean_gap(out["ref_rows"], firsts)}
    ctrl_checks, ctrl_correct = harness.judge(
        harness.load_cell(workload, spec_file)["checks"], numbers, 0)
    row = {"seed": seed,
           "program": {k: out["numbers"][k] for k in NUMBERS},
           "control": {k: numbers[k] for k in NUMBERS},
           "control_correct": ctrl_correct, "control_checks": ctrl_checks,
           "program_q": reference.gap_quantiles(out["ref_rows"], served),
           "control_q": reference.gap_quantiles(out["ref_rows"], firsts)}
    if look:
        # the configuration's own precision, in the program's place
        wit = reference.logits(out["ref_model"], out["layers"], out["head"],
                               out["samples"], precision="bf16")
        row["bf16_q"] = reference.gap_quantiles(
            out["ref_rows"], [c.argmax(dim=-1) for c in wit])
    return {**row,
            "correct": res["correct"], "checks": res["checks"],
            "served": res["served_compared"],
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "peak_bytes": res["device"]["memory_peak_bytes"],
            "write_bytes": res["write_bytes"],
            "reference_s": res["reference_s"],
            "control_s": time.perf_counter() - t}


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spec", default=None,
                    help="the file the cell is in (default BENCHMARK.json)")
    ap.add_argument("--look", action="store_true",
                    help="also read the reference in bfloat16 (a witness)")
    args = ap.parse_args(argv)
    harness.set_env()
    rows = []
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.seconds, look=args.look,
                     spec_file=args.spec)
        rows.append(r)
        print(json.dumps(r), flush=True)
        gc.collect()
    summary = {}
    for k in NUMBERS:
        summary[k] = {"program_max": max(r["program"][k] for r in rows),
                      "control_min": min(r["control"][k] for r in rows),
                      "program": [r["program"][k] for r in rows],
                      "control": [r["control"][k] for r in rows]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
