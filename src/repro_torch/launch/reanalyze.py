"""Re-cost saved dry-run op traces (no retrace), the port's counterpart of
``repro.launch.reanalyze``:

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir results/dryrun_torch

Each record whose ``trace_file`` exists gets a new ``op_cost`` from
``op_costing.analyze`` (the current rules over the saved ops).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.op_costing import analyze


def reanalyze_dir(dir_: str) -> int:
    """Update every record in ``dir_`` that has a saved trace; returns how
    many were updated."""
    n = 0
    for fn in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        trace = rec.get("trace_file")
        if not trace or not os.path.exists(trace):
            continue
        rec["op_cost"] = analyze(trace, rec["n_devices"])
        with open(fn, "w") as f:
            json.dump(rec, f, indent=2)
        n += 1
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    print(f"re-analyzed {reanalyze_dir(args.dir)} cells")


if __name__ == "__main__":
    main()
