"""CLI: ``python -m repro_torch.analysis [--strict] [--passes a,b]
[paths...]`` (default ``src/repro_torch``).

Exit status: 0 when every finding is waived (or there are none); 1 when
unwaived findings remain.  ``--strict`` additionally fails on malformed
waiver pragmas (they are reported either way); the tier-1 test
``tests/test_torch_leolint.py`` holds the port to it.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.core import PASS_IDS, run_passes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="leolint: concurrency/billing contract checker for "
                    "the tiered serving engine (PyTorch)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to check (default: "
                         "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on malformed waiver pragmas")
    ap.add_argument("--passes", default=",".join(PASS_IDS),
                    help=f"comma-separated subset of {PASS_IDS}")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings (audit view)")
    args = ap.parse_args(argv)

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in passes if p not in PASS_IDS]
    if unknown:
        ap.error(f"unknown pass(es): {unknown}; choose from {PASS_IDS}")

    findings, _index = run_passes(args.paths, passes)
    live = [f for f in findings if not f.waived and f.pass_id != "waiver"]
    malformed = [f for f in findings if f.pass_id == "waiver"]
    waived = [f for f in findings if f.waived]

    for f in live + malformed:
        print(f.render())
    if args.show_waived:
        for f in waived:
            print(f.render())
    print(f"leolint: {len(live)} finding(s), {len(waived)} waived, "
          f"{len(malformed)} malformed waiver(s)", file=sys.stderr)

    if live:
        return 1
    if malformed and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
