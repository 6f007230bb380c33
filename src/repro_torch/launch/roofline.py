"""Roofline analysis of the dry run's records, the port's counterpart of
``repro.launch.roofline``, against the H100's peaks.

Per (arch × shape × mesh) cell, per device:
    compute term    = op FLOPs / PEAK_FLOPS
    memory term     = op bytes / HBM_BW
    collective term = collective wire bytes / LINK_BW

The FLOPs, bytes and collective bytes come from the per-rank op trace
(``launch/op_costing.py`` through ``launch/dryrun.py``) and are per
device.  MODEL_FLOPS uses 6·N·D (train) / 2·N_active·D (inference).
The trace sees the dtypes the port moves, so no collective correction is
applied (the reference halves f32 collectives for an XLA CPU-backend
upcast that eager PyTorch does not make).

The peaks are the NVIDIA H100 SXM5 80GB's (NVIDIA H100 Tensor Core GPU
data sheet), at its 700 W maximum; a card capped lower runs slower.

Usage: python -m repro_torch.launch.roofline [--dir results/dryrun_torch]
       [--mesh 16x16] [--csv out]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import get_config, get_shape

# NVIDIA H100 SXM5 80GB data sheet (dense, no sparsity)
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor cores, FLOP/s
PEAK_BF16 = PEAK_FLOPS
PEAK_TF32 = 495e12           # TF32 tensor cores, FLOP/s
PEAK_F32 = 67e12             # f32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # HBM3, bytes/s
LINK_BW = 450e9              # NVLink 4: 900 GB/s a GPU, 450e9 each direction


def model_flops(arch: str, shape_name: str, n_devices: int) -> float:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        total = 6.0 * n * tokens
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        total = 2.0 * n * tokens
    else:
        total = 2.0 * n * shape.global_batch
    return total / n_devices


def analyze_cell(rec: Dict) -> Dict:
    n_dev = rec["n_devices"]
    oc = rec["op_cost"]
    flops = oc["flops"]
    mem_bytes = oc["bytes"]
    coll = oc["total_collective_bytes"]
    t_c = flops / PEAK_FLOPS
    t_m = mem_bytes / HBM_BW
    t_x = coll / LINK_BW
    dominant = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    mf = model_flops(rec["arch"], rec["shape"], n_dev)
    bound = max(t_c, t_m, t_x)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / max(flops, 1.0),
        "roofline_fraction": (mf / PEAK_FLOPS) / max(bound, 1e-30),
        "peak_gib": rec["memory"]["peak_bytes_per_device"] / 2**30,
        "collective_bytes": coll,
        "fits": rec.get("fits"),
    }


def suggestion(row: Dict) -> str:
    d = row["dominant"]
    if d == "collective":
        return ("keep parameters sharded (no whole-parameter gather per "
                "step); defer/batch gradient reductions; overlap "
                "collectives with compute")
    if d == "memory":
        return ("fuse the eager op chain (attention, norms, MoE dispatch) "
                "into hand kernels; raise arithmetic intensity via larger "
                "per-step tiles")
    return ("cut non-useful FLOPs: split the model axis's repeated work, "
            "lighter remat policy, causal-skip attention blocks")


def load(dir_: str, mesh: Optional[str] = None) -> List[Dict]:
    rows = []
    for fn in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if mesh and rec["mesh"] != mesh:
            continue
        rows.append(analyze_cell(rec))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = load(args.dir, args.mesh)
    hdr = (f"{'arch':24s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
           f"{'coll_s':>9s} {'dom':>10s} {'useful':>7s} {'roofl%':>7s} "
           f"{'GiB/dev':>8s} {'fits':>5s}")
    print(hdr)
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} {r['compute_s']:9.3g} "
              f"{r['memory_s']:9.3g} {r['collective_s']:9.3g} "
              f"{r['dominant']:>10s} {r['useful_ratio']:7.3f} "
              f"{100 * r['roofline_fraction']:7.2f} {r['peak_gib']:8.2f} "
              f"{str(r['fits']):>5s}")
    if args.csv and rows:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
