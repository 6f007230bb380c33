"""Serving driver: the LeoAM three-tier engine on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch longchat-7b-32k \\
        --prompt-len 200 --gen 16

The port of ``repro.launch.serve``: a random-weight smoke model, one
prompt generated greedily, then the tier-traffic audit.  ``--device cpu`` runs on the CPU with the kernels'
plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving.engine import EngineCfg, LeoAMEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="longchat-7b-32k")
    ap.add_argument("--prompt-len", type=int, default=200)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--rate", type=float, default=0.2)
    ap.add_argument("--selection", default="tree", choices=["tree", "flat"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, chunk_size=16, importance_rate=args.rate,
        min_seq_for_sparse=32))
    params = lm.init(cfg, seed=0, device=args.device)
    eng = LeoAMEngine(cfg, params,
                      EngineCfg(max_len=args.max_len,
                                selection=args.selection),
                      device=args.device)
    rng = np.random.RandomState(0)
    prompt = rng.randint(2, cfg.vocab_size, args.prompt_len)
    t0 = time.perf_counter()
    toks = eng.generate(prompt, args.gen)
    dt = time.perf_counter() - t0
    print(f"generated {len(toks)} tokens in {dt:.2f}s on {args.device}: "
          f"{toks}")
    log = eng.store.log
    print("tier traffic (MiB):")
    for (src, dst, kind), b in sorted(log.bytes.items()):
        print(f"  {src:>6s} -> {dst:6s} [{kind:10s}] {b / 2**20:8.3f}")
    ev = np.mean([s.evaluations for s in eng.stats]) if eng.stats else 0
    print(f"mean evaluations/step: {ev:.0f} "
          f"(token-level would be {eng.length * len(eng.attn_layers)})")
    eng.store.close()


if __name__ == "__main__":
    main()
