"""Training entry point: synthetic data -> train loop -> checkpoints, with
fault tolerance and straggler telemetry (the port of
``repro.launch.train``, on one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --steps 20 --device cpu

Without ``--device`` it runs on the CUDA card and raises where there is
none.  Flags are the reference's, plus ``--device`` and
``--microbatches`` (the config's ``runtime.microbatches`` unless given).
The Adam moments are kept in the config's ``runtime.adam_dtype`` (bf16
for deepseek-v2-lite), as the reference's production step keeps them.
``main(argv)`` returns the logged ``(step, loss)`` history.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataCfg, ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.launch import steps as stp
from repro_torch.models import lm
from repro_torch.models.params import leaves
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 run_with_restarts)

log = logging.getLogger("repro_torch.train")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when not given")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple[int, float]]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.microbatches is not None:
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, microbatches=args.microbatches))
    adam = adamw.AdamWCfg(state_dtype=cfg.runtime.adam_dtype)
    tcfg = stp.TrainCfg(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                        total_steps=args.steps, adam=adam)
    params = lm.init(cfg, seed=0, device=dev)
    state = {"params": params, "opt": adamw.init_opt_state(params, adam)}
    n_params = sum(p.numel() for p in leaves(params))
    log.info("arch=%s params=%.2fM steps=%d device=%s", cfg.name,
             n_params / 1e6, args.steps, dev)

    step_fn = stp.make_train_step(cfg, tcfg)
    loader = ShardedLoader(DataCfg(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch))
    ck = Checkpointer(args.ckpt, keep=3) if args.ckpt else None
    start = 0
    if ck and args.resume and ck.latest_step() is not None:
        state, start = ck.restore(state)
        log.info("resumed from step %d", start)

    history: List[Tuple[int, float]] = []

    def one_step(i, s):
        batch = next(loader)
        s, m = step_fn(s, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(m["loss"])
            history.append((i, loss))
            log.info("step %5d loss=%.4f acc=%.3f lr=%.2e gnorm=%.2f",
                     i, loss, float(m["accuracy"]), float(m["lr"]),
                     float(m.get("grad_norm", 0.0)))
        return s

    mon = StragglerMonitor()
    try:
        if ck:
            state, stats = run_with_restarts(
                one_step, state, n_steps=args.steps, checkpointer=ck,
                save_every=args.save_every, monitor=mon, start_step=start,
                restore_fn=ck.restore)
            log.info("done; restarts=%d stragglers=%d", stats.restarts,
                     len(mon.flagged))
        else:
            for i in range(start, args.steps):
                t0 = time.perf_counter()
                state = one_step(i, state)
                mon.record(i, time.perf_counter() - t0)
    finally:
        loader.close()
        if ck:
            ck.close()
    if len(history) >= 2:
        first, last = history[0][1], history[-1][1]
        log.info("loss %.4f -> %.4f (delta %.4f)", first, last, first - last)
    return history


if __name__ == "__main__":
    main()
