"""Quickstart: LeoAM sparse decode on a small model, end to end, on the port.

    PYTHONPATH=src python -m repro_torch.launch.quickstart              # card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

The public API surface of ``repro_torch``: config registry → model init →
prefill → LeoAM decode (abstract pyramid + adaptive selection, kernels B1
and B2 on the card) against dense decode, and how close the budgeted
output stays to the full-cache output.  The same steps as the JAX
package's ``examples/quickstart.py`` (phi4-mini's smoke config, the same
LeoAM overrides, a 255-token prompt in a 256-token cache); the weights are
the port's own random draw, so the numbers differ from that script's.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.models import lm


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 1. pick an architecture (any attention-only config of the port works)
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    cfg = dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=16,
                                       importance_rate=0.15,
                                       min_seq_for_sparse=64))
    params = lm.init(cfg, seed=0, device=args.device)

    # 2. prefill a prompt; the cache carries KV + the LKA abstract pyramid
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(2, cfg.vocab_size, (1, 255), generator=gen)
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg,
                                   {"tokens": prompt.to(args.device)},
                                   max_len=256)
        tok = int(logits[0].argmax())
        print(f"prefill done on {args.device}; first token {tok}")
        print("cache leaves:", sorted(cache["prologue"][0].keys()))

        # 3. decode with LeoAM adaptive selection (15% budget + sink/recent)
        token = {"token": torch.tensor([tok], device=args.device)}
        logits_sparse, _ = lm.decode_step(params, cfg, cache, token, 255)

        # 4. against dense decode (the full cache attended); the second
        # step rewrites the same row at position 255, so the cache is the
        # first step's input again
        dense = dataclasses.replace(
            cfg, leoam=dataclasses.replace(cfg.leoam,
                                           min_seq_for_sparse=10**9))
        logits_dense, _ = lm.decode_step(params, dense, cache, token, 255)
    a, b = logits_sparse[0].double(), logits_dense[0].double()
    cos = float(a @ b / (a.norm() * b.norm()))
    print(f"sparse-vs-dense logits: cos={cos:.4f} "
          f"argmax_agree={bool(a.argmax() == b.argmax())}")
    print("note: random-init attention is near-uniform (the technique's "
          "worst case); on attention-concentrated caches the same budget "
          "gives <1% error — see tests/test_torch_sparse_attention.py")


if __name__ == "__main__":
    main()
