"""nemotron-4-340b — dense GQA decoder [arXiv:2402.16819; unverified].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000 — GQA, squared-ReLU.
Frontier-scale dense arch; training uses bf16 Adam states + aggressive
microbatching (see runtime overrides in launch/dryrun.py).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig, RuntimeCfg

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    act="relu2",
    rope="rope",
    rope_theta=10_000.0,
    tie_embeddings=False,
    # 6 unrolled prologue layers leave a 90-layer body = 9 groups x 10
    # layers for sqrt-N remat; 8 microbatches balance FSDP re-gather traffic
    # (collective term scales with microbatch count; see §Perf A1) vs carries
    prologue_layers=6,
    runtime=RuntimeCfg(microbatches=8, remat="block", adam_dtype="bfloat16",
                       fsdp_params=True, remat_groups=9),
)
