"""jamba-1.5-large-398b — hybrid Mamba+attention MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Structure: 1:7 attention:Mamba interleave (one attention layer per 8-layer
period, at position 3 as in the released config), MoE on every other layer.
No RoPE — Mamba layers carry position information (per the Jamba paper).

LeoAM applicability: chunk selection runs on the 9 attention layers' KV
caches; Mamba layers keep fixed-size SSM state (no KV to manage).
"""

from repro_torch.configs.base import ArchConfig, LeoAMCfg, MambaCfg, MoECfg, RuntimeCfg

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    act="swiglu",
    rope="none",
    layer_pattern=(
        "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba",
    ),
    mlp_pattern=("dense", "moe"),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24_576),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    # unroll the full first period so the first attention layer (global
    # index 3) gets the early/dense LeoAM budget and the scanned body stays
    # pattern-periodic (64 = 8 x 8 layers)
    prologue_layers=8,
    leoam=LeoAMCfg(early_layers=4),   # first attention layer (idx 3) = early
    tie_embeddings=False,
    runtime=RuntimeCfg(microbatches=8, remat="block", adam_dtype="bfloat16",
                       fsdp_params=True, remat_groups=4),
)
