"""moonshot-v1-16b-a3b — fine-grained MoE (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=163840,
MoE 64e top-6.  Details filled from the public Moonlight config: 2 shared
experts, first layer dense (d_ff 11264), rope_theta 50000.
"""

from repro_torch.configs.base import RuntimeCfg, ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11_264,            # dense prologue FFN width
    d_ff_dense=11_264,
    vocab_size=163_840,
    act="swiglu",
    rope="rope",
    rope_theta=50_000.0,
    mlp_pattern=("moe",),
    first_dense=1,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    tie_embeddings=False,
    runtime=RuntimeCfg(adam_dtype="bfloat16", fsdp_params=True),
)
