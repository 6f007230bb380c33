"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff=1408(expert) vocab=102400, MLA kv_lora=512,
2 shared + 64 routed experts top-6 (the assigned-spec comment's "160 routed"
is the full DeepSeek-V2; the Lite config verified on HF uses 64 routed, which
matches the "MoE 64e top-6" header we follow).  First layer dense (d_ff
10944).  MLA dims from the paper: qk_nope 128, qk_rope 64, v 128.

LeoAM adaptation: KV abstracts are min/max boxes over the *compressed latent*
c_kv (rank 512) + the shared rope key; bounds are computed in latent space
after absorbing W_UK into the query (DESIGN.md §4).
"""

from repro_torch.configs.base import RuntimeCfg, ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MLA: logical kv heads == q heads
    head_dim=128,
    d_ff=10_944,            # dense prologue FFN width
    d_ff_dense=10_944,
    vocab_size=102_400,
    act="swiglu",
    rope="rope",
    rope_theta=10_000.0,
    mlp_pattern=("moe",),
    first_dense=1,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=None,
               qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    tie_embeddings=False,
    runtime=RuntimeCfg(adam_dtype="bfloat16", fsdp_params=True),
)
