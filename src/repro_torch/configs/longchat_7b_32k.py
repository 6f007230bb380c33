"""longchat-7b-32k — the paper's own evaluation model (LLaMA-7B arch,
rope-scaled to 32k) [hf:lmsys/longchat-7b-v1.5-32k].

Used by the LeoAM serving benchmarks to mirror the paper's latency tables.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="longchat-7b-32k",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11_008,
    vocab_size=32_000,
    act="swiglu",
    rope="rope",
    rope_theta=10_000.0,
    tie_embeddings=False,
)
