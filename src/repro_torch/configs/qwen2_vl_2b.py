"""qwen2-vl-2b — VLM transformer backbone [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 — M-RoPE (3-section
temporal/height/width rotary), dynamic resolution.

Per the assignment spec the modality frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings (B, S, d_model) plus 3D M-RoPE position
ids (3, B, S); the backbone here is the real contribution surface.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    act="swiglu",
    rope="mrope",
    rope_theta=1_000_000.0,
    embed_inputs=True,
    tie_embeddings=True,
)
