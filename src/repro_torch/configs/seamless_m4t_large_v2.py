"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf].

24L(enc) + 24L(dec) d_model=1024 16H d_ff=8192 vocab=256206.  The audio
frontend (conformer feature extractor) is a STUB per the assignment spec:
``input_specs()`` provides precomputed frame embeddings (B, S_enc, d) for the
encoder; the decoder is an autoregressive text decoder with cross-attention.

Adaptation note: sinusoidal positions are replaced with RoPE so the decode
shapes (32k/500k self-attention cache) remain position-generalizable; this is
a documented deviation (DESIGN.md §7).  Decode shapes exercise the decoder
self-attention cache (the cross-attention KV is static per request and
tier-resident, not re-selected).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    enc_layers=24,
    cross_attn=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    act="relu",
    rope="rope",
    rope_theta=10_000.0,
    embed_inputs=True,
    tie_embeddings=True,
)
