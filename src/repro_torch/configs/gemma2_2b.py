"""gemma2-2b — local+global alternating attention [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 — sliding-window (4096)
local layers alternate with full-attention global layers; GeGLU; attention and
final-logit softcapping.

LeoAM applicability: sparse decode selection runs on the *global* layers;
local layers already touch only the window (see DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    act="geglu",
    rope="rope",
    rope_theta=10_000.0,
    window=4096,
    layer_pattern=("attn_local", "attn_global"),
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
)
