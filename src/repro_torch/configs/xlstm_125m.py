"""xlstm-125m — sLSTM + mLSTM recurrent blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 vocab=50304.  Block mix: 2 mLSTM : 1 sLSTM period
(8 mLSTM + 4 sLSTM over 12 layers; the paper's 125M uses a small sLSTM
fraction — documented deviation, the assigned spec fixes only the totals).
d_ff=0: xLSTM blocks carry their own up/down projections, no separate FFN.

LeoAM applicability: NOT APPLICABLE — there is no KV cache; state is a
fixed-size matrix memory per head.  Implemented without the technique
(DESIGN.md §4 Arch-applicability).  ``long_500k`` runs on the native
recurrence (mLSTM chunkwise-parallel for train/prefill, stepwise for decode).
"""

from repro_torch.configs.base import ArchConfig, LeoAMCfg

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    act="swiglu",
    rope="none",
    layer_pattern=("mlstm", "mlstm", "slstm"),
    mlp_pattern=("none",),
    leoam=LeoAMCfg(enabled=False),
    tie_embeddings=True,
)
