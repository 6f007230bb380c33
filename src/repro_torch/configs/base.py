"""Architecture / shape / runtime configuration schema.

Every assigned architecture gets one module in ``repro_torch.configs`` exporting a
``CONFIG: ArchConfig``.  The registry in ``repro_torch.configs.__init__`` resolves
``--arch <id>`` strings.  ``smoke_variant`` derives a reduced config of the
same *family* (same layer pattern / block kinds, tiny dims) for CPU tests.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoECfg:
    """Mixture-of-experts block config (GShard-style dense dispatch)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class MLACfg:
    """DeepSeek multi-head latent attention dims."""

    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None   # None => direct q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None       # None => ceil(d_model/16)


@dataclass(frozen=True)
class LeoAMCfg:
    """Paper-technique knobs (IAKM / LKA / DTP). §4 of the paper."""

    enabled: bool = True
    chunk_size: int = 64            # initial chunk size (paper default, §6.1)
    early_chunk_size: int = 8       # finer chunks for early layers (§6.1)
    importance_rate: float = 0.10   # fraction of KV loaded (paper default)
    early_layers: int = 2           # first-K layers: denser attention (§4.3)
    early_rate: float = 0.50        # 50% budget on the first two layers (§6.1)
    sink_chunks: int = 1            # always-resident leading chunks
    recent_chunks: int = 2          # always-resident trailing chunks
    pyramid_levels: int = 3         # abstract pyramid depth (TPU adaptation)
    refine_factor: int = 2          # candidate multiplier per pyramid level
    compression: str = "int4"       # transit compression codec
    min_seq_for_sparse: int = 1024  # below this, dense decode is cheaper


@dataclass(frozen=True)
class RuntimeCfg:
    """Per-(arch x shape) execution knobs; overridable from launch scripts."""

    microbatches: int = 1           # grad-accumulation steps (scan)
    remat: str = "block"            # none | block  (full block recompute)
    adam_dtype: str = "float32"     # Adam m/v dtype (bf16 for 100B+ archs)
    # FSDP-shard parameter embed dims over the data axes.  Off for archs
    # whose params+opt fit replicated-over-data (pure TP+DP — no per-layer
    # weight all-gathers); on for the frontier archs that need it.
    fsdp_params: bool = False
    # Two-level (sqrt-N) recursive remat: outer scan over this many layer
    # groups, inner scan rematted per layer.  Cuts loop-carry activation
    # memory from O(L) to O(G + L/G) at ~one extra forward of recompute.
    # None => single-level remat.
    remat_groups: Optional[int] = None
    scan_layers: bool = True        # lax.scan over layer groups
    attn_block_q: int = 512         # blocked-attention query tile
    attn_block_kv: int = 1024       # blocked-attention kv tile
    seq_shard_decode: bool = True   # shard KV sequence for decode shapes
    exact_global_topk: bool = False # exact (all-gather bounds) chunk top-k


# ---------------------------------------------------------------------------
# Main architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int                   # decoder layers
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                       # dense FFN width (0 => no FFN, e.g. xLSTM)
    vocab_size: int

    head_dim: Optional[int] = None  # default: d_model // n_heads
    act: str = "swiglu"             # swiglu | relu2 | geglu
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope: str = "rope"              # rope | mrope | none
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    window: Optional[int] = None    # local-attention window (tokens)

    # Layer pattern: block kind per layer position within one period.
    # Kinds: "attn" | "attn_local" | "attn_global" | "mamba" | "mlstm" | "slstm"
    layer_pattern: Tuple[str, ...] = ("attn",)
    # MLP kind per period position: "dense" | "moe" | "none"
    mlp_pattern: Tuple[str, ...] = ("dense",)
    first_dense: int = 0            # prologue: first-K layers forced dense MLP
    # Layers unrolled before the scanned body (None => max(first_dense,
    # leoam.early_layers)).  Must leave a pattern-periodic remainder.
    prologue_layers: Optional[int] = None

    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None

    enc_layers: int = 0             # >0 => encoder-decoder
    cross_attn: bool = False        # decoder cross-attention (enc-dec)
    embed_inputs: bool = False      # modality stub: prefill/train take embeds
    tie_embeddings: bool = True
    d_ff_dense: Optional[int] = None  # FFN width of prologue dense layers

    leoam: LeoAMCfg = field(default_factory=LeoAMCfg)
    runtime: RuntimeCfg = field(default_factory=RuntimeCfg)
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind for every decoder layer."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def mlp_kinds(self) -> Tuple[str, ...]:
        p = self.mlp_pattern
        kinds = [p[i % len(p)] for i in range(self.n_layers)]
        for i in range(min(self.first_dense, self.n_layers)):
            if kinds[i] == "moe":
                kinds[i] = "dense"
        return tuple(kinds)

    def prologue(self) -> int:
        """Unrolled leading layers (early-layer LeoAM budgets / dense MLPs)."""
        if self.prologue_layers is not None:
            return min(self.prologue_layers, self.n_layers)
        early = self.leoam.early_layers if self.leoam.enabled else 0
        return min(max(self.first_dense, early), self.n_layers)

    def period(self) -> int:
        """Smallest repeating period of (layer, mlp) kinds after the prologue."""
        kinds = list(zip(self.layer_kinds(), self.mlp_kinds()))[self.prologue():]
        n = len(kinds)
        if n == 0:
            return 1
        for p in range(1, n + 1):
            if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
                return p
        return n

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.hd
        total = 0
        kinds, mlps = self.layer_kinds(), self.mlp_kinds()
        for kind, mlp in zip(kinds, mlps):
            total += self._block_params(kind)
            total += self._mlp_params(mlp)
            total += 2 * d  # two RMSNorm scales
        if self.is_encdec:
            for _ in range(self.enc_layers):
                total += self._block_params("attn") + self._mlp_params("dense") + 2 * self.d_model
            total += self.n_layers * (self._block_params("attn") + self.d_model)  # cross attn
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += d  # final norm
        return total

    def n_active_params(self) -> int:
        """Per-token activated params (MoE counts shared + top_k experts)."""
        d = self.d_model
        total = 0
        for kind, mlp in zip(self.layer_kinds(), self.mlp_kinds()):
            total += self._block_params(kind)
            if mlp == "moe":
                assert self.moe is not None
                m = self.moe
                per_e = self._ffn_params(m.d_ff_expert)
                total += (m.top_k + m.n_shared) * per_e + d * m.n_experts
            else:
                total += self._mlp_params(mlp)
            total += 2 * d
        if self.is_encdec:
            for _ in range(self.enc_layers):
                total += self._block_params("attn") + self._mlp_params("dense") + 2 * d
            total += self.n_layers * (self._block_params("attn") + d)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def _ffn_params(self, ff: int) -> int:
        d = self.d_model
        if ff == 0:
            return 0
        gated = self.act in ("swiglu", "geglu")
        return d * ff * (3 if gated else 2)

    def _mlp_params(self, mlp_kind: str) -> int:
        if mlp_kind == "none" or self.d_ff == 0:
            return 0
        if mlp_kind == "moe":
            assert self.moe is not None
            m = self.moe
            per_e = self._ffn_params(m.d_ff_expert)
            return m.n_experts * per_e + m.n_shared * per_e + self.d_model * m.n_experts
        ff = self.d_ff_dense if (mlp_kind == "dense" and self.d_ff_dense) else self.d_ff
        return self._ffn_params(ff)

    def _block_params(self, kind: str) -> int:
        d, hd = self.d_model, self.hd
        if kind.startswith("attn"):
            if self.mla is not None:
                c = self.mla
                qk = c.qk_nope_head_dim + c.qk_rope_head_dim
                q_p = (d * c.q_lora_rank + c.q_lora_rank * self.n_heads * qk
                       if c.q_lora_rank else d * self.n_heads * qk)
                kv_down = d * (c.kv_lora_rank + c.qk_rope_head_dim)
                kv_up = c.kv_lora_rank * self.n_heads * (c.qk_nope_head_dim + c.v_head_dim)
                o_p = self.n_heads * c.v_head_dim * d
                return q_p + kv_down + kv_up + o_p
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if kind == "mamba":
            assert self.mamba is not None
            m = self.mamba
            d_in = m.expand * d
            dt_rank = m.dt_rank or -(-d // 16)
            return (d * 2 * d_in + d_in * m.d_conv + d_in * (dt_rank + 2 * m.d_state)
                    + dt_rank * d_in + d_in * m.d_state + d_in + d_in * d)
        if kind == "mlstm":
            d_in = 2 * d
            # up proj (x,z), q/k/v projs on d_in, gates, out proj
            return d * 2 * d_in + 3 * d_in * d_in // 1 + 2 * d_in + d_in * d
        if kind == "slstm":
            # recurrent + input weights for 4 gates + ffn-ish proj
            return 8 * d * d + 4 * d
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; identical for all 10 LM-family archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeCfg:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}") from None


# ---------------------------------------------------------------------------
# Smoke variants
# ---------------------------------------------------------------------------


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced config of the same family: same layer/mlp pattern, tiny dims."""
    period = cfg.period()
    prologue = cfg.prologue()
    # always keep >=1 scanned body repeat so the scan path is exercised
    n_layers = prologue + period * (2 if period * 2 + prologue <= 6 else 1)
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, n_heads)
    if n_heads % n_kv:
        n_kv = 2
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        d_ff_dense=None if cfg.d_ff_dense is None else 160,
        vocab_size=512,
        enc_layers=0 if cfg.enc_layers == 0 else 2,
        window=None if cfg.window is None else 64,
        leoam=dataclasses.replace(
            cfg.leoam, chunk_size=8, early_chunk_size=4, pyramid_levels=2,
            min_seq_for_sparse=32, sink_chunks=1, recent_chunks=1),
        runtime=dataclasses.replace(cfg.runtime, microbatches=1, remat="none"),
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=64,
            n_shared=min(cfg.moe.n_shared, 1))
    if cfg.mla is not None:
        kw["mla"] = MLACfg(kv_lora_rank=32, q_lora_rank=None,
                           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.mamba is not None:
        kw["mamba"] = MambaCfg(d_state=8, d_conv=4, expand=2, dt_rank=8)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


def tokens_per_step(shape: ShapeCfg) -> int:
    if shape.kind == "train":
        return shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return shape.seq_len * shape.global_batch
    return shape.global_batch  # decode: one token per sequence
