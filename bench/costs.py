"""The yardstick's arithmetic, frozen: H100 peaks, the operations and bytes
of kernels B1 and B2 (and of their latent variants), and the model FLOPs
that the MFU metrics divide by.

Copied from ``repro_torch.kernels.chunk_bounds.ops`` (``_bounds_cost``),
``repro_torch.kernels.sparse_decode.ops`` (``cost_rows``,
``cost_sparse_decode_pooled``) and ``repro_torch.launch.roofline`` (the
peaks), and kept here so that a change to the program cannot move the
yardstick.  Everything takes plain integers: no tensor of the program is
read.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM5 80GB data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12            # CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the operations
    at ``peak_flops`` and the bytes at the HBM rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# B1: chunk bounds (``chunk_bounds_gqa`` on the store's (B, nc, Hkv, hd)
# stack; the latent variant on (B, nc, 1, D))
# ---------------------------------------------------------------------------


def b1_cost(batch: int, q_heads: int, hd: int, nc: int, kv_heads: int,
            q_itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of one B1 call: 8 operations per (query row, chunk,
    coordinate) -- the two box products, their max and min, the two sums;
    bytes: q in its dtype and the two f32 box planes read once, ub and lb
    (f32, (B, Hkv, nc)) written once."""
    flops = 8 * batch * q_heads * nc * hd
    nbytes = (batch * q_heads * hd * q_itemsize
              + 2 * batch * nc * kv_heads * hd * 4
              + 2 * batch * kv_heads * nc * 4)
    return float(flops), float(nbytes)


def b1_latent_cost(batch: int, q_heads: int, width: int, nc: int,
                   q_itemsize: int) -> Tuple[float, float]:
    """B1's latent variant: one kv head of row width ``width``."""
    return b1_cost(batch, q_heads, width, nc, 1, q_itemsize)


# B1 computes in f32 on the CUDA cores
B1_PEAK = PEAK_F32_FLOPS


# ---------------------------------------------------------------------------
# B2: sparse decode attention over pool slots (``sparse_decode_pooled``)
# ---------------------------------------------------------------------------


def b2_rows_cost(kv_rows: int, new_rows: int, heads_per_kv: int, hd: int,
                 kv_itemsize: int, io_bytes: int) -> Tuple[float, float]:
    """(flops, bytes) over ``kv_rows`` cache rows (summed over every
    (sequence, kv head)) and ``new_rows`` new-token rows: each row costs
    its q heads 2*hd for the score and 2*hd for P.V; the selected rows'
    K and V are read once, beside ``io_bytes``."""
    flops = 4 * heads_per_kv * hd * (kv_rows + new_rows)
    return float(flops), float(2 * kv_rows * hd * kv_itemsize + io_bytes)


def b2_pooled_cost(batch: int, q_heads: int, kv_heads: int, hd: int,
                   live_rows: int, nsel: int, itemsize: int
                   ) -> Tuple[float, float]:
    """One pooled B2 call.  ``live_rows``: the selected chunks' rows below
    each sequence's length, summed over the sequences (every kv head reads
    them); each sequence's new token adds one row.  q, the new K and V
    rows and the output move once in the model dtype; the slot and chunk
    index arrays (B, nsel) and the lengths (B,) as int32."""
    io = (2 * batch * q_heads * hd * itemsize            # q in, out
          + 2 * batch * kv_heads * hd * itemsize         # k_new, v_new
          + 2 * batch * nsel * 4 + batch * 4)            # slots, ids, lens
    return b2_rows_cost(live_rows * kv_heads, batch * kv_heads,
                        q_heads // kv_heads, hd, itemsize, io)


def b2_latent_cost(batch: int, q_heads: int, width: int, rank: int,
                   live_rows: int, nsel: int, itemsize: int
                   ) -> Tuple[float, float]:
    """B2's latent variant: one plane of ``width``-wide rows; scores over
    all ``width`` columns, values the first ``rank``; out_lat (B, H, rank)
    f32."""
    rows = live_rows + batch
    flops = 2 * q_heads * rows * (width + rank)
    nbytes = (live_rows * width * itemsize
              + batch * q_heads * width * 4 + batch * width * itemsize
              + batch * q_heads * rank * 4
              + 2 * batch * nsel * 4 + batch * 4)
    return float(flops), float(nbytes)


# B2's scores and P.V run on the tensor cores in the model dtype
B2_PEAK = PEAK_BF16_FLOPS


# ---------------------------------------------------------------------------
# Model FLOPs: 2 x the matmul parameters a token touches, plus attention
# over the rows it attended.  ``m`` is a configuration file's dict.
# ---------------------------------------------------------------------------


def _moe(m: Dict) -> bool:
    return bool(m.get("n_routed_experts"))


def _mla(m: Dict) -> bool:
    return m.get("kv_lora_rank") is not None


def _n_heads(m: Dict) -> Tuple[int, int, int]:
    H = m["num_attention_heads"]
    Hkv = m.get("num_key_value_heads", H)
    hd = m.get("head_dim") or m["hidden_size"] // H
    return H, Hkv, hd


def attn_matmul_params(m: Dict) -> int:
    """Projection parameters of one attention layer that a token touches
    (MLA: the non-absorbed form's per-token expansions through wk_b and
    wv_b count as the r x (nope + v) products they are)."""
    d = m["hidden_size"]
    H, Hkv, hd = _n_heads(m)
    if _mla(m):
        r, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
        nope, vd = m["qk_nope_head_dim"], m["v_head_dim"]
        return (d * H * (nope + rope) + d * (r + rope)
                + H * r * (nope + vd) + H * vd * d)
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def mlp_matmul_params(m: Dict, layer: int) -> int:
    """The MLP parameters a token touches at ``layer``: dense SwiGLU, or
    the router, its top-k routed experts and the shared ones."""
    d = m["hidden_size"]
    if _moe(m) and layer >= m.get("first_k_dense_replace", 0):
        ff = m["moe_intermediate_size"]
        k, E = m["num_experts_per_tok"], m["n_routed_experts"]
        shared = m.get("n_shared_experts", 0) * ff
        return d * E + 3 * d * ff * k + 3 * d * shared
    return 3 * d * m["intermediate_size"]


def token_matmul_flops(m: Dict, *, logits: bool) -> float:
    """2 x the matmul parameters one token touches through every layer,
    and the output head when its logits are computed."""
    L = m["num_hidden_layers"]
    p = sum(attn_matmul_params(m) + mlp_matmul_params(m, i)
            for i in range(L))
    if logits:
        p += m["hidden_size"] * m["vocab_size"]
    return 2.0 * p


def attn_flops_per_row(m: Dict) -> float:
    """Scores and P.V of one query row against one key row, over every
    head of one layer."""
    H, _, hd = _n_heads(m)
    if _mla(m):
        return 2.0 * H * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                          + m["v_head_dim"])
    return 4.0 * H * hd


def decode_token_flops(m: Dict, rows_by_layer) -> float:
    """One decoded token: every matmul, the head, and attention over the
    rows it attended at each layer (``rows_by_layer``: one count a layer,
    the new token's own row included)."""
    return (token_matmul_flops(m, logits=True)
            + attn_flops_per_row(m) * float(sum(rows_by_layer)))


def prefill_flops(m: Dict, prompt_len: int) -> float:
    """A whole-prompt prefill of ``prompt_len`` tokens: every token's
    matmuls, causal attention over S(S+1)/2 pairs a layer, and the head
    for the last row."""
    S = int(prompt_len)
    pairs = S * (S + 1) / 2.0
    return (S * token_matmul_flops(m, logits=False)
            + 2.0 * m["hidden_size"] * m["vocab_size"]
            + attn_flops_per_row(m) * pairs * m["num_hidden_layers"])
