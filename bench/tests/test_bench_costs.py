"""The frozen yardstick against counts worked out by hand at the cells'
shapes."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench import costs  # noqa: E402


def _model(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def test_peaks():
    assert costs.PEAK_BF16_FLOPS == 989e12
    assert costs.HBM_BYTES_PER_S == 3.35e12
    assert costs.PEAK_F32_FLOPS == 67e12


def test_b1_at_the_qwen3_round():
    # 4 sequences, 16 q heads of 128 in bf16, 48 chunks, 8 kv heads
    f, b = costs.b1_cost(4, 16, 128, 48, 8, 2)
    assert f == 8 * 4 * 16 * 48 * 128 == 3_145_728
    q = 4 * 16 * 128 * 2                  # 16 384
    boxes = 2 * 4 * 48 * 8 * 128 * 4      # 1 572 864
    out = 2 * 4 * 8 * 48 * 4              # 12 288
    assert b == q + boxes + out == 1_601_536
    assert costs.bound_s(f, b, costs.B1_PEAK) == pytest.approx(
        1_601_536 / 3.35e12)


def test_b2_at_the_qwen3_round():
    # 4 sequences, 10 selected chunks of 64 rows each, all live
    live = 4 * 10 * 64
    f, b = costs.b2_pooled_cost(4, 16, 8, 128, live, 12, 2)
    rows = live * 8 + 4 * 8
    assert f == 4 * 2 * 128 * rows == 21_004_288
    kv = 2 * live * 8 * 128 * 2           # 10 485 760
    io = 2 * 4 * 16 * 128 * 2 + 2 * 4 * 8 * 128 * 2 + 2 * 4 * 12 * 4 + 16
    assert b == kv + io == 10_485_760 + 49_552


def test_b1_b2_latent_at_the_deepseek_round():
    f, b = costs.b1_latent_cost(4, 16, 576, 40, 2)
    assert f == 8 * 4 * 16 * 40 * 576
    assert b == 4 * 16 * 576 * 2 + 2 * 4 * 40 * 576 * 4 + 2 * 4 * 40 * 4
    f, b = costs.b2_latent_cost(4, 16, 576, 512, 1000, 8, 2)
    assert f == 2 * 16 * 1004 * (576 + 512)
    assert b == (1000 * 576 * 2 + 4 * 16 * 576 * 4 + 4 * 576 * 2
                 + 4 * 16 * 512 * 4 + 2 * 4 * 8 * 4 + 16)


def test_qwen3_token_flops():
    m = _model("qwen3-1.7b")
    d, ff, V = 2048, 6144, 151_936
    attn = d * 2048 + 2 * d * 1024 + 2048 * d      # 12 582 912
    mlp = 3 * d * ff                               # 37 748 736
    assert costs.attn_matmul_params(m) == attn
    assert costs.mlp_matmul_params(m, 5) == mlp
    per_tok = 2.0 * (28 * (attn + mlp) + d * V)
    assert costs.token_matmul_flops(m, logits=True) == per_tok
    # 2 x 1.72e9 parameters a token
    assert per_tok == pytest.approx(2 * 1.7211e9, rel=1e-3)
    assert costs.attn_flops_per_row(m) == 4 * 16 * 128
    rows = [300] * 28
    assert costs.decode_token_flops(m, rows) == per_tok + 8192 * 8400


def test_deepseek_prefill_flops():
    m = _model("deepseek-v2-lite-16b")
    d = 2048
    attn = (d * 16 * 192 + d * 576 + 16 * 512 * 256 + 16 * 128 * d)
    assert costs.attn_matmul_params(m) == attn
    dense = 3 * d * 10_944
    moe = d * 64 + 3 * d * 1408 * 6 + 3 * d * 2816
    assert costs.mlp_matmul_params(m, 0) == dense
    assert costs.mlp_matmul_params(m, 1) == moe
    # 2.4e9 active parameters a token, as published (head and embedding
    # included there; here the embedding is a lookup)
    active = 27 * attn + dense + 26 * moe + d * 102_400
    assert active == pytest.approx(2.4e9, rel=0.05)
    S = 1024
    pf = costs.prefill_flops(m, S)
    assert pf == (S * 2.0 * (27 * attn + dense + 26 * moe)
                  + 2.0 * d * 102_400
                  + 2.0 * 16 * (192 + 128) * S * (S + 1) / 2 * 27)
