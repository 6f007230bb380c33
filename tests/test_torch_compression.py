"""Transit-codec properties (paper §4.4 dynamic compression) of the port's
numpy codec (``repro_torch.core.compression``), ported from
``tests/test_compression.py``; each case also holds the port's payload and
scales bitwise equal to ``repro.core.compression``'s on the same input."""

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import compression as jcomp
from repro_torch.core.compression import (codec_ratio, dequantize,
                                          dequantize_chunks, quantize,
                                          quantize_chunks, quantization_rmse)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from(["int8", "int4"]))
def test_roundtrip_error_bound(seed, codec):
    """Per-channel symmetric quantization error <= scale/2 elementwise, and
    the payload and scales equal the reference's bit for bit."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 128, 32) * rng.uniform(0.1, 5)).astype(np.float32)
    q = quantize(x, codec, group=64)
    xq = dequantize(q, group=64, dtype=np.float32)
    qmax = 127.0 if codec == "int8" else 7.0
    bound = q.scale.repeat(64, axis=1)[:, :128] / 2 + 1e-6   # (2, 2, 32)
    assert np.all(np.abs(xq - x) <= bound)
    jq = jcomp.quantize(jnp.asarray(x), codec, group=64)
    np.testing.assert_array_equal(q.data, np.asarray(jq.data))
    np.testing.assert_array_equal(q.scale, np.asarray(jq.scale))
    assert np.abs(q.data.astype(np.int32)).max() <= (255 if codec == "int4"
                                                     else qmax)


def test_int4_packing_halves_bytes(rng):
    x = rng.randn(2, 64, 64).astype(np.float32)
    q8 = quantize(x, "int8", group=64)
    q4 = quantize(x, "int4", group=64)
    assert q4.data.size * 2 == q8.data.size
    assert codec_ratio("int4") < codec_ratio("int8") < 1.0
    for codec in ("int4", "int8"):
        assert codec_ratio(codec) == jcomp.codec_ratio(codec)


def test_rmse_ordering(rng):
    x = rng.randn(4, 128, 64).astype(np.float32)
    assert quantization_rmse(x, "int8") < quantization_rmse(x, "int4") < 0.2
    for codec in ("int4", "int8"):
        assert quantization_rmse(x, codec) == pytest.approx(
            jcomp.quantization_rmse(x, codec), rel=1e-6)


@pytest.mark.parametrize("codec", ["int4", "int8"])
def test_quantize_chunks_payload_matches_codec_ratio_exactly(rng, codec):
    """The transit payload of a chunk stack is EXACTLY chunk_bytes ×
    codec_ratio(codec, group=chunk), and equals the reference's."""
    n, c, H, hd = 5, 16, 2, 8
    k = rng.randn(n, c, H, hd).astype(np.float16)
    data, scale = quantize_chunks(k, codec)
    payload = data.nbytes + scale.nbytes
    fp16 = n * c * H * hd * 2
    assert payload == fp16 * codec_ratio(codec, group=c)
    assert codec_ratio(codec, group=c) == pytest.approx(
        {"int4": 0.25, "int8": 0.5}[codec] + 2.0 / c)
    jdata, jscale = jcomp.quantize_chunks(k, codec)
    np.testing.assert_array_equal(data, np.asarray(jdata))
    np.testing.assert_array_equal(scale, np.asarray(jscale))


@pytest.mark.parametrize("codec", ["int4", "int8"])
def test_quantize_chunks_roundtrip_bound(rng, codec):
    """Chunk-grouped transit roundtrip obeys the scale/2 elementwise bound
    of symmetric quantization, and dequantizes to the reference's values."""
    n, c, H, hd = 4, 32, 2, 8
    k = (rng.randn(n, c, H, hd) * rng.uniform(0.1, 4)).astype(np.float16)
    data, scale = quantize_chunks(k, codec)
    kq = dequantize_chunks(data, scale, codec, H, hd, dtype=np.float32)
    bound = scale.reshape(n, 1, H, hd) / 2 + 2e-3   # + fp16 storage noise
    assert np.all(np.abs(kq - k.astype(np.float32)) <= bound)
    jkq = jcomp.dequantize_chunks(data, scale, codec, H, hd,
                                  dtype=np.float32)
    np.testing.assert_array_equal(kq, np.asarray(jkq))
