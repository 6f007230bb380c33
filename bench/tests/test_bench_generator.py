"""The traffic generator: seeded, and the same work for every seed."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench import generator  # noqa: E402


def test_open_same_seed_same_schedule():
    mix = generator.load_mix("admit_rag")
    a = generator.open_arrivals(mix, 2 ** 31 + 17, 1000)
    b = generator.open_arrivals(mix, 2 ** 31 + 17, 1000)
    assert [x.due for x in a] == [x.due for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_open_seeds_offer_the_same_work():
    mix = generator.load_mix("admit_rag")
    a = generator.open_arrivals(mix, 5, 1000)
    b = generator.open_arrivals(mix, 6, 1000)
    assert [x.due for x in a] == [x.due for x in b]
    assert [len(x.prompt) for x in a] == [len(x.prompt) for x in b]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    lens = [len(x.prompt) for x in a]
    assert min(lens) >= mix["prompt_min"] and max(lens) <= mix["prompt_max"]
    # zipf-tailed toward the short end
    assert np.median(lens) < (mix["prompt_min"] + mix["prompt_max"]) / 2
    assert all(x.max_new == mix["max_new"] for x in a)
    assert [x.due for x in a] == sorted(x.due for x in a)


def test_open_rate_is_the_mix_rate():
    mix = generator.load_mix("admit_rag")
    a = generator.open_arrivals(mix, 1, 1000)
    rate = len(a) / a[-1].due
    assert abs(rate - mix["rate"]) / mix["rate"] < 0.25


def test_closed_sessions():
    mix = generator.load_mix("decode_b4_3k")
    a = generator.closed_sessions(mix, 9, 1000, 4096)
    b = generator.closed_sessions(mix, 9, 1000, 4096)
    c = generator.closed_sessions(mix, 10, 1000, 4096)
    assert [len(x.prompt) for x in a] == [len(x.prompt) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert sorted(len(x.prompt) for x in a) == \
        sorted(len(x.prompt) for x in c)
    assert len(a) == mix["sessions"]
    for x in a:
        assert mix["prompt_min"] <= len(x.prompt) <= mix["prompt_max"]
        assert len(x.prompt) + x.max_new == 4095
        assert x.max_new >= mix["room"] - 1


def test_gen_trace_copy_is_deterministic():
    cfg = generator.TraceCfg(n_requests=50, base_rate=2.0, burst_rate=8.0,
                             scenario="mixed")
    a = generator.gen_trace(cfg, 3)
    assert a == generator.gen_trace(cfg, 3)
    assert a != generator.gen_trace(cfg, 4)
    assert all(x.t < y.t for x, y in zip(a, a[1:]))
