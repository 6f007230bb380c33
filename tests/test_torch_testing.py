"""``repro_torch.testing``: the helpers that hold ``lm.decode_step`` on the
card against its plain run (``chip_smoke.py`` phase 4l and the card
tests).  Here, on the CPU: the replay hands the recorded selections back
in order, the agreement checks accept sums in another order and refuse a
wrong or non-finite value, and the call checker passes plain calls
through untouched."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import sparse_attention as sa
from repro_torch.core.abstracts import NEG
from repro_torch.kernels.chunk_bounds import ops as cb
from repro_torch.kernels.sparse_decode import ops as sd
from repro_torch.kernels.sparse_decode.ref import sparse_decode_ref
from repro_torch.models import lm
from repro_torch.testing import (TOL_BOUNDS_REL, bounds_agreement,
                                 check_decode_kernels, replay_selections,
                                 triple_agreement)


def _decode(cfg, params, toks, steps, ctx):
    with ctx, torch.no_grad():
        logits, cache = lm.prefill(params, cfg, {"tokens": toks}, max_len=64)
        tok, out = logits.argmax(-1), []
        for step in range(steps):
            lg, cache = lm.decode_step(params, cfg, cache, {"token": tok},
                                       toks.shape[1] + step)
            out.append(lg)
            tok = lg.argmax(-1)
    return out


def test_replay_hands_back_the_recorded_selections():
    """A recorded run replayed gives its logits bitwise and pairs each
    layer step's own ids with the replayed ones; replaying another
    selection (every id reversed in order, the same chunks) changes the
    sums' order only."""
    cfg = get_config("longchat-7b-32k", smoke=True)
    cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, chunk_size=8, min_seq_for_sparse=32))
    params = lm.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        2, cfg.vocab_size, (2, 40)))
    rec, pairs = [], []
    want = _decode(cfg, params, toks, 3, replay_selections(record=rec))
    assert len(rec) == 3 * sum(k != "attn_local" for k in cfg.layer_kinds())
    got = _decode(cfg, params, toks, 3,
                  replay_selections(replay=rec, pairs=pairs))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(pairs) == len(rec)
    assert all(torch.equal(own, r) for own, r in pairs)
    assert sa.pyramid_select_gqa.__name__ == "pyramid_select_gqa"
    flipped = _decode(cfg, params, toks, 3, replay_selections(
        replay=[r.flip(-1) for r in rec]))
    for a, b in zip(flipped, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", ["order", "live", "sentinel", "nan"])
def test_bounds_agreement(case):
    """B1's bar: relative to the larger of a bound and the largest live
    bound, so a ±1e30 box's bound may differ by its own f32 rounding but a
    live bound only by 1e-5 of the live scale; a non-finite bound fails."""
    rng = np.random.RandomState(1)
    want = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    want[..., -4:] = NEG * 37.0                 # sentinel chunks
    got = want.clone()
    if case == "order":
        got[..., :12] *= 1 + 1e-6
        got[..., -4:] *= 1 + 1e-6
    elif case == "live":
        got[0, 0, 0] += 3 * TOL_BOUNDS_REL * want[..., :12].abs().max()
    elif case == "sentinel":
        got[..., -4:] *= 1 + 1e-4
    else:
        got[1, 2, 3] = float("nan")
    row = bounds_agreement((got, -got), (want, -want))
    assert row["ok"] == (case == "order"), row
    assert row["finite"] == (case != "nan")


def test_triple_agreement_sees_a_skipped_rounding():
    """B2's check at bf16: the plain version against itself with each
    selection reversed passes; with an f32 q (probabilities unrounded)
    it fails."""
    from repro_torch.kernels.sparse_decode.ref import tied_contract_case
    q, k, v, ids, length = tied_contract_case(torch.device("cpu"))
    want = sparse_decode_ref(q, k, v, ids, length, chunk=64)
    same = sparse_decode_ref(q, k, v, ids.flip(-1), length, chunk=64)
    assert triple_agreement(same, want, v, torch.bfloat16)["ok"]
    skip = sparse_decode_ref(q.float(), k, v, ids, length, chunk=64)
    assert not triple_agreement(skip, want, v, torch.bfloat16)["ok"]


def test_check_decode_kernels_passes_plain_calls_through():
    """On the CPU (no kernel launches) the checker records nothing, the
    path's results are unchanged, and the wrappers are restored."""
    own = (cb.chunk_bounds, cb.chunk_bounds_gqa, sd.sparse_decode)
    cfg = get_config("longchat-7b-32k", smoke=True)
    cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, chunk_size=8, min_seq_for_sparse=32))
    params = lm.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        2, cfg.vocab_size, (2, 40)))
    checks = {}
    got = _decode(cfg, params, toks, 2, check_decode_kernels(checks))
    want = _decode(cfg, params, toks, 2, replay_selections(record=[]))
    assert checks == {}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cb.chunk_bounds, cb.chunk_bounds_gqa, sd.sparse_decode) == own
