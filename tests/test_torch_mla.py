"""The port's MLA model path and no-drop MoE against ``repro``, on the
deepseek-v2-lite smoke config (MLA kv_lora 32 + rope 8, latent width 40;
4 experts, top-2, one shared), as ``tests/test_mla_chunked_admission.py``
builds it: the same weights (a JAX ``lm.init`` tree carried across with
``params_from_jax``) and the same numpy inputs.

Tolerances: prefill logits within 1e-4 and caches within 1e-5, the bars of
the GQA slices (f32; the frameworks sum in different orders); MLA blocks
and MoE outputs within 1e-5; the routed experts equal.  The plain versions
of B1's and B2's latent variants are held against the reference's jnp
functions they replace (``core/bounds.py:chunk_bounds_mla`` and the
engine's ``chunk_bounds_gqa_matmul`` at one kv head;
``core/sparse_attention.py:sparse_decode_mla`` and the engine's
``_attend_pooled_mla`` / ``_attend_workingset_mla``) within 1e-5.  The
emulation of B2-latent's CUDA arithmetic (``sparse_decode_latent_split_ref``:
TF32 hi + lo scores for f32 q, one global max, fp16 p, split partials) is
held to the plain version and to ``_attend_core_mla`` at full width within
``latent_agreement``'s bar (two probabilities rounded the other way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import bounds as jbounds
from repro.core import sparse_attention as jsa
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.serving import engine as jengine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import bounds as tbounds
from repro_torch.core import sparse_attention as tsa
from repro_torch.kernels.chunk_bounds import ops as cb_ops
from repro_torch.kernels.sparse_decode import ops as sd_ops
from repro_torch.kernels.sparse_decode import ref as sd_ref
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models.common import positions_for
from repro_torch.models.params import params_from_jax

MAX_LEN = 128
LOGIT_TOL, CACHE_TOL, BLOCK_TOL = 1e-4, 1e-5, 1e-5


def _cfg(get):
    cfg = get("deepseek-v2-lite-16b", smoke=True)
    return dataclasses.replace(
        cfg, leoam=dataclasses.replace(cfg.leoam, chunk_size=16,
                                       importance_rate=0.4, early_rate=0.6,
                                       min_seq_for_sparse=32))


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = _cfg(get_config), _cfg(t_get_config)
    params = jlm.init(cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    return cfg, tcfg, params, tparams


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _leaves(tree):
    if isinstance(tree, dict):                 # JAX's order: sorted keys
        for _, v in sorted(tree.items()):
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _block(params, port):
    """Body position 0, repeat 0 (an MoE block) of either tree."""
    blk = params["body"][0]
    if port:
        return tlm.body_block(params, 0, 0)
    return jax.tree.map(lambda a: a[0], blk)


def test_params_carry_over_leaf_for_leaf(setup):
    """The port's parameter tree is the reference's, leaf for leaf: MLA
    (wkv_a, kv_norm, wk_b, wv_b, wq, wo), MoE (f32 router, stacked
    experts, shared experts) and the dense prologue."""
    cfg, tcfg, params, tparams = setup
    jl = list(_leaves(params))
    tl = list(_leaves(tparams))
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    assert tparams["body"][0]["mlp"]["router"].dtype == torch.float32
    assert "wk_b" in tparams["prologue"][0]["core"]
    own = tlm.init(tcfg, seed=3, device="cpu")
    assert [tuple(t.shape) for t in _leaves(own)] == \
        [tuple(t.shape) for t in tl]


def test_full_width_tree_has_the_published_shapes():
    """deepseek-v2-lite-16b at full width: the dense prologue is 10 944
    wide, 64 routed experts of 1408 with 2 shared, latent 512 + 64."""
    tcfg = t_get_config("deepseek-v2-lite-16b")
    defs = tlm.param_defs(tcfg)
    pro = defs["prologue"][0]
    assert pro["mlp"]["w_up"].shape == (2048, 10944)
    assert pro["core"]["wkv_a"].shape == (2048, 576)
    moe = defs["body"][0]["mlp"]
    assert len(defs["prologue"]) + moe["w_up"].shape[0] == 27
    assert moe["w_up"].shape[1:] == (64, 2048, 1408)
    assert moe["shared_w_up"].shape[1:] == (2048, 2 * 1408)
    assert moe["router"].dtype == "float32"
    n = sum(int(np.prod(d.shape)) for d in _leaves(defs))
    assert 15.5e9 < n < 16e9, n


def _x(rng, tcfg, S=24):
    return rng.randn(2, S, tcfg.d_model).astype(np.float32)


def test_mla_q_matches_reference(setup, rng):
    cfg, tcfg, params, tparams = setup
    x = _x(rng, tcfg)
    pos = positions_for(tcfg, 2, x.shape[1])
    jq = jattn._mla_q(_block(params, False)["core"], cfg, jnp.asarray(x),
                      jnp.asarray(pos.numpy()))
    tq = tattn._mla_q(_block(tparams, True)["core"], tcfg,
                      torch.from_numpy(x), pos)
    for t, j in zip(tq, jq):
        _close(t, j, BLOCK_TOL)


def test_mla_train_matches_reference(setup, rng):
    cfg, tcfg, params, tparams = setup
    x = _x(rng, tcfg)
    pos = positions_for(tcfg, 2, x.shape[1])
    want = jattn.mla_train(_block(params, False)["core"], cfg, "attn",
                           jnp.asarray(x), jnp.asarray(pos.numpy()))
    got = tattn.mla_train(_block(tparams, True)["core"], tcfg,
                          torch.from_numpy(x), pos)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("length", [24, 17])
def test_mla_prefill_cache_matches_reference(setup, rng, length):
    """The latent cache with rows at or past ``length`` zeroed, padded to
    max_len, and its two abstract pyramids (``cmax``/``cmin`` over ckv,
    ``rmax``/``rmin`` over krope; f32, the sentinels past ``length``)."""
    cfg, tcfg, params, tparams = setup
    x = _x(rng, tcfg)
    pos = positions_for(tcfg, 2, x.shape[1])
    want = jattn.mla_prefill_cache(_block(params, False)["core"], cfg,
                                   jnp.asarray(x), jnp.asarray(pos.numpy()),
                                   64, length)
    got = tattn.mla_prefill_cache(_block(tparams, True)["core"], tcfg,
                                  torch.from_numpy(x), pos, 64, length)
    assert sorted(got) == sorted(want)
    assert {"ckv", "krope", "cmax0", "rmin0"} <= set(got)
    for name in got:
        _close(got[name], want[name], CACHE_TOL)
    for name in ("ckv", "krope"):
        assert not got[name][:, length:].any()


def _cache_close(tc, jc):
    for part in ("prologue", "body"):
        assert len(tc[part]) == len(jc[part])
        for td, jd in zip(tc[part], jc[part]):
            assert sorted(td) == sorted(jd)
            for name in td:
                _close(td[name], jd[name], CACHE_TOL)


@pytest.mark.parametrize("S,bucket", [(40, False), (40, True), (64, False)])
def test_prefill_matches_reference(setup, S, bucket):
    """Whole-prompt prefill (exact and bucketed): logits within 1e-4,
    the latent caches within 1e-5."""
    cfg, tcfg, params, tparams = setup
    prompt = np.random.RandomState(S).randint(2, cfg.vocab_size, S)
    toks = np.zeros(64 if bucket else S, np.int64)
    toks[:S] = prompt
    jb = {"tokens": jnp.asarray(toks[None].astype(np.int32))}
    tb = {"tokens": torch.from_numpy(toks[None])}
    if bucket:
        jb["length"] = tb["length"] = S
    jl, jc = jlm.prefill(params, cfg, jb, max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tlm.prefill(tparams, tcfg, tb, max_len=MAX_LEN)
    _close(tl, jl, LOGIT_TOL)
    _cache_close(tc, jc)


@pytest.mark.parametrize("S,C", [(41, 16), (64, 32), (100, 64)])
def test_prefill_chunk_matches_reference(setup, S, C):
    """Chunk by chunk (``mla_attn_chunk``): the reference's logits within
    1e-4 and its latent cache within 1e-5; the last chunk's logits are
    whole-prompt prefill's."""
    cfg, tcfg, params, tparams = setup
    prompt = np.random.RandomState(S).randint(2, cfg.vocab_size, S)
    jc = jlm.init_decode_cache(cfg, 1, MAX_LEN)
    tc = tlm.init_decode_cache(tcfg, 1, MAX_LEN, device="cpu")
    for start in range(0, S, C):
        toks = np.zeros(C, np.int64)
        toks[:min(C, S - start)] = prompt[start:start + C]
        jl, jc = jlm.prefill_chunk(
            params, cfg, {"tokens": toks[None].astype(np.int32),
                          "start": start, "length": S}, jc, max_len=MAX_LEN)
        with torch.no_grad():
            tl, tc = tlm.prefill_chunk(
                tparams, tcfg, {"tokens": torch.from_numpy(toks[None]),
                                "start": start, "length": S}, tc,
                max_len=MAX_LEN)
        _close(tl, jl, LOGIT_TOL)
        _cache_close(tc, jc)
    with torch.no_grad():
        whole, _ = tlm.prefill(tparams, tcfg,
                               {"tokens": torch.from_numpy(prompt[None])},
                               max_len=MAX_LEN)
    _close(tl, whole, LOGIT_TOL)


def test_moe_gqa_model_prefill_matches_reference():
    """MoE no longer refuses on its own: moonshot-v1-16b-a3b (GQA, 64
    experts, top-6; smoke: 4 experts, top-2) prefills as the reference."""
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    tcfg = t_get_config("moonshot-v1-16b-a3b", smoke=True)
    params = jlm.init(cfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    prompt = np.random.RandomState(5).randint(2, cfg.vocab_size, 33)
    jl, jc = jlm.prefill(params, cfg,
                         {"tokens": jnp.asarray(prompt[None], jnp.int32)},
                         max_len=64)
    with torch.no_grad():
        tl, tc = tlm.prefill(tparams, tcfg,
                             {"tokens": torch.from_numpy(prompt[None])},
                             max_len=64)
    _close(tl, jl, LOGIT_TOL)
    _close(tc["body"][0]["k"], jc["body"][0]["k"], CACHE_TOL)


def test_init_decode_cache_has_prefills_structure(setup):
    """A zeroed batch-1 latent cache shaped, typed and nested as
    ``prefill``'s."""
    cfg, tcfg, _, tparams = setup
    prompt = np.arange(2, 34)
    with torch.no_grad():
        _, pc = tlm.prefill(tparams, tcfg,
                            {"tokens": torch.from_numpy(prompt[None])},
                            max_len=MAX_LEN)
    zc = tlm.init_decode_cache(tcfg, 1, MAX_LEN, device="cpu")
    for part in ("prologue", "body"):
        for z, p in zip(zc[part], pc[part]):
            assert sorted(z) == sorted(p)
            assert {"ckv", "krope", "cmax0", "rmin0"} <= set(z)
            for name in z:
                assert z[name].shape == p[name].shape
                assert z[name].dtype == p[name].dtype
                assert not z[name].any()


def test_load_prefix_rows_splits_the_latent_plane(setup, rng):
    """The latent branch of ``load_prefix_rows``: a (n, 1, r + rope) plane
    per attention layer lands in ``ckv`` / ``krope`` as the reference's."""
    cfg, tcfg, _, _ = setup
    D = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    n_attn = cfg.n_layers
    rows = [(lat, lat) for lat in
            (rng.randn(32, 1, D).astype(np.float32) for _ in range(n_attn))]
    jc = jlm.load_prefix_rows(cfg, jlm.init_decode_cache(cfg, 1, MAX_LEN),
                              rows, 32)
    tc = tlm.load_prefix_rows(tcfg, tlm.init_decode_cache(
        tcfg, 1, MAX_LEN, device="cpu"), rows, 32)
    _cache_close(tc, jc)


# ---------------------------------------------------------------------------
# No-drop MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 7, 32])
def test_moe_no_drop_matches_reference(setup, rng, T):
    """The routed experts equal the reference's (top-k order included) and
    the outputs agree within 1e-5."""
    cfg, tcfg, params, tparams = setup
    jp = _block(params, False)["mlp"]
    tp = _block(tparams, True)["mlp"]
    x = rng.randn(1, T, cfg.d_model).astype(np.float32)
    want, _ = jmlp.moe_apply(jp, cfg, jnp.asarray(x), no_drop=True)
    got = tmlp.moe_apply(tp, tcfg, torch.from_numpy(x), no_drop=True)
    _close(got, want, BLOCK_TOL)
    xf = jnp.asarray(x.reshape(T, -1))
    probs = jax.nn.softmax(xf @ jp["router"].astype(jnp.float32), axis=-1)
    j_p, j_e = jax.lax.top_k(probs, cfg.moe.top_k)
    t_p, t_e = tmlp.moe_route(tp, tcfg, torch.from_numpy(x.reshape(T, -1)))
    np.testing.assert_array_equal(t_e.numpy(), np.asarray(j_e))
    _close(t_p, j_p / j_p.sum(-1, keepdims=True), BLOCK_TOL)


def test_moe_route_breaks_ties_to_the_lower_expert(setup):
    """Equal router probabilities: ``jax.lax.top_k`` takes the lower
    expert index first, and so does the port's stable descending sort."""
    cfg, tcfg, _, tparams = setup
    tp = dict(_block(tparams, True)["mlp"])
    tp["router"] = torch.zeros_like(tp["router"])
    _, top_e = tmlp.moe_route(tp, tcfg, torch.ones(3, tcfg.d_model))
    assert top_e.tolist() == [list(range(cfg.moe.top_k))] * 3


def test_moe_no_drop_rows_independent_of_batch_shape(setup, rng):
    """Inference MoE dispatch: a token's output is independent of the
    surrounding batch shape — the same rows fed at T=8 and T=32 give
    bitwise-identical outputs on the port's side (the port of the
    reference test of the same name)."""
    _, tcfg, _, tparams = setup
    blk = _block(tparams, True)
    x = torch.from_numpy(rng.randn(1, 32, tcfg.d_model).astype(np.float32))
    y_whole = tlm._apply_mlp(blk, tcfg, "moe", x)
    y_chunk0 = tlm._apply_mlp(blk, tcfg, "moe", x[:, :8])
    assert torch.equal(y_whole[:, :8], y_chunk0)


def test_moe_training_dispatch_matches_reference(setup, rng):
    """The capacity-drop training dispatch (``no_drop=False``, the
    default) runs and equals the reference's: outputs within 1e-5, the aux
    losses within 1e-5 and the drop fraction exactly (32 tokens x top-2
    over 4 experts at capacity factor 0.5: 8 slots an expert, so pairs
    drop).  Gradients: ``tests/test_torch_train_moe.py``."""
    cfg, tcfg, params, tparams = setup
    cfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.5)) for c in (cfg, tcfg))
    x = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    want, jaux = jmlp.moe_apply(_block(params, False)["mlp"], cfg,
                                jnp.asarray(x))
    got, taux = tmlp.moe_apply(_block(tparams, True)["mlp"], tcfg,
                               torch.from_numpy(x))
    _close(got, want, BLOCK_TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k], BLOCK_TOL)
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) > 0


# ---------------------------------------------------------------------------
# Plain versions of B1's and B2's latent variants
# ---------------------------------------------------------------------------


def _latent_boxes(rng, B, nc, D):
    km = rng.randn(B, nc, 1, D).astype(np.float32)
    kn = km - np.abs(rng.randn(B, nc, 1, D)).astype(np.float32)
    return km, kn


@pytest.mark.parametrize("B,H,r,rr,nc", [(2, 4, 32, 8, 5), (4, 16, 512, 64,
                                                             9)])
def test_latent_bounds_plain_matches_reference(rng, B, H, r, rr, nc):
    """B1-latent's plain version is the reference engine's
    ``chunk_bounds_gqa_matmul`` at one kv head and equals the split
    ``chunk_bounds_mla`` (in the reference and in the port)."""
    D = r + rr
    q = rng.randn(B, H, D).astype(np.float32)
    km, kn = _latent_boxes(rng, B, nc, D)
    before = cb_ops.latent_launches
    ub, lb = cb_ops.chunk_bounds_latent(torch.from_numpy(q),
                                        torch.from_numpy(km),
                                        torch.from_numpy(kn))
    assert cb_ops.latent_launches == before     # the CPU takes the plain one
    assert ub.shape == (B, 1, nc)
    j_ub, j_lb = jbounds.chunk_bounds_gqa_matmul(jnp.asarray(q), km, kn)
    _close(ub, j_ub, BLOCK_TOL)
    _close(lb, j_lb, BLOCK_TOL)
    m_ub, m_lb = jbounds.chunk_bounds_mla(
        q[..., :r], q[..., r:], km[:, :, 0, :r], kn[:, :, 0, :r],
        km[:, :, 0, r:], kn[:, :, 0, r:])
    t_ub, t_lb = tbounds.chunk_bounds_mla(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            q[..., :r], q[..., r:], km[:, :, 0, :r], kn[:, :, 0, :r],
            km[:, :, 0, r:], kn[:, :, 0, r:])))
    _close(t_ub, m_ub, BLOCK_TOL)
    _close(t_lb, m_lb, BLOCK_TOL)
    _close(ub[:, 0], m_ub, BLOCK_TOL)
    _close(lb[:, 0], m_lb, BLOCK_TOL)


def test_sparse_decode_mla_matches_reference(rng):
    B, H, r, rr, S, chunk = 2, 4, 32, 8, 128, 16
    q_lat = rng.randn(B, H, r).astype(np.float32)
    q_rope = rng.randn(B, H, rr).astype(np.float32)
    ckv = rng.randn(B, S, r).astype(np.float32)
    krope = rng.randn(B, S, rr).astype(np.float32)
    ids = np.stack([rng.choice(S // chunk, 5, replace=False)
                    for _ in range(B)])[:, None].astype(np.int32)
    length = np.array([100, 70], np.int32)
    want = jsa.sparse_decode_mla(q_lat, q_rope, ckv, krope, ids, chunk,
                                 length=length)
    got = tsa.sparse_decode_mla(*(torch.from_numpy(a) for a in (
        q_lat, q_rope, ckv, krope, ids)), chunk,
        length=torch.from_numpy(length))
    for g, w in zip(got, want):
        _close(g, w, BLOCK_TOL)
    _close(tsa._finish(got), jsa._finish(want), BLOCK_TOL)


def _latent_pool(rng, B, H, r, rr, chunk, n_slots, nmax, qdtype=np.float32):
    D = r + rr
    pool = rng.randn(n_slots + 1, 1, chunk, 1, D).astype(np.float16)
    q_lat = (rng.randn(B, H, r) / np.sqrt(D)).astype(qdtype)
    q_rope = (rng.randn(B, H, rr) / np.sqrt(D)).astype(qdtype)
    lat_new = rng.randn(B, D).astype(qdtype)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(1, nmax + 1)
        slots[b, :n] = rng.choice(n_slots, n, replace=False)
        cids[b, :n] = np.sort(rng.choice(4 * nmax, n, replace=False))
        lengths[b] = cids[b, n - 1] * chunk + rng.randint(1, chunk + 1)
    return pool, q_lat, q_rope, lat_new, slots, cids, lengths


@pytest.mark.parametrize("B,H,r,rr,chunk,nmax", [(2, 4, 32, 8, 16, 6),
                                                 (3, 16, 64, 16, 32, 9)])
def test_latent_attend_plain_matches_reference(rng, B, H, r, rr, chunk,
                                               nmax):
    """B2-latent's plain version, then W_UV in f32 and ``wo``, against the
    reference engine's ``_attend_pooled_mla`` and, over the gathered
    working set, ``_attend_workingset_mla``."""
    pool, q_lat, q_rope, lat_new, slots, cids, lengths = _latent_pool(
        rng, B, H, r, rr, chunk, 3 * nmax, nmax)
    vd, d = 16, 24
    wv_b = (rng.randn(H, r, vd) / np.sqrt(r)).astype(np.float32)
    wo = (rng.randn(H * vd, d) / np.sqrt(H * vd)).astype(np.float32)
    want = jengine._attend_pooled_mla(q_lat, q_rope, pool, slots, cids,
                                      lengths, lat_new, wv_b, wo)
    before = sd_ops.latent_launches
    q = torch.from_numpy(np.concatenate([q_lat, q_rope], -1))
    t = {k: torch.from_numpy(v) for k, v in dict(
        pool=pool, slots=slots, cids=cids, lengths=lengths,
        lat_new=lat_new).items()}
    out_lat = sd_ops.sparse_decode_latent_pooled(
        q, t["pool"], t["slots"], t["cids"], t["lengths"], t["lat_new"], r)
    assert out_lat.dtype == torch.float32 and out_lat.shape == (B, H, r)

    def project(o):
        o = torch.einsum("bhr,hrv->bhv", o, torch.from_numpy(wv_b))
        return o.reshape(B, 1, -1) @ torch.from_numpy(wo)

    _close(project(out_lat), want, BLOCK_TOL)
    latg = pool[slots].reshape(B, nmax, chunk, 1, r + rr)
    ws = sd_ops.sparse_decode_latent_workingset(
        q, torch.from_numpy(latg), t["cids"], t["lengths"], t["lat_new"], r)
    assert torch.equal(ws, out_lat)
    pos = (cids[..., None] * chunk + np.arange(chunk)).reshape(B, -1)
    valid = (cids[..., None] >= 0).repeat(chunk, -1).reshape(B, -1) \
        & (pos < lengths[:, None])
    valid = np.concatenate([valid, np.ones((B, 1), bool)], 1)[:, None, None]
    want_ws = jengine._attend_workingset_mla(q_lat, q_rope, latg, lat_new,
                                             valid, wv_b, wo)
    _close(project(ws), want_ws, BLOCK_TOL)
    assert sd_ops.latent_launches == before


def test_latent_attend_plain_matches_sparse_decode_mla(rng):
    """Over a cache laid out as pool slots, the plain B2-latent is the
    reference's ``sparse_decode_mla`` finished (the round's own row
    placed at position ``length``)."""
    B, H, r, rr, chunk = 2, 4, 32, 8, 16
    D, nc = r + rr, 8
    cache = rng.randn(B, nc * chunk, D).astype(np.float16)
    lengths = np.array([100, 70], np.int32)
    lat_new = np.stack([cache[b, lengths[b]] for b in range(B)])
    q = (rng.randn(B, H, D) / np.sqrt(D)).astype(np.float32)
    ids = np.stack([np.sort(rng.choice(
        np.arange(int(lengths[b]) // chunk), 3, replace=False))
        for b in range(B)]).astype(np.int32)
    last = (lengths // chunk).astype(np.int32)[:, None]
    ids = np.concatenate([ids, last], 1)               # the row at length
    pool = cache.reshape(B * nc, 1, chunk, 1, D)
    slots = (ids + np.arange(B)[:, None] * nc).astype(np.int32)
    got = sd_ops.sparse_decode_latent_pooled(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(slots),
        torch.from_numpy(ids), torch.from_numpy(lengths),
        torch.from_numpy(lat_new), r)
    part = jsa.sparse_decode_mla(q[..., :r], q[..., r:],
                                 cache[..., :r].astype(np.float32),
                                 cache[..., r:].astype(np.float32),
                                 ids[:, None], chunk, length=lengths + 1)
    _close(got, jsa._finish(part), 1e-3)


def test_latent_bar_sees_unrounded_probabilities():
    """The card's agreement bar for B2-latent (``latent_agreement``) sees
    a P.V that leaves each probability unrounded: on ``tied_latent_case``
    the plain version over an f32 pool misses it by more than four bars,
    while the plain version with the selection reversed (the same rows
    summed in another order) stays within it."""
    from repro_torch.kernels.sparse_decode import ref as sd_ref
    q, pool, slots, cids, lengths, lat_new = sd_ref.tied_latent_case(
        torch.device("cpu"))
    args = (lengths, lat_new, 512)
    ref = sd_ref.sparse_decode_latent_pooled_ref(q, pool, slots, cids, *args)
    den = sd_ref.latent_pooled_den(q, pool, slots, cids, *args)
    rows = (pool, lat_new)
    flipped = sd_ref.sparse_decode_latent_pooled_ref(
        q, pool, slots.flip(-1), cids.flip(-1), *args)
    err, bar = sd_ref.latent_agreement(flipped, ref, rows, den)
    assert err <= bar, (err, bar)
    unrounded = sd_ref.sparse_decode_latent_pooled_ref(
        q, pool.float(), slots, cids, *args)
    err_u, _ = sd_ref.latent_agreement(unrounded, ref, rows, den)
    assert err_u > 4 * bar, (err_u, bar)


# ---------------------------------------------------------------------------
# The emulation of B2-latent's CUDA arithmetic and its split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nsel,chunk,batch", [
    (0, 64, 4), (1, 64, 1), (3, 16, 2), (12, 64, 4), (16, 64, 4),
    (44, 64, 4), (200, 64, 1), (512, 64, 1), (5, 100, 3), (6, 8, 2),
])
def test_latent_split_plan_covers_every_row_once(nsel, chunk, batch):
    """B2-latent's launch plan: the scores launch's tiles cover every row
    of every entry exactly once, within one entry, and reach
    LAT_BLOCKS1 blocks where 16-row tiles allow it (the serve, 12 entries
    of 64 rows for 4 sequences: 32-row tiles, 96 blocks); the P.V launch's
    splits (at most one cluster of 8) cover every live row of a sequence
    exactly once, in order, in runs of a multiple of 16 rows, the new
    token's row in the last split that has rows."""
    tr1, nblk1, nsplit = sd_ops.latent_split_plan(nsel, chunk, batch)
    assert tr1 % 8 == 0 and 8 <= tr1 <= 64 and 1 <= nsplit <= 8
    tpe = -(-chunk // tr1)
    assert nblk1 == max(1, nsel * tpe)
    tiles = [(blk // tpe, (blk % tpe) * tr1, min(chunk, (blk % tpe + 1) * tr1))
             for blk in range(nsel * tpe)]
    assert [(j, r) for j, lo, hi in tiles for r in range(lo, hi)] == \
        [(j, r) for j in range(nsel) for r in range(chunk)]
    if tr1 > min(16, -(-chunk // 8) * 8):
        assert batch * nblk1 >= sd_ops.LAT_BLOCKS1
    if (nsel, chunk, batch) == (12, 64, 4):
        assert (tr1, batch * nblk1, nsplit) == (32, 96, 4)
    for n_live in {1, 17, nsel * chunk // 2 + 1, nsel * chunk + 1}:
        runs = sd_ops.latent_split_rows(n_live, nsplit)
        assert len(runs) == nsplit
        assert [k for lo, hi in runs for k in range(lo, hi)] == \
            list(range(n_live))
        last = max(i for i, (lo, hi) in enumerate(runs) if hi > lo)
        assert runs[last][1] == n_live
        assert all((hi - lo) % 16 == 0 for lo, hi in runs[:last])


def _jax_out_lat(q, lat, lat_new, valid, r):
    """The reference's ``_attend_core_mla`` out_lat (B, H, r): one head at
    a time, with W_UV and ``wo`` the identity (exact in f32); q f32."""
    eye = np.eye(r, dtype=np.float32)
    core = jax.jit(jengine._attend_core_mla)
    return np.stack([
        np.asarray(core(q[:, h:h + 1, :r], q[:, h:h + 1, r:], lat, lat_new,
                        valid, eye[None], eye), np.float32)
        .reshape(q.shape[0], r) for h in range(q.shape[1])], axis=1)


@pytest.mark.parametrize("qdtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("padded", [False, True])
def test_latent_split_emulation_matches_plain_and_reference(rng, qdtype,
                                                            padded):
    """B2-latent's CUDA arithmetic emulated in plain PyTorch, at
    deepseek-v2-lite's full width (H 16, r 512 + rope 64, chunk 64, 12
    entries), against the plain version and the reference's
    ``_attend_core_mla`` within ``latent_agreement``'s bar, for the plan
    the kernel picks, one split and eight; ``padded``
    leaves sequence 1 all padding but the new row."""
    B, H, r, rr, chunk, nmax = 4, 16, 512, 64, 64, 12
    pool, q_lat, q_rope, lat_new, slots, cids, lengths = _latent_pool(
        rng, B, H, r, rr, chunk, 3 * nmax, nmax, qdtype)
    if padded:
        cids[1] = -1
    q32 = np.concatenate([q_lat, q_rope], -1).astype(np.float32)
    new32 = lat_new.astype(np.float32)
    tdt = torch.float32 if qdtype == np.float32 else torch.bfloat16
    args = (torch.from_numpy(q32).to(tdt), torch.from_numpy(pool),
            torch.from_numpy(slots), torch.from_numpy(cids),
            torch.from_numpy(lengths), torch.from_numpy(new32).to(tdt), r)
    ref = sd_ref.sparse_decode_latent_pooled_ref(*args)
    den = sd_ref.latent_pooled_den(*args)
    rows = (args[1], args[5])
    lat = pool[slots][:, :, 0].reshape(B, nmax * chunk, r + rr)
    pos = (cids[..., None] * chunk + np.arange(chunk)).reshape(B, -1)
    valid = (cids[..., None] >= 0).repeat(chunk, -1).reshape(B, -1) \
        & (pos < lengths[:, None])
    valid = np.concatenate([valid, np.ones((B, 1), bool)], 1)[:, None, None]
    want = torch.from_numpy(_jax_out_lat(q32, lat, new32, valid, r))
    for nsplit in (sd_ops.latent_split_plan(nmax, chunk, B)[2], 1, 8):
        out = sd_ref.sparse_decode_latent_split_ref(*args, nsplit=nsplit)
        assert out.shape == (B, H, r) and out.dtype == torch.float32
        for other in (ref, want):
            err, bar = sd_ref.latent_agreement(out, other, rows, den)
            assert err <= bar, (nsplit, err, bar)
    if padded:          # p = 1 on the new row alone: its fp16 values
        torch.testing.assert_close(
            out[1], args[5][1, :r].half().float().expand(H, r),
            rtol=0, atol=0)


def test_latent_split_emulation_rounds_p_on_the_tied_case():
    """On ``tied_latent_case`` (every probability of a head one value a
    quarter fp16 ulp or more from fp16) the emulation rounds p as the
    plain version does, within ``latent_agreement``'s bar for every split
    plan, which an unrounded P.V misses by more than four bars."""
    q, pool, slots, cids, lengths, lat_new = sd_ref.tied_latent_case(
        torch.device("cpu"))
    args = (q, pool, slots, cids, lengths, lat_new, 512)
    ref = sd_ref.sparse_decode_latent_pooled_ref(*args)
    den = sd_ref.latent_pooled_den(*args)
    nsel, chunk, B = slots.shape[1], pool.shape[2], slots.shape[0]
    for nsplit in (sd_ops.latent_split_plan(nsel, chunk, B)[2], 1, 8):
        out = sd_ref.sparse_decode_latent_split_ref(*args, nsplit=nsplit)
        err, bar = sd_ref.latent_agreement(out, ref, (pool, lat_new), den)
        assert err <= bar, (nsplit, err, bar)
    unrounded = sd_ref.sparse_decode_latent_split_ref(
        q, pool.float(), slots, cids, lengths, lat_new, 512, nsplit=1)
    err_u, _ = sd_ref.latent_agreement(unrounded, ref, (pool, lat_new), den)
    assert err_u > 4 * bar, (err_u, bar)


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 40, 2.0 ** -40])
def test_latent_split_scores_hi_lo_within_f32(rng, scale):
    """f32 q as two TF32 terms (hi, and lo = the TF32 rounding of q - hi)
    against exact fp16 rows: each product's error is ~2^-22 relative, so
    the score sits within a few f32 ulps of the f64 dot product (q alone
    rounded to TF32 is 2^-11 off); at any exponent."""
    from repro_torch.kernels.pq.ref import tf32_round
    q = torch.from_numpy((rng.randn(16, 576) * scale).astype(np.float32))
    rows = torch.from_numpy(rng.randn(64, 576).astype(np.float16))
    hi = tf32_round(q, "nearest")
    lo = tf32_round(q - hi, "nearest")
    exact = q.double() @ rows.double().T
    split = (hi.double() @ rows.double().T + lo.double() @ rows.double().T)
    one = hi.double() @ rows.double().T
    mag = q.double().abs() @ rows.double().abs().T
    assert ((split - exact).abs() <= 2.0 ** -21 * mag).all()
    assert ((one - exact).abs() > 2.0 ** -18 * mag).any()
