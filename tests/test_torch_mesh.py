"""The port's device mesh (ROADMAP A12b) against the reference's mesh.

One reference subprocess runs with four host devices
(``--xla_force_host_platform_device_count=4``, as
``tests/test_sharding.py`` runs its own) and writes its weights, inputs
and outputs to ``tmp_path``:

- the sequence-sharded LeoAM decode, ``make_jitted_prefill`` then three
  ``make_jitted_decode`` steps from 320-token prompts into a 512-row
  cache, batch 4: longchat smoke sparse on a (1, 4) mesh (shard 3 holds
  no token, shard 2 is partly filled), the same dense on (2, 2),
  deepseek-v2-lite smoke (MLA) sparse on (1, 4), and gemma2-2b smoke on
  (2, 2) (its local-window layers decode dense with the shards' global
  positions, its global ones sparse, with a softcap);
- one ``make_jitted_train_step`` of qwen3-1.7b smoke on (2, 2), batch 8 x
  64 (``tests/test_sharding.py``'s setup), and a checkpoint of its state
  restored onto the mesh; the same step with two microbatches and some
  targets -1 (a microbatch is a slice of the global batch, each rank's
  share of its valid targets differs); and one of deepseek-v2-lite smoke
  (MoE) at capacity factor 0.5, so that experts drop, with block remat
  (the whole batch's capacity, expert ranks and routing statistics are
  reduced over the batch axes, in the forward and in its recompute) and
  f32 Adam moments (the case is about the routing, not bf16 moments).

Then one ``launch.mesh.run_ranks`` of four gloo ranks on the CPU runs the
port's counterparts on the same inputs; the ranks meet through a
``file://`` store in ``tmp_path`` (tier-1 runs several workers at once).
Each rank reports its rows and blocks, and the test holds them to the
reference's:

- logits within ``LOGIT_TOL`` and the caches, gathered whole, within
  ``CACHE_TOL`` (as ``tests/test_torch_decode.py``); every sparse layer's
  chunk ids on every shard equal (each shard selects with its own budget,
  which ``tests/test_sharding.py`` calls a documented approximation of
  the local decode: the port is held to the reference's sharded decode,
  never to the local one);
- each train step's loss, norms and state within 1e-4 of each leaf's
  scale (the A12a bar), the state a DTensor tree laid out by
  ``state_specs``;
- a ``Checkpointer`` save from the mesh, ``restore(shardings=)`` of the
  reference's checkpoint and an elastic ``reshard_tree`` onto a (1, 4)
  mesh, each bitwise;
- a combine over a one-rank axis bitwise equal to ``_finish``, and
  ``constrain`` / ``constrain_priority`` redistributing a DTensor to its
  logical axes' spec under the mesh's context (``current_mesh``).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL, CACHE_TOL, TRAIN_TOL = 1e-4, 1e-5, 1e-4
CHUNK = 8                    # the smoke configs' base chunk
REF_TIMEOUT_S, RANKS_TIMEOUT_S = 600, 600
DECODE_CASES = ("sparse", "dense", "mla", "gemma")
# train step cases: config overrides and whether some targets are -1
TRAIN_CASES = {
    "train": dict(arch="qwen3-1.7b", runtime={}, moe={}, masked=False),
    "train_mb": dict(arch="qwen3-1.7b", runtime={"microbatches": 2},
                     moe={}, masked=True),
    "train_moe": dict(arch="deepseek-v2-lite-16b",
                      runtime={"remat": "block", "adam_dtype": "float32"},
                      moe={"capacity_factor": 0.5}, masked=False),
}

REF_SCRIPT = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpointer import Checkpointer
from repro.configs import get_config
from repro.configs.base import ShapeCfg
from repro.core import adaptive as jad
from repro.core import sparse_attention as jsa
from repro.launch import steps as stp
from repro.launch.mesh import make_host_mesh, set_mesh
from repro.models import lm
from repro.optim import adamw
from repro.sharding import partition as pt

OUT = sys.argv[1]
IDS = []


def spy(fn):
    # each shard's selection, with its global base-chunk offset
    def s(*a, **kw):
        ids = fn(*a, **kw)
        jax.debug.callback(lambda o, x: IDS.append((int(o), np.asarray(x))),
                           kw.get("chunk_offset", 0), ids)
        return ids
    return s


jsa.pyramid_select_gqa = spy(jsa.pyramid_select_gqa)
jsa.flat_select_gqa = spy(jsa.flat_select_gqa)
jad.pyramid_select_mla = spy(jad.pyramid_select_mla)
np_tree = lambda t: jax.tree.map(np.asarray, t)


def take_ids():
    jax.effects_barrier()
    out = list(IDS)
    IDS.clear()
    return out


def decode_case(arch, mesh_shape, dense, B=4, S=512, P0=320, n=3):
    cfg = get_config(arch, smoke=True)
    if dense:
        cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
            cfg.leoam, min_seq_for_sparse=10 ** 9))
    params = lm.init(cfg, jax.random.PRNGKey(0))
    mesh = make_host_mesh(*mesh_shape)
    prompt = np.random.RandomState(7).randint(1, cfg.vocab_size, (B, P0))
    res = {"arch": arch, "mesh": mesh_shape, "dense": dense, "B": B,
           "S": S, "P0": P0, "params": np_tree(params), "prompt": prompt,
           "tokens": [], "logits": [], "ids": []}
    db = pt.decode_batch_axes(mesh, B)
    with set_mesh(mesh):
        ps = jax.device_put(params, stp.param_shardings(cfg, mesh))
        pf = stp.make_jitted_prefill(cfg, mesh, ShapeCfg("p", S, B, "prefill"))
        toks = jax.device_put(jnp.asarray(prompt, jnp.int32), NamedSharding(
            mesh, P(pt.batch_axes(mesh) or None, None)))
        lg, cache = pf(ps, {"tokens": toks})
        take_ids()
        res["prefill_logits"] = np.asarray(lg)
        jd = stp.make_jitted_decode(cfg, mesh, ShapeCfg("d", S, B, "decode"))
        tok = np.asarray(lg).argmax(-1)
        for t in range(n):
            tk = jax.device_put(jnp.asarray(tok, jnp.int32),
                                NamedSharding(mesh, P(db or None)))
            lg, cache = jd(ps, cache, {"token": tk}, jnp.int32(P0 + t))
            res["tokens"].append(tok)
            res["logits"].append(np.asarray(lg))
            res["ids"].append(take_ids())
            tok = np.asarray(lg).argmax(-1)
        res["cache"] = np_tree(cache)
    return res


def train_cfg(case):
    cfg = get_config(case["arch"], smoke=True)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, **case["runtime"]))
    if case["moe"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    return cfg


def train_case(case, root=None):
    cfg = train_cfg(case)
    mesh = make_host_mesh(2, 2)
    tcfg = stp.TrainCfg(lr=1e-3, warmup_steps=2, total_steps=10)
    params = lm.init(cfg, jax.random.PRNGKey(0))
    state = {"params": params, "opt": adamw.init_opt_state(params, tcfg.adam)}
    B, S = 8, 64
    tokens = np.random.RandomState(0).randint(1, cfg.vocab_size, (B, S))
    tokens = tokens.astype(np.int32)
    targets = tokens.copy()
    if case["masked"]:
        targets[np.random.RandomState(1).rand(B, S) < 0.25] = -1
        targets[0] = -1
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    res = {"state": np_tree(state), "tokens": tokens, "targets": targets,
           "B": B, "S": S}
    with set_mesh(mesh):
        jitted, ss, bspec = stp.make_jitted_train_step(
            cfg, mesh, tcfg, ShapeCfg("t", S, B, "train"))
        sh = jax.tree.map(lambda p: NamedSharding(mesh, p), ss,
                          is_leaf=lambda x: isinstance(x, P))
        st = jax.device_put(jax.tree.map(jnp.copy, state), sh)
        bt = jax.device_put(batch, jax.tree.map(
            lambda p: NamedSharding(mesh, p), bspec,
            is_leaf=lambda x: isinstance(x, P)))
        s2, m2 = jitted(st, bt)
        res["after"] = np_tree(s2)
        res["metrics"] = {k: float(v) for k, v in m2.items()}
        if root is not None:
            ck = Checkpointer(os.path.join(root, "ckpt"), async_save=False)
            ck.save(1, s2, block=True)
            back, _ = ck.restore(jax.tree.map(np.asarray, s2), shardings=sh)
            res["restored"] = np_tree(back)
    return res


TRAIN_CASES = @TRAIN_CASES@
cases = {"sparse": decode_case("longchat-7b-32k", (1, 4), False),
         "dense": decode_case("longchat-7b-32k", (2, 2), True),
         "mla": decode_case("deepseek-v2-lite-16b", (1, 4), False),
         "gemma": decode_case("gemma2-2b", (2, 2), False),
         **{name: train_case(case, os.path.dirname(OUT) if name == "train"
                             else None)
            for name, case in TRAIN_CASES.items()}}
with open(OUT, "wb") as f:
    pickle.dump(cases, f)
"""


# ---------------------------------------------------------------------------
# The port's side: one function every rank runs
# ---------------------------------------------------------------------------


def _spy_ids(record):
    """Every sparse layer's selection in the port, with the shard's global
    base-chunk offset (the reference's spy records the same)."""
    from repro_torch.core import sparse_attention as tsa
    from repro_torch.models import attention as tattn

    def spy(fn):
        def s(*a, **kw):
            ids = fn(*a, **kw)
            record.append((int(kw.get("chunk_offset", 0)), ids.numpy().copy()))
            return ids
        return s
    for mod, name in ((tsa, "pyramid_select_gqa"), (tsa, "flat_select_gqa"),
                      (tattn, "pyramid_select_mla")):
        setattr(mod, name, spy(getattr(mod, name)))


def _numpy_tree(tree):
    from repro_torch.models.params import tree_map
    return tree_map(lambda t: t.numpy().copy(), tree)


def _decode_rank(case, ids):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import params_from_jax
    from repro_torch.sharding.ctx import mesh_coords
    cfg = get_config(case["arch"], smoke=True)
    if case["dense"]:
        cfg = dataclasses.replace(cfg, leoam=dataclasses.replace(
            cfg.leoam, min_seq_for_sparse=10 ** 9))
    B, S, P0 = case["B"], case["S"], case["P0"]
    params = params_from_jax(case["params"], "cpu")
    mesh = make_host_mesh(*case["mesh"], device="cpu")
    shape = ShapeCfg("d", S, B, "decode")
    out = {"coords": mesh_coords(mesh), "logits": [], "ids": []}
    with torch.no_grad():
        prefill = steps.make_jitted_prefill(cfg, mesh, ShapeCfg(
            "p", S, B, "prefill"))
        lg, cache = prefill(params, {"tokens": case["prompt"]})
        out["prefill_logits"] = lg.numpy().copy()
        ids.clear()
        decode = steps.make_jitted_decode(cfg, mesh, shape)
        for t in range(len(case["tokens"])):
            lg, cache = decode(params, cache, {"token": case["tokens"][t]},
                               P0 + t)
            out["logits"].append(lg.numpy().copy())
            out["ids"].append(list(ids))
            ids.clear()
        ctx = steps.decode_ctx(cfg, mesh, shape)
        out["rows"] = ctx.batch_axes
        out["cache"] = _numpy_tree(lm.unshard_cache(cache, ctx))
        if case["mesh"] == (1, 4):
            # a combine over the one-rank ``data`` axis is _finish's
            from repro_torch.core import sparse_attention as tsa
            g = torch.Generator().manual_seed(5)
            p = tsa.Partials(torch.randn(4, 8, 16, generator=g),
                             torch.rand(4, 8, generator=g),
                             torch.randn(4, 8, generator=g))
            # row 0 holds no valid token: num 0, den 0, m -inf
            p.num[0], p.den[0], p.m[0] = 0.0, 0.0, float("-inf")
            out["one_rank_combine_bitwise"] = torch.equal(
                tsa.combine_partials(p, ("data",), mesh), tsa._finish(p))
    return out


def _train_cfg(over):
    from repro_torch.configs import get_config
    cfg = get_config(over["arch"], smoke=True)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, **over["runtime"]))
    if over["moe"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **over["moe"]))
    return cfg


def _train_step_rank(name, case):
    """One train step of a ``TRAIN_CASES`` case on the (2, 2) mesh from
    the reference's state; returns the rank's report and the new state."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import params_from_jax, tree_map
    from repro_torch.runtime.elastic import whole
    cfg = _train_cfg(TRAIN_CASES[name])
    mesh = make_host_mesh(2, 2, device="cpu")
    tcfg = steps.TrainCfg(lr=1e-3, warmup_steps=2, total_steps=10)
    step, ss, bspec = steps.make_jitted_train_step(
        cfg, mesh, tcfg, ShapeCfg("t", case["S"], case["B"], "train"))
    state = steps.distribute_tree(params_from_jax(case["state"], "cpu"), ss,
                                  mesh)
    new, metrics = step(state, {"tokens": case["tokens"],
                                "targets": case["targets"]})
    out = {"bspec": bspec,
           "all_dtensors": all(isinstance(x, DTensor) for x in
                               _leaves(new)),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "after": tree_map(lambda t: whole(t).numpy().copy(), new)}
    return out, new, mesh, ss


def _train_rank(case, root):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.params import axes_tree, tree_map
    from repro_torch.runtime.elastic import (make_mesh_from_devices,
                                             reshard_tree, whole)
    from repro_torch.sharding import partition as pt
    from repro_torch.sharding.ctx import mesh_coords
    cfg = get_config("qwen3-1.7b", smoke=True)
    out, new, mesh, ss = _train_step_rank("train", case)
    # a save from the mesh: every rank makes the state whole, rank 0
    # writes, the others wait; read back without a mesh
    ck = Checkpointer(os.path.join(root, "ckpt_port"), async_save=False)
    ck.save(1, new)
    saved, _ = ck.restore(tree_map(whole, new))
    out["mesh_save"] = tree_map(lambda t: t.numpy().copy(), saved)
    # the reference's checkpoint restored onto the port's mesh
    shards = pt.tree_of_shardings(ss, mesh)
    back, at = Checkpointer(os.path.join(root, "ckpt")).restore(
        tree_map(lambda t: whole(t), new), shardings=shards)
    out["restored_at"] = at
    out["restored"] = tree_map(lambda t: whole(t).numpy().copy(), back)
    # elastic: the restored state onto a (1, 4) mesh of the same ranks
    axes = axes_tree(lm.param_defs(cfg))
    state_axes = {"params": axes, "opt": {"m": axes, "v": axes,
                                          "step": ()}}
    mesh2 = make_mesh_from_devices(prefer_model=4, device="cpu")
    moved = reshard_tree(back, state_axes, mesh2)
    coords2 = mesh_coords(mesh2)
    blocks_ok = []
    for t, ax in zip(_leaves(moved), _axes_leaves(state_axes)):
        spec = pt.spec_for(tuple(t.shape), ax, mesh2)
        blocks_ok.append(torch.equal(t.to_local(), pt.local_block(
            whole(t), spec, mesh2, coords2)))
    out["reshard_mesh"] = tuple(mesh2.shape)
    # constrain: a DTensor redistributed to its logical axes' spec under
    # the mesh's context, a plain tensor returned as it is
    from torch.distributed.tensor import Shard
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.sharding.ctx import (constrain, constrain_priority,
                                          current_mesh)
    x = torch.arange(64.0).reshape(8, 8)
    replicated = steps.distribute_tree(x, (None, None), mesh)
    out["no_ctx_as_is"] = (current_mesh() is None and
                           constrain(replicated, ("embed", "heads"))
                           is replicated)
    with set_mesh(mesh):
        out["current_mesh"] = current_mesh() is mesh
        c = constrain(replicated, ("embed", "heads"))
        out["constrain_plain_as_is"] = constrain(x, ("embed", "heads")) is x
        # the option that shards the most dims wins: (Shard(0), Shard(1))
        cp = constrain_priority(replicated, ("embed", None),
                                ("embed", "heads"), (None, "heads"))
        out["priority_plain_as_is"] = constrain_priority(
            x, ("embed", None)) is x
    out["constrain_placements"] = tuple(c.placements) == (Shard(0),
                                                          Shard(1))
    out["constrain_values"] = torch.equal(c.full_tensor(), x)
    out["priority_placements"] = tuple(cp.placements) == (Shard(0),
                                                          Shard(1))
    out["priority_values"] = torch.equal(cp.full_tensor(), x)
    out["reshard_blocks_ok"] = all(blocks_ok)
    out["resharded"] = tree_map(lambda t: whole(t).numpy().copy(), moved)
    return out


def _leaves(tree):
    from repro_torch.models.params import leaves
    return leaves(tree)


def _axes_leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _axes_leaves(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in _axes_leaves(v)]
    return [tree]


def _rank_run(rank, world, device, path):
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        cases = pickle.load(f)
    ids = []
    _spy_ids(ids)
    out = {name: _decode_rank(cases[name], ids) for name in DECODE_CASES}
    out["train"] = _train_rank(cases["train"], os.path.dirname(path))
    for name in TRAIN_CASES:
        if name != "train":
            out[name] = _train_step_rank(name, cases[name])[0]
    return out


# ---------------------------------------------------------------------------
# The run: the reference once, the port's four ranks once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    path = root / "reference.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    script = REF_SCRIPT.replace("@TRAIN_CASES@", repr(TRAIN_CASES))
    res = subprocess.run([sys.executable, "-c", script, str(path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=REF_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    port = run_ranks(_rank_run, 4, device="cpu", backend="gloo",
                     init_method=f"file://{root / 'store'}",
                     args=(str(path),), timeout_s=RANKS_TIMEOUT_S)
    return ref, port


def _rows(case, rank_out):
    """The batch rows a rank holds: its block over the decode batch
    axes."""
    from repro_torch.sharding import partition as pt
    mesh = pt.MeshShape(("data", "model"), tuple(case["mesh"]))
    idx = pt.shard_index(rank_out["rows"], mesh, rank_out["coords"])
    n = case["B"] // pt.mesh_extent(mesh, rank_out["rows"])
    return slice(idx * n, (idx + 1) * n)


def _cache_leaves(cache):
    out = {}
    for part in ("prologue", "body"):
        for i, d in enumerate(cache[part]):
            for name, leaf in (d or {}).items():
                out[(part, i, name)] = np.asarray(leaf)
    return out


def _id_groups(ids, n_valid):
    """A step's selections as {global chunk offset: sorted list of each
    layer's selection}: for each (row, kv head) the sorted ids of the
    chunks that hold a token (global base chunk < ``n_valid``) and the
    count of those past the fill.  Past the fill every box is the
    sentinel one: which of those tie for the last places is rounding
    noise (XLA's matmul gives equal boxes bounds a few ulps apart), and
    attention masks them all."""
    out = {}
    for off, a in ids:
        live = (a.astype(np.int64) + off) < n_valid
        sel = [(tuple(sorted(r[m].tolist())), int((~m).sum()))
               for r, m in zip(a.reshape(-1, a.shape[-1]),
                               live.reshape(-1, a.shape[-1]))]
        out.setdefault(off, []).append((a.shape, tuple(sel)))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("name", DECODE_CASES)
def test_sharded_decode_matches_reference_mesh(runs, name):
    ref, port = runs
    case = ref[name]
    for r, out in enumerate(port):
        rows = _rows(case, out[name])
        got = out[name]
        np.testing.assert_allclose(got["prefill_logits"],
                                   case["prefill_logits"][rows],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"rank {r} prefill")
        for t, want in enumerate(case["logits"]):
            np.testing.assert_allclose(got["logits"][t], want[rows],
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                       err_msg=f"rank {r} step {t}")
        t_c, j_c = _cache_leaves(got["cache"]), _cache_leaves(case["cache"])
        assert t_c.keys() == j_c.keys()
        for key in j_c:
            assert t_c[key].dtype == j_c[key].dtype, key
            np.testing.assert_allclose(t_c[key], j_c[key], rtol=CACHE_TOL,
                                       atol=CACHE_TOL, err_msg=str(key))
    for t, want in enumerate(case["ids"]):
        got = [x for out in port for x in out[name]["ids"][t]]
        n_valid = (case["P0"] + t + CHUNK) // CHUNK
        assert _id_groups(got, n_valid) == _id_groups(want, n_valid), \
            f"step {t}"
        assert bool(want) == (not case["dense"])


def test_sparse_decode_has_an_empty_shard(runs):
    """Shard 3 of the (1, 4) longchat run holds no token at any step, and
    still selects and attends (its combine weight is 0); the reference's
    sharded decode is not the local one (the per-shard budgets)."""
    ref, port = runs
    case = ref["sparse"]
    S_l = case["S"] // 4
    assert case["P0"] + len(case["tokens"]) <= 3 * S_l
    assert 2 * S_l < case["P0"]
    offsets = {off for off, _ in port[3]["sparse"]["ids"][0]}
    assert offsets == {3 * (S_l // CHUNK)}


def test_one_rank_combine_is_finish(runs):
    _, port = runs
    for out in port:
        assert out["sparse"]["one_rank_combine_bitwise"]
        assert out["mla"]["one_rank_combine_bitwise"]


def test_train_step_on_mesh_matches_reference(runs):
    ref, port = runs
    case = ref["train"]
    for out in port:
        got = out["train"]
        assert got["all_dtensors"]
        assert got["bspec"] == {"tokens": ("data", None),
                                "targets": ("data", None)}
        for k, want in case["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], want,
                                       rtol=TRAIN_TOL, atol=1e-7,
                                       err_msg=k)
        _tree_close(got["after"], case["after"])


@pytest.mark.parametrize("name", [n for n in TRAIN_CASES if n != "train"])
def test_moe_and_microbatch_train_steps_on_mesh_match_reference(runs, name):
    """MoE dispatch and microbatches over the batch shards: the ranks'
    losses and gradients sum to the reference's global step."""
    ref, port = runs
    case = ref[name]
    if name == "train_mb":
        assert (case["targets"] < 0).any() and (case["targets"] >= 0).any()
    for out in port:
        got = out[name]
        assert got["all_dtensors"]
        assert got["metrics"].keys() == case["metrics"].keys()
        for k, want in case["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], want,
                                       rtol=TRAIN_TOL, atol=1e-7,
                                       err_msg=k)
        _tree_close(got["after"], case["after"])


def _tree_close(got, want, bitwise=False):
    from repro_torch.checkpoint.checkpointer import _flatten
    g, w = dict(_flatten(got)), dict(_flatten(want))
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if bitwise:
            assert a.tobytes() == b.tobytes(), k
        else:
            scale = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= TRAIN_TOL * scale, k


def test_restore_and_reshard_are_bitwise(runs):
    ref, port = runs
    case = ref["train"]
    for out in port:
        got = out["train"]
        assert got["restored_at"] == 1
        _tree_close(got["mesh_save"], got["after"], bitwise=True)
        _tree_close(got["restored"], case["after"], bitwise=True)
        _tree_close(got["restored"], case["restored"], bitwise=True)
        assert got["reshard_mesh"] == (1, 4)
        assert got["constrain_plain_as_is"] and got["constrain_placements"]
        assert got["constrain_values"] and got["no_ctx_as_is"]
        assert got["current_mesh"] and got["priority_plain_as_is"]
        assert got["priority_placements"] and got["priority_values"]
        assert got["reshard_blocks_ok"]
        _tree_close(got["resharded"], case["after"], bitwise=True)


def _fail_on_rank_1(rank, world, device):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def test_run_ranks_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(_fail_on_rank_1, 2, device="cpu",
                  init_method=f"file://{tmp_path / 'store'}", timeout_s=120)
