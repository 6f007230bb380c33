"""The port's sharding rules (ROADMAP A12b) against the reference's, in
process: ``repro.sharding.partition`` and ``repro.launch.steps`` run on a
``jax.sharding.AbstractMesh`` (no devices), the port's counterparts on a
``partition.MeshShape`` of the same axes and sizes.

Every spec must be equal exactly, entry for entry (a ``PartitionSpec``
read as a tuple): the parameter and decode-cache specs of every config,
full and smoke (shapes only: ``ParamDef`` s on the port's side,
``ShapeDtypeStruct`` s on the reference's), on the production meshes
(16, 16) and (2, 16, 16) and the host meshes (2, 4), (1, 4) and (4, 1);
``seq_shard_axes`` / ``decode_batch_axes`` for batches 1-16; the rules
with ``fsdp_params`` both ways; the train and decode batch specs;
``elastic.choose_grid`` and ``shrink_batch_for``; ``steps.param_shardings``
and ``partition.sharding_tree`` (each leaf's reference spec and its
placements).  DTensor placements follow a spec where the mesh's order
allows and raise, naming the spec, where it does not.  ``current_mesh``
follows the sharding context.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.launch import steps as jsteps
from repro.runtime import elastic as jelastic
from repro.sharding import partition as jpt
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.attention import DecodeCtx
from repro_torch.runtime import elastic as telastic
from repro_torch.sharding import partition as tpt

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model"))]
DECODE_SHAPES = [(128, 32_768), (1, 524_288), (4, 512)]


def _meshes(i):
    sizes, names = MESHES[i]
    return AbstractMesh(sizes, names), tpt.MeshShape(names, sizes)


def _ref_specs(tree):
    """A reference spec tree as {path: tuple}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(path): tuple(p) for path, p in flat}


def _port_specs(tree, path=""):
    """A port spec tree (tuples are its leaves) as {path: tuple}, with the
    reference's path strings."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_specs(
            tree[key], f"{path}[{key!r}]").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _port_specs(
            x, f"{path}[{i}]").items()}
    return {path: tree}


def _same(port_tree, ref_tree):
    got, want = _port_specs(port_tree), _ref_specs(ref_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    return len(want)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list_configs())
def test_param_and_cache_specs_match_reference(arch, smoke):
    jcfg, tcfg = j_get_config(arch, smoke=smoke), get_config(arch,
                                                             smoke=smoke)
    n = 0
    for i in range(len(MESHES)):
        jm, tm = _meshes(i)
        n += _same(tsteps.param_specs(tcfg, tm), jsteps.param_specs(jcfg, jm))
        ss_t = tsteps.state_specs(tcfg, tm, tsteps.TrainCfg())
        ss_j = jsteps.state_specs(jcfg, jm, jsteps.TrainCfg())
        n += _same(ss_t, ss_j)
        for B, S in DECODE_SHAPES:
            if smoke and S > 4096:
                continue
            js, ts = JShapeCfg("d", S, B, "decode"), ShapeCfg("d", S, B,
                                                             "decode")
            n += _same(tsteps.cache_specs(tcfg, tm, ts),
                       jsteps.cache_specs(jcfg, jm, js))
            assert tsteps.decode_rules(tcfg, tm, ts) == \
                jsteps.decode_rules(jcfg, jm, js)
            jctx = jsteps.decode_ctx(jcfg, jm, js)
            assert (jctx.seq_axes, jctx.batch_axes) == (
                tpt.seq_shard_axes(tm, B), tpt.decode_batch_axes(tm, B))
    assert n > 0


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_batch_axes_and_batch_specs_match_reference(i):
    jm, tm = _meshes(i)
    for B in range(1, 17):
        assert tpt.seq_shard_axes(tm, B) == jpt.seq_shard_axes(jm, B), B
        assert tpt.decode_batch_axes(tm, B) == jpt.decode_batch_axes(jm, B)
    assert tpt.batch_axes(tm) == jpt.batch_axes(jm)
    assert tpt.fsdp_axes(tm) == jpt.fsdp_axes(jm)
    for arch in ("qwen3-1.7b", "qwen2-vl-2b", "seamless-m4t-large-v2"):
        jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch,
                                                                smoke=True)
        for kind in ("train", "prefill"):
            js = JShapeCfg("t", 64, 8, kind)
            jb = jsteps.input_specs(jcfg, js)["batch"]
            tb = tsteps.input_specs(tcfg, ShapeCfg("t", 64, 8, kind))[
                "batch"]
            assert {k: tuple(v.shape) for k, v in tb.items()} == \
                {k: tuple(v.shape) for k, v in jb.items()}
            for axes in (jpt.batch_axes(jm), ()):
                assert tsteps.batch_specs_tree(tcfg, tm, tb, axes) == {
                    k: tuple(v) for k, v in jsteps.batch_specs_tree(
                        jcfg, jm, jb, axes).items()}


@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_and_spec_for_match_reference(fsdp):
    for arch in list_configs():
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        jcfg = dataclasses.replace(jcfg, runtime=dataclasses.replace(
            jcfg.runtime, fsdp_params=fsdp))
        tcfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
            tcfg.runtime, fsdp_params=fsdp))
        extra = {"kv_seq": ("model", "data"), "batch": ()}
        assert tpt.rules_for(tcfg) == jpt.rules_for(jcfg)
        assert tpt.rules_for(tcfg, extra) == jpt.rules_for(jcfg, extra)
        for i in range(len(MESHES)):
            jm, tm = _meshes(i)
            for shape, axes in (((4096, 64), ("embed", "heads")),
                                ((8, 1024, 12), ("kv", "ffn", "vocab")),
                                ((6, 7), ("batch", "kv_seq")),
                                ((32, 32, 8), ("batch", "kv_seq", "kv"))):
                for rules in (tpt.rules_for(tcfg), tpt.rules_for(tcfg,
                                                                  extra)):
                    assert tpt.spec_for(shape, axes, tm, rules) == tuple(
                        jpt.spec_for(shape, axes, jm, rules))
                assert tpt.mesh_extent(tm, jm.axis_names) == \
                    jpt.mesh_extent(jm, jm.axis_names)


def test_elastic_grid_and_batch_match_reference():
    for n in range(1, 600):
        for pm in (1, 4, 16):
            assert telastic.choose_grid(n, prefer_model=pm) == \
                jelastic.choose_grid(n, prefer_model=pm)
    for i in range(len(MESHES)):
        jm, tm = _meshes(i)
        for gb in (1, 7, 8, 256, 1000):
            assert telastic.shrink_batch_for(gb, tm) == \
                jelastic.shrink_batch_for(gb, jm)


def test_placements_follow_the_mesh_order_or_raise():
    from torch.distributed.tensor import Replicate, Shard
    tm = tpt.MeshShape(("data", "model"), (2, 4))
    assert tpt.placements(("data", None, "model"), tm) == [Shard(0),
                                                           Shard(2)]
    assert tpt.placements((None, ("data", "model")), tm) == [Shard(1),
                                                             Shard(1)]
    assert tpt.placements((None,), tm) == [Replicate(), Replicate()]
    # batch 1 on a (data, model) mesh: the sequence takes model major
    spec = (None, tpt.axes_entry(tpt.seq_shard_axes(tm, 1)))
    assert spec == (None, ("model", "data"))
    with pytest.raises(ValueError, match=r"\('model', 'data'\)"):
        tpt.placements(spec, tm)


def test_local_block_takes_the_first_axis_major():
    tm = tpt.MeshShape(("data", "model"), (2, 4))
    x = np.arange(16 * 3).reshape(16, 3)
    import torch
    t = torch.from_numpy(x)
    for d in range(2):
        for m in range(4):
            c = {"data": d, "model": m}
            # ("model", "data"): index m * 2 + d of 8 blocks of 2 rows
            got = tpt.local_block(t, (("model", "data"), None), tm, c)
            k = m * 2 + d
            assert got.tolist() == x[2 * k:2 * k + 2].tolist()
            got = tpt.local_block(t, ("data", None), tm, c)
            assert got.tolist() == x[8 * d:8 * d + 8].tolist()


def test_production_mesh_and_decode_ctx_name_what_they_need():
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        DecodeCtx(seq_axes=("model",))
    assert DecodeCtx().n_seq_shards == 1


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_param_shardings_and_sharding_tree_match_reference(i):
    """``steps.param_shardings`` holds each parameter's reference spec and
    its placements; ``partition.sharding_tree`` of the axes and shapes is
    the same tree."""
    from repro_torch.models import lm as tlm
    from repro_torch.models.params import axes_tree
    jm, tm = _meshes(i)
    for arch in list_configs():
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        got = tsteps.param_shardings(tcfg, tm)
        want = _ref_specs(jsteps.param_specs(jcfg, jm))
        flat = _port_specs(got)
        assert flat.keys() == want.keys()
        for k, sh in flat.items():
            assert sh.spec == want[k], (arch, k)
            assert list(sh.placements) == tpt.placements(sh.spec, tm)
        defs = tlm.param_defs(tcfg)
        assert tpt.sharding_tree(axes_tree(defs), defs, tm,
                                 tpt.rules_for(tcfg)) == got


def test_current_mesh_follows_the_sharding_ctx():
    from repro_torch.sharding import ctx
    tm = tpt.MeshShape(("data", "model"), (2, 4))
    assert ctx.current_mesh() is None
    with ctx.sharding_ctx(tm):
        assert ctx.current_mesh() is tm
        with tmesh.set_mesh(tpt.MeshShape(("data",), (8,))):
            assert ctx.current_mesh().sizes == (8,)
        assert ctx.current_mesh() is tm
    assert ctx.current_mesh() is None
