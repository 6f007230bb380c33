"""The dry-run analysers (``repro_torch.launch.{op_costing, dryrun,
roofline, reanalyze}``) against the reference's.

In process: the stand-ins (``steps.input_specs``, ``abstract_state``,
``lm.abstract_params`` / ``abstract_cache``, ``adamw.abstract_opt_state``:
meta tensors) against the reference's ``ShapeDtypeStruct`` s for every
config, full and smoke, and every shape; ``runtime_overrides``'
microbatches on the production meshes and ``model_flops``; the roofline's
formula with the H100 peaks; the op counter's rules on small ops; B1's
and B2's custom ops (fake shapes, CPU bits) and their ``cost_*`` against
the formulas the chip smoke's phase 3 used; ``reanalyze`` round trips.

In one child process (the fake process group is process-global): the
dry run of the smoke cells on a (1, 1) mesh, qwen3-1.7b train at 2 x 128
and decode into a 2 x 256 cache and longchat-7b-32k decode, whose FLOPs
are held to the reference's ``hlo_costing.analyze`` of the compiled step
(ROADMAP C20 gives the decode cells' measured ratio); longchat-7b-32k x
decode_32k at full width on a fake (16, 16) mesh, its collectives derived
from ``param_specs`` and its attention layers; and the collectives on a
fake group of 4.  The child traces on fake CPU tensors: this PyTorch is
built without CUDA and cannot index fake CUDA tensors.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.launch import hlo_costing
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.sharding import partition as jpt
from repro_torch.configs import ASSIGNED, SHAPES, get_config, get_shape
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels.chunk_bounds import ops as cb
from repro_torch.kernels.chunk_bounds.ref import (chunk_bounds_gqa_ref,
                                                  chunk_bounds_ref)
from repro_torch.kernels.sparse_decode import ops as sd
from repro_torch.kernels.sparse_decode.ref import sparse_decode_ref
from repro_torch.launch import dryrun, op_costing, reanalyze, roofline
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.sharding import partition as tpt

ROOT = Path(__file__).resolve().parents[1]
# the smoke cells held against the reference on a (1, 1) mesh
SMOKE_CELLS = [("qwen3-1.7b", ("train_128", 128, 2, "train")),
               ("qwen3-1.7b", ("decode_256", 256, 2, "decode")),
               ("longchat-7b-32k", ("decode_256", 256, 2, "decode"))]
FLOPS_REL = 0.10
# ROADMAP C20: the decode cells' FLOPs over the reference's.  The port
# charges B1 and B2 by their own formulas (kernels/*/ops.py cost_*); the
# reference's plain sparse path also pays per-element masks and selects
# (select_n, compare, and) around the same dots.  Held to the measured
# ratio.
C20_DECODE_RATIO = (0.864, 0.865)
CHILD_TIMEOUT_S = 300


def _flat(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict/list tree of tensors
    or ShapeDtypeStructs, paths as ``jax.tree_util.keystr`` writes them."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", path
        return {path: (tuple(tree.shape),
                       str(tree.dtype).replace("torch.", ""))}
    return {path: (tuple(tree.shape), jnp.dtype(tree.dtype).name)}


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in flat}


# ---------------------------------------------------------------------------
# The stand-ins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", j_list_configs())
def test_stand_ins_match_reference(arch, smoke):
    jcfg, tcfg = j_get_config(arch, smoke=smoke), get_config(arch,
                                                            smoke=smoke)
    tc, jtc = tsteps.TrainCfg(), jsteps.TrainCfg()
    assert _flat(lm.abstract_params(tcfg)) == _ref_flat(
        jlm.abstract_params(jcfg))
    assert _flat(tsteps.abstract_state(tcfg, tc)) == _ref_flat(
        jsteps.abstract_state(jcfg, jtc))
    for state_dtype in ("float32", "bfloat16"):
        p = lm.abstract_params(tcfg)
        got = adamw.abstract_opt_state(p, adamw.AdamWCfg(
            state_dtype=state_dtype))
        want = jadamw.abstract_opt_state(jlm.abstract_params(jcfg),
                                         jadamw.AdamWCfg(
                                             state_dtype=state_dtype))
        assert _flat(got) == _ref_flat(want)
    for name, shape in SHAPES.items():
        js = J_SHAPES[name]
        got, want = tsteps.input_specs(tcfg, shape), jsteps.input_specs(
            jcfg, js)
        assert set(got) == set(want)
        assert _flat(got["batch"]) == _ref_flat(want["batch"]), name
        if shape.kind == "decode":
            assert got["length"] == shape.seq_len - 1
            assert _flat(got["cache"]) == _ref_flat(want["cache"]), name
            assert _flat(lm.abstract_cache(tcfg, 3, 512)) == _ref_flat(
                jlm.abstract_cache(jcfg, 3, 512))


# ---------------------------------------------------------------------------
# runtime_overrides, model_flops, the roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes,names", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))])
def test_runtime_overrides_microbatches_match_reference(sizes, names):
    # the reference module sets XLA_FLAGS at import; JAX reads it when its
    # backend starts, so the variable is put back at once
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import runtime_overrides as ref_overrides
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    jm, tm = AbstractMesh(sizes, names), tpt.MeshShape(names, sizes)
    assert ASSIGNED == J_ASSIGNED
    for arch in ASSIGNED:
        for name in SHAPES:
            got = dryrun.runtime_overrides(get_config(arch), get_shape(name),
                                           tm)
            want = ref_overrides(j_get_config(arch), J_SHAPES[name], jm)
            assert got.runtime.microbatches == want.runtime.microbatches, \
                (arch, name)


def test_model_flops_match_reference():
    for arch in ASSIGNED:
        for name in SHAPES:
            for n in (256, 512):
                assert roofline.model_flops(arch, name, n) == \
                    jroofline.model_flops(arch, name, n)


def test_roofline_analyze_cell_uses_h100_peaks():
    rec = {"arch": "qwen3-1.7b", "shape": "decode_32k", "mesh": "16x16",
           "n_devices": 256, "memory": {"peak_bytes_per_device": 3 * 2**30},
           "op_cost": {"flops": 4.0e12, "bytes": 2.0e10,
                       "total_collective_bytes": 9.0e9}, "fits": True}
    row = roofline.analyze_cell(rec)
    t_c, t_m, t_x = 4.0e12 / 989e12, 2.0e10 / 3.35e12, 9.0e9 / 450e9
    assert row["compute_s"] == pytest.approx(t_c, rel=1e-12)
    assert row["memory_s"] == pytest.approx(t_m, rel=1e-12)
    assert row["collective_s"] == pytest.approx(t_x, rel=1e-12)
    assert row["dominant"] == "collective"
    mf = roofline.model_flops("qwen3-1.7b", "decode_32k", 256)
    assert row["useful_ratio"] == pytest.approx(mf / 4.0e12)
    assert row["roofline_fraction"] == pytest.approx((mf / 989e12) / t_x)
    assert row["peak_gib"] == 3.0 and row["collective_bytes"] == 9.0e9
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# The op counter's rules (the analogues of tests/test_runtime.py's HLO
# costing checks)
# ---------------------------------------------------------------------------


def _count(fn, *inputs, trace=False):
    c = op_costing.OpCounter(trace=trace)
    c.add_inputs(inputs)
    with c:
        out = fn(*inputs)
    c.finish(out)
    return c


def test_matmul_counts_2mnk():
    m, k, n = 64, 96, 48
    a, b = torch.randn(m, k), torch.randn(k, n)
    c = _count(lambda x, y: x @ y, a, b)
    assert c.cost.flops == 2 * m * n * k
    assert c.cost.bytes == 4 * (m * k + k * n + m * n)


def test_python_loop_counts_every_iteration():
    a, w = torch.randn(16, 32), torch.randn(32, 32)

    def loop(x, y):
        for _ in range(8):
            x = x @ y
        return x
    one = _count(lambda x, y: x @ y, a, w).cost.flops
    assert _count(loop, a, w).cost.flops == 8 * one


def test_views_cost_nothing():
    x = torch.randn(8, 16, 4)

    def views(t):
        return t.view(8, 64).t().unsqueeze(0)[0, 3:9].transpose(0, 1)
    c = _count(views, x)
    assert c.cost.bytes == 0 and c.cost.flops == 0 and c.ops > 0


def test_index_copy_into_a_slice_costs_twice_the_slice():
    cache = torch.zeros(4, 64, 8)
    src = torch.randn(3, 8)
    idx = torch.tensor([1, 5, 7])

    def write(c, s, i):
        c[2].index_copy_(0, i, s)
        return c
    c = _count(write, cache, src, idx)
    assert c.cost.bytes == 2 * src.numel() * 4

    def slice_copy(c, s):
        c[1, 10:13] = s
        return c
    assert _count(slice_copy, cache, src).cost.bytes == 2 * src.numel() * 4


def test_gather_and_scatter_rules():
    x = torch.randn(32, 16)
    idx = torch.tensor([3, 1, 30, 7])
    c = _count(lambda t, i: t.index_select(0, i), x, idx)
    assert c.cost.bytes == 2 * 4 * 16 * 4
    upd = torch.randn(4, 16)
    c = _count(lambda t, i, u: t.index_add(0, i, u), x, idx, upd)
    assert c.cost.bytes == 2 * upd.numel() * 4


def test_elementwise_and_reduction_flops():
    x = torch.randn(10, 20)
    assert _count(lambda t: t * 2 + 1, x).cost.flops == 2 * 200
    assert _count(lambda t: t.sum(-1), x).cost.flops == 10 + 200


def test_live_bytes_peak_and_outputs():
    x = torch.randn(256, 256)

    def step(t):
        a = t * 2                    # 256 KiB live
        b = a + 1                    # 512 KiB live at the peak
        del a
        return b.sum()
    c = _count(step, x)
    mem = c.memory()
    nb = 256 * 256 * 4
    assert mem["argument_bytes"] == nb
    # a is freed before the sum's 4 bytes are made
    assert mem["peak_bytes_per_device"] == 3 * nb
    assert mem["output_bytes"] == 4
    assert mem["alias_bytes"] == 0


def test_reanalyze_round_trips_a_saved_trace(tmp_path):
    q = torch.randn(2, 4, 2, 16).bfloat16()
    k = torch.randn(2, 128, 4, 16).bfloat16()
    ids = torch.randint(0, 8, (2, 4, 3), dtype=torch.int32)

    def step(q, k, ids):
        num, den, m = sd.sparse_decode(q, k, k, ids, 100, chunk=16)
        return (num / den[..., None]).sum() + m.amax()
    c = _count(step, q, k, ids, trace=True)
    trace = tmp_path / "t.jsonl"
    op_costing.save_trace(c.records, str(trace))
    assert op_costing.analyze(str(trace), 1) == c.cost.to_json()
    rec = {"arch": "x", "n_devices": 1, "trace_file": str(trace),
           "op_cost": {"flops": 0.0}}
    (tmp_path / "x.json").write_text(json.dumps(rec))
    assert reanalyze.reanalyze_dir(str(tmp_path)) == 1
    assert json.loads((tmp_path / "x.json").read_text())["op_cost"] == \
        c.cost.to_json()
    kinds = {r["op"] for r in c.records if r["kind"] == "kernel"}
    assert kinds == {"repro_torch.sparse_decode"}


# ---------------------------------------------------------------------------
# B1 and B2 as custom ops, and their costs
# ---------------------------------------------------------------------------


def _b1_inputs(rng):
    q = torch.from_numpy(rng.randn(2, 4, 3, 16).astype(np.float32))
    km = torch.from_numpy(rng.randn(2, 4, 8, 16).astype(np.float32))
    return q, km, km - 1.0


def test_b1_ops_fake_shapes_and_cpu_bits(rng):
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, km, kn = _b1_inputs(rng)
    for got, want in zip(cb.chunk_bounds(q, km, kn),
                         chunk_bounds_ref(q, km, kn)):
        assert torch.equal(got, want)
    qg = q.reshape(2, 12, 16).bfloat16()
    kmg, kng = km.transpose(1, 2).contiguous(), kn.transpose(1, 2).contiguous()
    outs = cb.chunk_bounds_gqa(qg, kmg, kng)
    for got, want in zip(outs, chunk_bounds_gqa_ref(qg, kmg, kng)):
        assert torch.equal(got, want)
    want_c = chunk_bounds_ref(q, km, kn)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in (q, km, kn, qg, kmg, kng)]
        for got, want in zip(cb.chunk_bounds(*fake[:3]), want_c):
            assert (got.shape, got.dtype) == (want.shape, want.dtype)
        for got, want in zip(cb.chunk_bounds_gqa(*fake[3:]), outs):
            assert (got.shape, got.dtype) == (want.shape, want.dtype)


@pytest.mark.parametrize("dtype,softcap", [(torch.float32, None),
                                           (torch.bfloat16, 30.0)])
def test_b2_op_fake_shapes_and_cpu_bits(rng, dtype, softcap):
    from torch._subclasses.fake_tensor import FakeTensorMode
    q = torch.from_numpy(rng.randn(2, 4, 2, 16).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.randn(2, 128, 4, 16).astype(np.float32)).to(
        dtype)
    v = k * 0.5
    ids = torch.from_numpy(np.stack([[rng.choice(8, 3, replace=False)
                                      for _ in range(4)]
                                     for _ in range(2)]).astype(np.int32))
    got = sd.sparse_decode(q, k, v, ids, 100, chunk=16, attn_softcap=softcap)
    want = sparse_decode_ref(q, k, v, ids, 100, chunk=16,
                             attn_softcap=softcap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with FakeTensorMode() as mode:
        fq, fk, fv, fi = (mode.from_tensor(t) for t in (q, k, v, ids))
        for a, b in zip(sd.sparse_decode(fq, fk, fv, fi, 100, chunk=16,
                                         attn_softcap=softcap), want):
            assert (a.shape, a.dtype) == (b.shape, b.dtype)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_b1_cost_equals_phase3_formula():
    """Phase 3's B1 row: q (4, 32, 128) bf16 against (4, nc, 32, 128) f32
    abstracts, nc the serve's lengths halfway through decode in chunks of
    64; its bound was ``8·B·H·nc·hd`` operations over q, both boxes, ub
    and lb (f32)."""
    lengths = tuple(p + 16 for p in (1536, 2048, 3072, 3584))
    B, H, hd = 4, 32, 128
    nc = max(-(-L // 64) for L in lengths)
    q = torch.empty(B, H, hd, dtype=torch.bfloat16, device="meta")
    km = torch.empty(B, nc, H, hd, device="meta")
    ub = torch.empty(B, H, nc, device="meta")
    assert cb.cost_chunk_bounds_gqa(q, km, km) == (
        8 * B * H * nc * hd, _nbytes(q, km, km, ub, ub))
    # the contract entry on the same work
    q4 = torch.empty(B, H, 1, hd, dtype=torch.bfloat16, device="meta")
    kmt = torch.empty(B, H, nc, hd, device="meta")
    assert cb.cost_chunk_bounds(q4, kmt, kmt) == \
        cb.cost_chunk_bounds_gqa(q, km, km)


def test_b2_cost_equals_phase3_formula():
    """Phase 3's B2 row: 4 sequences, H = Hkv = 32, hd 128, an fp16 pool
    of chunk 64, bf16 q / new rows / output, int32 indices; its bound was
    ``4·H·hd·(live_rows + B)`` operations over the live rows' K and V
    plus q, the new rows, the output and the indices."""
    B, H, hd, chunk, nmax, live_rows = 4, 32, 128, 64, 36, 7821
    q = torch.empty(B, H, hd, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(257, 2, chunk, H, hd, dtype=torch.float16,
                       device="meta")
    slots = torch.empty(B, nmax, dtype=torch.int32, device="meta")
    lens = torch.empty(B, dtype=torch.int32, device="meta")
    new = torch.empty(B, 1, H, hd, dtype=torch.bfloat16, device="meta")
    want = (4 * H * hd * (live_rows + B),
            live_rows * 2 * H * hd * 2 + _nbytes(q, new, new, q)
            + _nbytes(slots, slots, lens))
    assert sd.cost_sparse_decode_pooled(q, pool, slots, slots, lens, new,
                                        new, live_rows=live_rows) == want
    # the contract entry: every selected row below the fill, per kv head
    q4 = torch.empty(B, H, 1, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, 4096, H, hd, dtype=torch.bfloat16, device="meta")
    ids = torch.empty(B, H, 7, dtype=torch.int32, device="meta")
    rows = B * H * min(7 * chunk, 300)
    assert sd.cost_sparse_decode(q4, k, k, ids, 300, chunk) == (
        4 * hd * rows, rows * 2 * hd * 2 + _nbytes(q4, ids) + 4
        + B * H * (hd + 2) * 4)


# ---------------------------------------------------------------------------
# The child: dry runs on fake process groups
# ---------------------------------------------------------------------------


def _child_main():
    """Run in a fresh process: the smoke cells on a (1, 1) mesh, longchat
    x decode_32k at full width on (16, 16), and the collectives on a fake
    group of 4; prints one JSON object."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    out = {"smoke": {}}
    mesh = dryrun.make_mesh((1, 1), ("data", "model"), "cpu")
    for arch, (name, S, B, kind) in SMOKE_CELLS:
        rec = dryrun.lower_cell(arch, ShapeCfg(name, S, B, kind), mesh,
                                device="cpu",
                                cfg=get_config(arch, smoke=True))
        out["smoke"][f"{arch}/{name}"] = rec
    mesh = dryrun.production_mesh(False, "cpu")
    out["full"] = dryrun.lower_cell("longchat-7b-32k", "decode_32k", mesh,
                                    device="cpu")
    # a (1, 4) mesh: the model axis is a group of 4, the data axis a
    # group of one rank
    mesh = dryrun.make_mesh((1, 4), ("data", "model"), "cpu")
    coll = {}
    b = 1000 * 4
    with FakeTensorMode():
        for key, fn in {
                "all_reduce": lambda: dist.all_reduce(
                    torch.empty(1000), group=mesh.get_group("model")),
                "full_tensor": lambda: DTensor.from_local(
                    torch.empty(250, 1), mesh, [Replicate(), Shard(0)],
                    run_check=False).full_tensor(),
                "one_rank": lambda: dist.all_reduce(
                    torch.empty(1000), group=mesh.get_group("data"))
                }.items():
            c = op_costing.OpCounter()
            with c:
                fn()
            coll[key] = c.cost.to_json()
    coll["b"] = b
    out["collectives"] = coll
    # the command line on the production mesh: one record a cell, its op
    # trace saved, re-costed and read by the roofline
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        dryrun.main(["--arch", "xlstm-125m", "--shape",
                     "decode_32k,long_500k", "--device", "cpu", "--out",
                     tmp, "--save-trace", os.path.join(tmp, "traces")])
        recs = {f: json.load(open(os.path.join(tmp, f)))
                for f in sorted(os.listdir(tmp)) if f.endswith(".json")}
        out["cli"] = {"records": recs,
                      "reanalyzed": reanalyze.reanalyze_dir(tmp),
                      "after": {f: json.load(open(os.path.join(tmp, f)))
                                for f in recs},
                      "rows": roofline.load(tmp, "16x16")}
    print("CHILD " + json.dumps(out))


@pytest.fixture(scope="module")
def child():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, __file__, "child"], env=env,
                         capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S, cwd=str(ROOT))
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("CHILD ")]
    assert res.returncode == 0 and lines, res.stdout[-3000:] + \
        res.stderr[-3000:]
    return json.loads(lines[-1][len("CHILD "):])


def test_collectives_on_a_fake_group_of_four(child):
    c = child["collectives"]
    b = c["b"]
    assert c["all_reduce"]["collective_bytes"] == {"all-reduce":
                                                   2 * b * 3 / 4}
    assert c["all_reduce"]["collective_counts"] == {"all-reduce": 1}
    # b bytes gathered whole from four blocks
    assert c["full_tensor"]["collective_bytes"] == {"all-gather": b * 3 / 4}
    assert c["full_tensor"]["collective_counts"] == {"all-gather": 1}
    assert c["one_rank"]["total_collective_bytes"] == 0.0
    assert c["one_rank"]["collective_counts"] == {"all-reduce": 1}


_REF_FLOPS = {}


def _ref_flops(arch, cell):
    """The reference's ``hlo_costing.analyze`` FLOPs of the compiled step
    on one CPU device (mesh (1, 1))."""
    from repro.launch.mesh import make_host_mesh, set_mesh
    name, S, B, kind = cell
    key = (arch, name)
    if key in _REF_FLOPS:
        return _REF_FLOPS[key]
    cfg = j_get_config(arch, smoke=True)
    shape = JShapeCfg(name, S, B, kind)
    mesh = make_host_mesh(1, 1)
    with set_mesh(mesh):
        if kind == "train":
            j, _, _ = jsteps.make_jitted_train_step(cfg, mesh,
                                                    jsteps.TrainCfg(), shape)
            low = j.lower(jsteps.abstract_state(cfg, jsteps.TrainCfg()),
                          jsteps.input_specs(cfg, shape)["batch"])
        else:
            j = jsteps.make_jitted_decode(cfg, mesh, shape)
            sp = jsteps.input_specs(cfg, shape)
            low = j.lower(jlm.abstract_params(cfg), sp["cache"],
                          sp["batch"], sp["length"])
        compiled = low.compile()
    _REF_FLOPS[key] = hlo_costing.analyze(compiled.as_text(), 1)
    return _REF_FLOPS[key]


@pytest.mark.parametrize("arch,cell", SMOKE_CELLS,
                         ids=[f"{a}-{c[0]}" for a, c in SMOKE_CELLS])
def test_dryrun_flops_against_reference(child, arch, cell):
    rec = child["smoke"][f"{arch}/{cell[0]}"]
    ref = _ref_flops(arch, cell)
    ratio = rec["op_cost"]["flops"] / ref["flops"]
    print(f"{arch} {cell[0]}: port {rec['op_cost']['flops']:.4e} FLOPs, "
          f"{rec['op_cost']['bytes']:.4e} bytes, peak "
          f"{rec['memory']['peak_bytes_per_device']}; reference "
          f"{ref['flops']:.4e} FLOPs, {ref['bytes']:.4e} bytes; ratio "
          f"{ratio:.4f}")
    if cell[3] == "decode":
        assert C20_DECODE_RATIO[0] <= ratio <= C20_DECODE_RATIO[1], ratio
        # the combine's two reductions a layer (over a group of one)
        assert rec["op_cost"]["collective_counts"] == \
            ref["collective_counts"]
    else:
        # XLA drops the train step's reductions over one device; the
        # eager step still calls them
        assert abs(ratio - 1.0) <= FLOPS_REL, ratio
    assert rec["mesh"] == "1x1" and rec["n_devices"] == 1
    assert rec["memory"]["peak_bytes_per_device"] >= \
        rec["memory"]["argument_bytes"] > 0


def test_full_width_longchat_decode_on_the_production_mesh(child):
    rec = child["full"]
    for key in ("arch", "shape", "mesh", "n_devices", "kind", "trace_s",
                "memory", "op_cost", "fits"):
        assert key in rec
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_bytes_per_device"):
        assert key in rec["memory"]
    assert (rec["n_devices"], rec["mesh"], rec["kind"]) == (256, "16x16",
                                                           "decode")
    # every parameter leaf sharded over one mesh axis is gathered whole
    # once (15/16 of its bytes on the wire); the combine reduces each
    # attention layer's m, then its num and den, over the 16 shards
    cfg = get_config("longchat-7b-32k")
    specs = tsteps.param_specs(cfg, tpt.MeshShape(("data", "model"),
                                                  (16, 16)))
    defs = lm.param_defs(cfg)
    gathers, gather_bytes = 0, 0.0

    def walk(spec, d):
        nonlocal gathers, gather_bytes
        axes = [a for e in spec for a in tpt.entry_axes(e)]
        assert len(axes) <= 1, spec
        if axes:
            gathers += 1
            gather_bytes += np.prod(d.shape) * 2 * 15 / 16
    tpt.zip_axes(walk, specs, defs)
    B_rank, H, hd = 128 // 16, cfg.n_heads, cfg.hd
    per_layer = (B_rank * H * 4 + (B_rank * H * hd + B_rank * H) * 4)
    oc = rec["op_cost"]
    assert oc["collective_counts"] == {"all-gather": gathers,
                                       "all-reduce": 2 * cfg.n_layers}
    assert oc["collective_bytes"]["all-gather"] == pytest.approx(
        gather_bytes, rel=1e-12)
    assert oc["collective_bytes"]["all-reduce"] == pytest.approx(
        cfg.n_layers * 2 * per_layer * 15 / 16, rel=1e-12)
    assert oc["flops"] > 0 and rec["fits"] is True


def test_cli_writes_records_that_reanalyze_and_roofline_read(child):
    cli = child["cli"]
    assert sorted(cli["records"]) == [
        "xlstm-125m__decode_32k__16x16.json",
        "xlstm-125m__long_500k__16x16.json"]
    assert cli["reanalyzed"] == 2
    for name, rec in cli["records"].items():
        assert rec["n_devices"] == 256 and rec["trace_file"].endswith(
            ".jsonl")
        assert cli["after"][name]["op_cost"] == rec["op_cost"]
    assert [r["shape"] for r in cli["rows"]] == ["decode_32k", "long_500k"]
    for r in cli["rows"]:
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["model_flops"] == roofline.model_flops("xlstm-125m",
                                                        r["shape"], 256)


def test_cell_time_limit_raises_in_the_trace():
    import time
    with pytest.raises(dryrun.CellTimeout):
        with dryrun._time_limit(0.2):
            while True:
                time.sleep(0.01)
    with dryrun._time_limit(None):
        pass


if __name__ == "__main__" and sys.argv[1:] == ["child"]:
    _child_main()
