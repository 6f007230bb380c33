"""Multi-pod dry run: trace one rank's step of every (arch × shape × mesh)
cell and cost it, the port's counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's jitted step for a TPU pod
of fake host devices and reads the compiled module.  Here each cell's
step (``launch.steps``: the train step, prefill or decode on the mesh)
runs eagerly as rank 0 of a fake process group of the mesh's size, under
``FakeTensorMode`` (no memory, no data) and
:class:`~repro_torch.launch.op_costing.OpCounter`, which charges every op
that rank dispatches — its gathers of the parameters included — and keeps
its live bytes.  The record holds the reference's ``arch``, ``shape``,
``mesh``, ``n_devices``, ``kind`` and ``memory`` keys, ``trace_s`` (for
``lower_s`` / ``compile_s``), ``op_cost`` (for ``hlo_cost``) and ``fits``
(the peak against the card's memory); ``launch/roofline.py`` reads it.

The inputs are fake tensors of :func:`steps.input_specs` /
:func:`steps.abstract_state`'s shapes: parameters (and moments) as
DTensors laid out by ``param_specs`` / ``state_specs``, each built from
the rank's block; the decode cache as the rank's block alone
(``lm.cache_block_specs``), never a DTensor.  The no-drop MoE routes a
fake batch with a balanced router (``mlp.expert_counts``): such records
say ``"moe_counts": "balanced"``.

Usage:
  python -m repro_torch.launch.dryrun --arch longchat-7b-32k --shape decode_32k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] [--both]
  python -m repro_torch.launch.dryrun ... --out results/dryrun_torch --device cpu

``--device`` (default ``cuda``) is the device type the fake tensors claim;
nothing runs on it.  A PyTorch built without CUDA cannot index fake CUDA
tensors (nor run their autograd): there, pass ``--device cpu``.  The fake
process group is process-global: ``--both`` runs each mesh in a child
process of its own.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config, get_shape
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import op_costing
from repro_torch.launch import steps as stp
from repro_torch.models import lm
from repro_torch.models.params import tree_map, tree_zip
from repro_torch.sharding import partition as pt

# the H100 SXM5 80GB's HBM3 (NVIDIA H100 data sheet: 80 GB), the card the
# port targets: ``fits`` compares against it where no card is present
H100_80GB_BYTES = 80 * 2 ** 30


def runtime_overrides(cfg, shape: ShapeCfg, mesh):
    """Per-cell execution knobs: grad-accumulation depth targets ~2
    sequences per device per microbatch (activation-memory bound)."""
    rt = cfg.runtime
    if shape.kind == "train":
        gb = shape.global_batch
        per_dev = gb // pt.mesh_extent(mesh, pt.fsdp_axes(mesh))
        # explicit config microbatches win; otherwise target ~2 seqs/device
        nm = rt.microbatches if rt.microbatches > 1 else max(per_dev // 2, 1)
        nm = min(nm, gb)
        while gb % nm:
            nm -= 1
        rt = dataclasses.replace(rt, microbatches=nm)
    return dataclasses.replace(cfg, runtime=rt)


# ---------------------------------------------------------------------------
# The fake process group and the mesh
# ---------------------------------------------------------------------------


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake process group of ``n`` ranks
    (collectives return at once and move nothing), replacing a fake group
    of another size."""
    import torch.distributed as dist
    # the fake backend lives in torch's testing package; it is the only
    # way to give one process a group of the production mesh's size
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over a fake group of its size (built
    outside any fake mode)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    fake_world(n)
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(*shape),
                      mesh_dim_names=tuple(axes))


def production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """``launch.mesh.make_production_mesh``'s (16, 16) or (2, 16, 16) mesh
    over a fake group of 256 or 512 ranks."""
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device)


def mesh_name(mesh) -> str:
    return "x".join(map(str, mesh.shape))


def device_memory_bytes(device: str) -> int:
    """The card's memory where one is present, else the H100 80GB's."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_80GB_BYTES


# ---------------------------------------------------------------------------
# Fake inputs
# ---------------------------------------------------------------------------


def _block(meta: torch.Tensor, spec, mesh, coords, device) -> torch.Tensor:
    """A fake tensor of the rank's block of ``meta`` under ``spec``."""
    shape = pt.local_block(meta, spec, mesh, coords).shape
    return torch.empty(shape, dtype=meta.dtype, device=device)


def _dtensors(meta_tree: Any, specs: Any, mesh, coords, device) -> Any:
    from torch.distributed.tensor import DTensor
    return pt.zip_axes(lambda spec, m: DTensor.from_local(
        _block(m, spec, mesh, coords, device), mesh,
        pt.placements(spec, mesh), run_check=False), specs, meta_tree)


def _fake(meta_tree: Any, device) -> Any:
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device=device), meta_tree)


def _replicated(t: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def cell_inputs(cfg, shape: ShapeCfg, mesh, device) -> tuple:
    """(step, args) for one cell: the step of ``launch.steps`` and its
    fake inputs (call inside ``FakeTensorMode``)."""
    from repro_torch.sharding.ctx import mesh_coords
    coords = mesh_coords(mesh)
    if shape.kind == "train":
        step, ss, _ = stp.make_jitted_train_step(cfg, mesh, stp.TrainCfg(),
                                                 shape)
        st = stp.abstract_state(cfg, stp.TrainCfg())
        state = {"params": _dtensors(st["params"], ss["params"], mesh,
                                     coords, device),
                 "opt": {"m": _dtensors(st["opt"]["m"], ss["opt"]["m"],
                                        mesh, coords, device),
                         "v": _dtensors(st["opt"]["v"], ss["opt"]["v"],
                                        mesh, coords, device),
                         "step": _replicated(torch.empty(
                             (), dtype=torch.int32, device=device), mesh)}}
        batch = _fake(stp.input_specs(cfg, shape)["batch"], device)
        return step, (state, batch)
    params = _dtensors(lm.abstract_params(cfg), stp.param_specs(cfg, mesh),
                       mesh, coords, device)
    spec = stp.input_specs(cfg, shape)
    if shape.kind == "prefill":
        return stp.make_jitted_prefill(cfg, mesh, shape), \
            (params, _fake(spec["batch"], device))
    ctx = stp.decode_ctx(cfg, mesh, shape)
    cache = tree_zip(lambda m, sp: _block(m, sp, mesh, coords, device),
                     spec["cache"], lm.cache_block_specs(spec["cache"], ctx))
    return stp.make_jitted_decode(cfg, mesh, shape), \
        (params, cache, _fake(spec["batch"], device), spec["length"])


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def trace_step(step, args, *, n_devices: int, trace: bool = False
               ) -> op_costing.OpCounter:
    """Run ``step(*args)`` once under an :class:`OpCounter` (inside the
    caller's ``FakeTensorMode`` for a dry run; on real tensors to measure
    a step), the args registered as live; returns the counter."""
    counter = op_costing.OpCounter(trace=trace, n_devices=n_devices)
    counter.add_inputs(args)
    with counter:
        out = step(*args)
    counter.finish(out)
    return counter


def lower_cell(arch: str, shape_name: Union[str, ShapeCfg], mesh, *,
               save_trace: Optional[str] = None, device: str = "cuda",
               cfg=None) -> Dict:
    """Trace and cost rank 0's step of one cell on ``mesh`` (a
    ``DeviceMesh`` over a fake group: :func:`production_mesh` or
    :func:`make_mesh`).  ``shape_name`` may be a ``ShapeCfg``; ``cfg``
    replaces ``get_config(arch)``.  Returns the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = shape_name if isinstance(shape_name, ShapeCfg) \
        else get_shape(shape_name)
    cfg = runtime_overrides(cfg if cfg is not None else get_config(arch),
                            shape, mesh)
    n_dev = int(mesh.size())
    dev = torch.device(device)
    rec: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name(mesh),
                 "n_devices": n_dev, "kind": shape.kind}
    t0 = time.time()
    with FakeTensorMode():
        step, args = cell_inputs(cfg, shape, mesh, dev)
        counter = trace_step(step, args, n_devices=n_dev,
                             trace=save_trace is not None)
        del step, args
    rec["trace_s"] = round(time.time() - t0, 2)
    rec["memory"] = counter.memory()
    rec["op_cost"] = counter.cost.to_json()
    rec["ops"] = counter.ops
    rec["device_memory_bytes"] = device_memory_bytes(device)
    rec["fits"] = (rec["memory"]["peak_bytes_per_device"]
                   <= rec["device_memory_bytes"])
    if cfg.moe is not None and shape.kind != "train":
        rec["moe_counts"] = "balanced"
    if save_trace:
        os.makedirs(save_trace, exist_ok=True)
        fn = os.path.join(save_trace,
                          f"{arch}__{shape.name}__{rec['mesh']}.jsonl")
        op_costing.save_trace(counter.records, fn)
        rec["trace_file"] = fn
    oc = rec["op_cost"]
    print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']}: "
          f"peak={rec['memory']['peak_bytes_per_device'] / 2**30:.2f} "
          f"GiB/dev flops={oc['flops']:.3e} bytes={oc['bytes']:.3e} "
          f"coll={oc['total_collective_bytes'] / 2**20:.1f} MiB "
          f"fits={rec['fits']} (trace {rec['trace_s']}s, "
          f"{counter.ops} ops)", flush=True)
    return rec


class CellTimeout(Exception):
    """A cell's trace ran past ``--cell-timeout``."""


@contextlib.contextmanager
def _time_limit(seconds: Optional[float]):
    """Raise :class:`CellTimeout` in this (main) thread after ``seconds``
    (None: no limit)."""
    if not seconds:
        yield
        return

    def expire(signum, frame):
        raise CellTimeout(f"the trace ran past {seconds:g} s (eager ops "
                          f"are dispatched one by one; a stepwise scan "
                          f"makes millions)")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _without(argv, flag: str) -> list:
    """``argv`` without ``flag`` and its value (``--flag v`` or
    ``--flag=v``)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


def _run_jobs(archs, argv, jobs: int) -> int:
    """One child process an arch, ``jobs`` at once; each child's output
    (kept in a temporary file) is printed when it ends.  Returns the
    worst exit code."""
    import tempfile
    rest = _without(_without(argv, "--jobs"), "--arch")
    todo, running, rc = list(archs), [], 0
    while todo or running:
        while todo and len(running) < jobs:
            log = tempfile.TemporaryFile("w+")
            running.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", todo.pop(0), *rest], stdout=log,
                stderr=subprocess.STDOUT, text=True), log))
        done = [(p, log) for p, log in running if p.poll() is not None]
        if not done:
            time.sleep(0.5)
            continue
        for p, log in done:
            running.remove((p, log))
            log.seek(0)
            print(log.read(), end="", flush=True)
            log.close()
            rc = max(rc, p.returncode)
    return rc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--save-trace", default=None,
                    help="directory for one JSON-lines op trace a cell")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type the fake tensors claim (cuda, cpu)")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="give up a cell's trace after this many seconds "
                         "(listed as a failure with its cause)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the archs in this many child processes "
                         "at once (each traces one arch's shapes)")
    args = ap.parse_args(argv)
    argv = list(argv if argv is not None else sys.argv[1:])
    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    if args.both:
        # the fake process group is process-global: one child a mesh
        rest = [a for a in argv if a not in ("--both", "--multi-pod")]
        rcs = [subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.dryrun", *rest, *flag]
                              ).returncode
               for flag in ([], ["--multi-pod"])]
        raise SystemExit(max(rcs))
    if args.jobs > 1 and len(archs) > 1:
        raise SystemExit(_run_jobs(archs, argv, args.jobs))
    mesh = production_mesh(args.multi_pod, args.device)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{mesh_name(mesh)}"
            try:
                with _time_limit(args.cell_timeout):
                    rec = lower_cell(arch, shape, mesh,
                                     save_trace=args.save_trace,
                                     device=args.device)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
            except Exception as e:  # noqa: BLE001
                failures.append((tag, repr(e)))
                traceback.print_exc()
                if args.fail_fast:
                    raise
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        raise SystemExit(1)
    print("\n[dryrun] all cells traced OK")


if __name__ == "__main__":
    main()
