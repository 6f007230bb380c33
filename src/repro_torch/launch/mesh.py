"""Device meshes over ``torch.distributed``, ported from
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
(``("data", "model")``, or ``("pod", "data", "model")`` across pods) over
the ranks of a process group that :func:`init_distributed` starts with its
ranks and address given explicitly: nothing on the machine tells a
program of a cluster.  :func:`run_ranks` starts the processes of a mesh on
one host and returns what each rank's function returned.

Single pod: a (16, 16) = 256-rank (data, model) grid; multi-pod: (2, 16,
16) = 512 ranks with a leading ``pod`` axis that composes with ``data``
for batch/FSDP sharding.
"""

from __future__ import annotations

import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.ctx import sharding_ctx

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def default_backend(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: Optional[str] = None,
                     device: DeviceLike = None, timeout_s: float = 300.0
                     ) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://127.0.0.1:<port>`` or ``file://<path>``).
    ``backend`` defaults to :func:`default_backend` of ``device`` (the card
    unless the caller names the CPU); a CUDA rank takes the card
    ``rank % device_count``.  Returns the rank's device."""
    import datetime

    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh over {tuple(axes)} needs "
                         f"{n} ranks; the process group has {world}")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(*shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """(16, 16) ``(data, model)``, or (2, 16, 16) ``(pod, data, model)``
    with ``multi_pod``: needs 256 or 512 ranks, and raises a ``ValueError``
    naming the sizes otherwise."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 2, model: int = 2, device: DeviceLike = None):
    """A small ``(data, model)`` mesh over the ranks of one host (the
    multi-process tests: gloo ranks on the CPU, or ranks on one card)."""
    return _mesh((data, model), ("data", "model"), device)


def set_mesh(mesh):
    """Context manager activating ``mesh`` (with the default rules) for
    ``sharding.ctx.constrain``."""
    return sharding_ctx(mesh)


# ---------------------------------------------------------------------------
# Starting the ranks of a mesh on one host
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, init_method, backend, device, args, out):
    import torch.distributed as dist
    try:
        dev = init_distributed(rank, world, init_method, backend, device)
        res = fn(rank, world, dev, *args)
        out.put((rank, True, res))
    except BaseException:                      # reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *, device: DeviceLike = None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None, args: Sequence = (),
              timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    (spawned, so ``fn`` must be importable by name), each joined to one
    process group with its explicit rank (:func:`init_distributed` at
    ``init_method``, by default ``tcp://127.0.0.1:<a free port>``), and
    return every rank's result in rank order (results cross by pickle:
    return host objects).  Raises if any rank raises — with that rank's
    traceback —, exits without a result, or is not done within
    ``timeout_s``; then every process is stopped."""
    import torch.multiprocessing as mp
    dev = resolve_device(device)
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init_method, backend, dev,
                               tuple(args), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(results))
                raise TimeoutError(f"run_ranks: ranks {late} not done "
                                   f"after {timeout_s} s")
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results
                        and r not in errors]
                if dead:
                    # a rank that died without a word: give its queue a
                    # moment, then fail
                    time.sleep(1.0)
                    if out.empty():
                        raise RuntimeError(
                            f"run_ranks: rank(s) {dead} exited (codes "
                            f"{[procs[r].exitcode for r in dead]}) without "
                            f"a result")
                continue
            (results if ok else errors)[rank] = res
            if errors:
                break
        if errors:
            r = min(errors)
            raise RuntimeError(f"run_ranks: rank {r} of {world} failed:\n"
                               f"{errors[r]}")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=5.0)
        out.close()
