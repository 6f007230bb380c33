"""The sharding context and the collectives over mesh axes, ported from
``repro.sharding.ctx``.

Model code is mesh-agnostic; launch code activates a mesh+rules context
and ``constrain(x, logical_axes)`` resolves logical axes to a layout.  In
the port each rank is a process that runs the local function itself (the
reference's ``shard_map`` has no counterpart): ``constrain`` redistributes
a DTensor to the spec's placements and returns a plain per-rank tensor as
it is, which is what the reference's constraint means inside its manual
region.  Outside a context both are no-ops.

The collectives here reduce over named mesh axes, one axis's process group
after another.  A gloo group reduces host tensors: a CUDA tensor crosses
a gloo group through the host (gloo's CUDA reductions are not relied on),
an NCCL group reduces it on the card.  The rule goes by the group's
backend, not by a failure.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.sharding import partition as pt

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx",
                                                      default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Dict] = None):
    tok = _CTX.set((mesh, rules or pt.DEFAULT_RULES))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_mesh():
    v = _CTX.get()
    return v[0] if v else None


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, axes: Tuple[Optional[str], ...]
              ) -> torch.Tensor:
    """Redistribute a DTensor to the spec of its logical ``axes`` if a
    context is active; a plain tensor is returned as it is."""
    v = _CTX.get()
    if v is None or not is_dtensor(x):
        return x
    mesh, rules = v
    spec = pt.spec_for(tuple(x.shape), axes, mesh, rules)
    return x.redistribute(x.device_mesh, pt.placements(spec, mesh))


def constrain_priority(x: torch.Tensor, *options: Tuple[Optional[str], ...]
                       ) -> torch.Tensor:
    """Constrain with the first option that shards the most dims (q heads
    over ``model`` when the head count divides, else the sequence)."""
    v = _CTX.get()
    if v is None or not is_dtensor(x):
        return x
    mesh, rules = v
    best, best_n = None, -1
    for axes in options:
        spec = pt.spec_for(tuple(x.shape), axes, mesh, rules)
        n = sum(e is not None for e in spec)
        if n > best_n:
            best, best_n = spec, n
    return x.redistribute(x.device_mesh, pt.placements(best, mesh))


# ---------------------------------------------------------------------------
# A rank's place on a DeviceMesh, and collectives over its axes
# ---------------------------------------------------------------------------


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def _via_host(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str], op: str = "sum"
               ) -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over the mesh ``axes``, one
    axis's group after another; returns a new tensor on ``t``'s device."""
    import torch.distributed as dist
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = t.clone()
    for ax in axes:
        group = mesh.get_group(ax)
        if _via_host(out, group):
            host = out.cpu()
            dist.all_reduce(host, op=rop, group=group)
            out = host.to(t.device)
        else:
            dist.all_reduce(out, op=rop, group=group)
    return out


@dataclass(frozen=True)
class BatchShards:
    """A batch cut into equal blocks of rows over the mesh ``axes``, this
    rank's block being number :attr:`index` of :attr:`n` (the first axis
    major, as :func:`partition.local_block` cuts it).  Code that needs a
    statistic of the whole batch (the MoE capacity dispatch in training)
    reduces over these axes."""
    mesh: Any
    axes: Tuple[str, ...]

    @property
    def n(self) -> int:
        return pt.mesh_extent(self.mesh, self.axes)

    @property
    def index(self) -> int:
        return pt.shard_index(self.axes, self.mesh, mesh_coords(self.mesh))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the blocks."""
        return all_reduce(t, self.mesh, self.axes, "sum")

    def before(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the blocks before this rank's (0 on the
        first)."""
        rows = t.new_zeros((self.n, *t.shape))
        rows[self.index] = t
        return self.sum(rows)[:self.index].sum(dim=0)


def gather_block(block: torch.Tensor, spec: pt.Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``block`` under ``spec`` (an
    all-gather over the whole mesh; each rank's block goes back to the
    place :func:`partition.local_block` cut it from)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if mesh.mesh.numel() != world:
        raise ValueError(f"the mesh holds {mesh.mesh.numel()} of the "
                         f"{world} ranks; gather_block needs them all")
    src = block.contiguous()
    if _via_host(src, None):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    shape = list(block.shape)
    for d, entry in enumerate(spec):
        shape[d] *= pt.mesh_extent(mesh, pt.entry_axes(entry))
    whole = torch.empty(shape, dtype=block.dtype, device=src.device)
    for rank, part in enumerate(parts):
        at = (mesh.mesh == rank).nonzero()[0].tolist()
        pt.local_block(whole, spec, mesh,
                       dict(zip(mesh.mesh_dim_names, at))).copy_(part)
    return whole.to(block.device)
