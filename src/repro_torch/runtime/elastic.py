"""Elastic scaling: rebuild the mesh from the live ranks and reshard,
ported from ``repro.runtime.elastic``.

When ranks drop out (or join), the controller builds a new ``(data,
model)`` mesh over the surviving ranks; parameters and optimizer state are
re-laid-out onto it from host copies or the latest checkpoint.  Works with
any rank count whose factorization supports a (data, model) grid.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding import partition as pt
from repro_torch.sharding.ctx import is_dtensor, mesh_coords


def choose_grid(n_devices: int, *, prefer_model: int = 16
                ) -> Tuple[int, int]:
    """(data, model) factorization: keep model parallelism near the target
    width, give the rest to data."""
    model = math.gcd(n_devices, prefer_model)
    while model > 1 and n_devices % model:
        model //= 2
    return n_devices // max(model, 1), max(model, 1)


def make_mesh_from_devices(ranks: Optional[Sequence[int]] = None, *,
                           prefer_model: int = 16,
                           device: DeviceLike = None):
    """A ``(data, model)`` ``DeviceMesh`` of :func:`choose_grid`'s shape
    over the first ``data * model`` of ``ranks`` (every rank of the
    process group by default).  Every rank of the group calls it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    data, model = choose_grid(len(ranks), prefer_model=prefer_model)
    grid = torch.tensor(ranks[: data * model]).reshape(data, model)
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=("data", "model"))


def whole(leaf: Any) -> Any:
    """A leaf made whole on every rank: a DTensor's ``full_tensor()`` (a
    collective), anything else as it is."""
    return leaf.full_tensor() if is_dtensor(leaf) else leaf


def distribute(t: torch.Tensor, sharding: pt.NamedSharding,
               device: Optional[torch.device] = None):
    """The whole tensor ``t`` (the same on every rank) as a DTensor laid
    out by ``sharding``: this rank's block, cut with no collective."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    block = pt.local_block(t, sharding.spec, mesh, mesh_coords(mesh))
    if device is not None:
        block = block.to(device)
    return DTensor.from_local(block.contiguous(), mesh,
                              list(sharding.placements), run_check=False)


def reshard_tree(tree: Any, axes_tree: Any, new_mesh) -> Any:
    """Host-round-trip reshard of a state tree onto ``new_mesh``: each leaf
    is made whole and brought to the host, then distributed by
    ``spec_for`` of its logical axes on the new mesh (on the mesh's device
    type)."""
    dev = torch.device(new_mesh.device_type)

    def one(leaf, axes):
        host = whole(leaf)
        host = host.cpu() if isinstance(host, torch.Tensor) \
            else torch.as_tensor(host)
        spec = pt.spec_for(tuple(host.shape), axes, new_mesh)
        return distribute(host, pt.NamedSharding.of(new_mesh, spec), dev)
    return pt.zip_axes(lambda ax, leaf: one(leaf, ax), axes_tree, tree)


def shrink_batch_for(global_batch: int, new_mesh) -> int:
    """Largest batch <= global_batch divisible by the new data extent."""
    d = pt.mesh_shape(new_mesh).shape.get("data", 1)
    return max(d, (global_batch // d) * d)
