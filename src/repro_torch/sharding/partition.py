"""Logical-axis -> mesh-axis resolution with divisibility fallback, ported
from ``repro.sharding.partition``.

One rule table serves all the architectures; when a tensor dim is not
divisible by the mesh extent of its mapped axes (e.g. 8 KV heads on a
16-way ``model`` axis) the mapping degrades to replication on that dim.

A mesh here is anything with ``axis_names`` and a ``shape`` mapping from
axis name to size — :class:`MeshShape` (no devices, for the host-side
rules) — or a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape`` tuple), read through :func:`mesh_shape`.
A :data:`Spec` stands in for ``PartitionSpec``: a tuple with one entry per
tensor dim, each ``None``, an axis name or a tuple of names (major first).
:func:`placements` turns a spec into DTensor placements, and
:func:`local_block` cuts a rank's block of a whole tensor by a spec.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# Logical axis -> mesh axes.  "fsdp" below means the composed batch axes
# (("pod","data") on the multi-pod mesh, ("data",) on a single pod).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("fsdp",),
    "ffn": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "batch": ("fsdp",),
    "seq": (),               # activations: sequence replicated by default
    "act_seq": ("model",),   # sequence-parallel activations (SP / CP)
    "act_embed": (),         # activations: d_model replicated (TP collects)
    "kv_seq": ("model",),    # decode KV cache: sequence sharded over model
    "layer": (),
}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh: Any) -> MeshShape:
    """Any mesh as a :class:`MeshShape`: a ``DeviceMesh`` by its
    ``mesh_dim_names`` and ``shape`` tuple, anything else by its
    ``axis_names`` and ``shape`` mapping."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshShape(tuple(names), tuple(int(s) for s in mesh.shape))
    names = tuple(mesh.axis_names)
    return MeshShape(names, tuple(int(mesh.shape[a]) for a in names))


def fsdp_axes(mesh: Any) -> Tuple[str, ...]:
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def rules_for(cfg, extra: Optional[Dict[str, Tuple[str, ...]]] = None
              ) -> Dict[str, Tuple[str, ...]]:
    """Arch-specific rules: small archs replicate params over data (pure
    TP+DP, no per-layer weight gathers); frontier archs FSDP-shard them."""
    rules = dict(DEFAULT_RULES)
    if not cfg.runtime.fsdp_params:
        rules["embed"] = ()
    if extra:
        rules.update(extra)
    return rules


def _resolve(axis: Optional[str], mesh: Any,
             rules: Dict[str, Tuple[str, ...]]) -> Tuple[str, ...]:
    if axis is None:
        return ()
    names = mesh_shape(mesh).axis_names
    out: Tuple[str, ...] = ()
    for a in rules.get(axis, ()):
        out += fsdp_axes(mesh) if a == "fsdp" else ((a,) if a in names
                                                    else ())
    return out


def mesh_extent(mesh: Any, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh).shape
    return math.prod(shape[a] for a in axes) if axes else 1


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             mesh: Any, rules: Optional[Dict[str, Tuple[str, ...]]] = None
             ) -> Spec:
    """The spec of one tensor; drops mesh axes that don't divide."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh).shape
    used: set = set()
    entries = []
    for dim, ax in zip(shape, axes):
        maxes = _resolve(ax, mesh, rules)
        # trim to divisible prefix, skipping axes already used by another dim
        keep: Tuple[str, ...] = ()
        ext = 1
        for m in maxes:
            if m in used:
                continue
            if dim % (ext * sizes[m]) == 0:
                keep += (m,)
                ext *= sizes[m]
        used.update(keep)
        entries.append(keep if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(entries)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def zip_axes(fn, axes_tree: Any, other: Any) -> Any:
    """``fn(axes, leaf)`` over an axes tree (axes tuples are its leaves)
    and a tree of one structure, matched by dict key and list index."""
    if axes_tree is None:
        return None
    if isinstance(axes_tree, dict):
        return {k: zip_axes(fn, v, other[k]) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [zip_axes(fn, a, o) for a, o in zip(axes_tree, other)]
    assert _is_axes(axes_tree), axes_tree
    return fn(axes_tree, other)


def spec_tree(axes_tree: Any, shape_tree: Any, mesh: Any,
              rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Any:
    """(axes, shapes) trees -> spec tree; a shape leaf is anything with a
    ``shape`` (a tensor, an array, a ``ParamDef``)."""
    return zip_axes(lambda ax, s: spec_for(tuple(s.shape), ax, mesh, rules),
                axes_tree, shape_tree)


def placements(spec: Spec, mesh: Any) -> list:
    """DTensor placements of a spec on ``mesh``: ``Shard(d)`` on each mesh
    dim that shards tensor dim d, ``Replicate()`` on the others.  DTensor
    shards one tensor dim over several mesh dims in the mesh's order, major
    first, so an entry that names them in another order has no placements:
    that raises, naming the spec (it is never reordered)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_shape(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec!r}: dim {d} is sharded over {axes}, not in the "
                f"mesh's order {names}; DTensor placements cannot express it")
        for i in idx:
            out[i] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh and its DTensor placements (``NamedSharding``'s
    counterpart)."""
    mesh: Any
    spec: Spec
    placements: tuple

    @classmethod
    def of(cls, mesh: Any, spec: Spec) -> "NamedSharding":
        return cls(mesh, spec, tuple(placements(spec, mesh)))


def sharding_tree(axes_tree: Any, shape_tree: Any, mesh: Any,
                  rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Any:
    """The :class:`NamedSharding` of every leaf: its spec and placements."""
    return tree_of_shardings(spec_tree(axes_tree, shape_tree, mesh, rules),
                             mesh)


def tree_of_shardings(specs: Any, mesh: Any) -> Any:
    """A spec tree as a tree of :class:`NamedSharding` on ``mesh``."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: tree_of_shardings(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [tree_of_shardings(v, mesh) for v in specs]
    return NamedSharding.of(mesh, specs)


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    """Axes a training/prefill global batch shards over."""
    return fsdp_axes(mesh)


def seq_shard_axes(mesh: Any, global_batch: int) -> Tuple[str, ...]:
    """Axes the decode KV sequence shards over.

    Batch takes as much of the fsdp product as it can; whatever batch cannot
    absorb (plus the model axis) shards the KV sequence — for ``long_500k``
    (batch 1) the sequence is sharded over every mesh axis.
    """
    ms = mesh_shape(mesh)
    axes = ["model"] if "model" in ms.axis_names else []
    b = global_batch
    for a in reversed(fsdp_axes(mesh)):      # consume inner axes for batch first
        if b % ms.shape[a] == 0:
            b //= ms.shape[a]
        else:
            axes.append(a)
    return tuple(axes)


def decode_batch_axes(mesh: Any, global_batch: int) -> Tuple[str, ...]:
    ms = mesh_shape(mesh)
    axes = []
    b = global_batch
    for a in reversed(fsdp_axes(mesh)):
        if b % ms.shape[a] == 0:
            b //= ms.shape[a]
            axes.append(a)
    return tuple(reversed(axes))


# ---------------------------------------------------------------------------
# A rank's block of a tensor
# ---------------------------------------------------------------------------


def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def axes_entry(axes: Sequence[str]) -> MeshAxes:
    """Mesh axes as one spec entry, as ``PartitionSpec`` writes it: None,
    an axis name, or a tuple of two or more."""
    axes = tuple(axes)
    return (axes if len(axes) > 1 else axes[0]) if axes else None


def shard_index(axes: Sequence[str], mesh: Any, coords: Dict[str, int]
                ) -> int:
    """The linear index of a rank's coordinates ``coords`` (axis name ->
    index) over ``axes`` in that order, the first axis major — what
    ``jax.lax.axis_index`` of a tuple of axes gives."""
    sizes = mesh_shape(mesh).shape
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def local_block(t, spec: Spec, mesh: Any, coords: Dict[str, int]):
    """The block of the whole tensor ``t`` that the rank at ``coords``
    holds under ``spec`` (a view: each dim sharded over an entry's axes is
    cut into their extent of equal blocks, the entry's first axis major)."""
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = mesh_extent(mesh, axes)
        size = t.shape[d] // n
        if size * n != t.shape[d]:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"into {n} blocks over {axes}")
        t = t.narrow(d, shard_index(axes, mesh, coords) * size, size)
    return t
