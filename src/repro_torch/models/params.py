"""Module-free parameter system (the port of ``repro.models.params``).

A model is a nested dict/list tree of :class:`ParamDef`; :func:`init_tree`
turns it into tensors on a device with the same distributions as the JAX
``init_leaf`` (drawn from a ``torch.Generator``, so not the same numbers),
and :func:`params_from_jax` carries a JAX ``lm.init`` tree — converted to
numpy by the caller — across leaf for leaf, so both packages can run the
same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A dtype name (``"bfloat16"``...) or torch dtype as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    init: str = "fan_in"                      # fan_in | embed | zeros | ones
    dtype: Optional[str] = None               # override model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable, tree: Any, is_leaf: Callable = lambda x: False
             ) -> Any:
    """Map over the leaves of a nested dict / list / tuple tree (None stays
    None, as in a JAX pytree)."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_zip(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn(leaf, *other_leaves)`` over trees of one structure, matched by
    dict key and list index (not by leaf order: JAX rebuilds a dict in
    sorted key order).  Tuples are leaves here, so ``fn`` may return
    one."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_zip(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_zip(fn, *vs) for vs in zip(tree, *others)]
    return fn(tree, *others)


def abstract_tree(defs: Any, dtype) -> Any:
    """Meta tensors of every ``ParamDef``'s shape and dtype (the
    reference's ``ShapeDtypeStruct`` mirror): stand-ins for the dry run,
    with no allocation."""
    dt = torch_dtype(dtype)
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=torch_dtype(d.dtype) if d.dtype else dt,
        device="meta"), defs, is_leaf=is_def)


def axes_tree(defs: Any) -> Any:
    """The logical axes of every ``ParamDef`` (a tuple per leaf): the
    input of ``sharding.partition.spec_tree``."""
    return tree_map(lambda d: d.axes, defs, is_leaf=is_def)


def leaves(tree: Any) -> list:
    """The tree's leaves in its order (None is an empty subtree)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _fan_in(shape: Tuple[int, ...]) -> int:
    return shape[-2] if len(shape) >= 2 else shape[-1]


def init_leaf(gen: torch.Generator, d: ParamDef, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    dt = torch_dtype(d.dtype) if d.dtype else dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init in ("embed", "fan_in"):
        scale = 0.02 if d.init == "embed" else \
            1.0 / float(np.sqrt(max(1, _fan_in(d.shape))))
        w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dt)
    raise ValueError(f"unknown init {d.init!r}")


def init_tree(defs: Any, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> Any:
    """Initialize every leaf in tree order from one generator on
    ``device`` (``gen`` must live on the same device)."""
    return tree_map(lambda d: init_leaf(gen, d, dtype, device), defs,
                    is_leaf=is_def)


def params_from_jax(tree_of_numpy: Any, device, dtype=None) -> Any:
    """A JAX parameter tree already converted to numpy (``jax.tree.map(
    np.asarray, params)``) as the port's tree: same nesting, body leaves
    keep their leading repeat axis.  ``dtype`` (optional) casts every leaf;
    bfloat16 numpy leaves cross through float32, which is exact.  A whole
    train state ``{"params", "opt": {"m", "v", "step"}}`` crosses the same
    way (without ``dtype``): moments keep their dtype, ``step`` stays an
    int32 0-d tensor."""
    dev = torch.device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return t.to(dev)

    return tree_map(conv, tree_of_numpy)


def requires_grad(tree: Any) -> Any:
    """The tree's leaves as new leaf tensors that require gradients,
    sharing their storage (``detach`` makes no copy): the inputs of one
    ``torch.autograd.grad``."""
    return tree_map(lambda a: a.detach().requires_grad_(True), tree)
