"""Seeded random weights made on the device in a few large calls.

The program's parameter tree (``repro_torch.models.lm.param_defs``) names
every leaf's shape, initializer and dtype.  Leaves that share an
initializer scale and a dtype are views into one flat buffer, filled by
one ``normal_`` from a ``torch.Generator`` on the device (in pieces of at
most 2**30 elements) and scaled in place: a dozen calls for a whole model,
in the dtype it is served in.  The scales are the program's own
(``fan_in``: 1/sqrt(fan-in), ``embed``: 0.02, ``ones``, ``zeros``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

import torch

_PIECE = 1 << 30


def _is_def(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "init") and \
        not isinstance(x, torch.Tensor)


def _walk(tree, path=()):
    if tree is None:
        return
    if _is_def(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))


def _scale(d) -> float:
    if d.init == "embed":
        return 0.02
    shape = d.shape
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(1, fan_in))


def _dtype(d, default: torch.dtype) -> torch.dtype:
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    return names[d.dtype] if d.dtype else default


def _rebuild(tree, leaves: Dict[Tuple, torch.Tensor], path=()):
    if tree is None:
        return None
    if _is_def(tree):
        return leaves[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    return type(tree)(_rebuild(v, leaves, path + (i,))
                      for i, v in enumerate(tree))


def make(defs: Any, seed: int, dtype: torch.dtype, device) -> Any:
    """The tree ``defs`` as tensors on ``device`` drawn from ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    groups: "OrderedDict[Tuple, List]" = OrderedDict()
    for path, d in _walk(defs):
        if d.init not in ("zeros", "ones", "embed", "fan_in"):
            raise ValueError(f"unknown init {d.init!r} at {path}")
        key = (d.init if d.init in ("zeros", "ones") else "normal",
               0.0 if d.init in ("zeros", "ones") else _scale(d),
               _dtype(d, dtype))
        groups.setdefault(key, []).append((path, d))
    leaves: Dict[Tuple, torch.Tensor] = {}
    for (kind, scale, dt), items in groups.items():
        n = sum(math.prod(d.shape) for _, d in items)
        if kind == "zeros":
            buf = torch.zeros(n, dtype=dt, device=dev)
        elif kind == "ones":
            buf = torch.ones(n, dtype=dt, device=dev)
        else:
            buf = torch.empty(n, dtype=dt, device=dev)
            for lo in range(0, n, _PIECE):
                buf[lo:lo + _PIECE].normal_(0.0, 1.0, generator=gen)
            buf.mul_(scale)
        off = 0
        for path, d in items:
            k = math.prod(d.shape)
            leaves[path] = buf[off:off + k].view(d.shape)
            off += k
    return _rebuild(defs, leaves)


def layer_list(params: Any, plan) -> List[Dict[str, Any]]:
    """Every decoder layer's weights in order (views): the prologue's
    layers, then each repeat of the stacked body.  ``plan`` is
    (prologue entries, body period entries, repeats)."""
    prologue, period, repeats = plan
    out = list(params["prologue"])

    def index(tree, r):
        if isinstance(tree, dict):
            return {k: index(v, r) for k, v in tree.items()}
        return tree[r]

    for r in range(repeats):
        for pi in range(len(period)):
            out.append(index(params["body"][pi], r))
    return out


def head_of(params: Any) -> Dict[str, torch.Tensor]:
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out
