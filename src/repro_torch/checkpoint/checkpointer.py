"""Checkpointing: atomic step directories, async save, restore into a
template — ported from ``repro.checkpoint.checkpointer`` with the same
layout, so either package restores the other's f32 checkpoints::

    <root>/step_00000100.tmp/   (written, then atomically renamed)
    <root>/step_00000100/
        meta.json             (step, per leaf: file, shape, dtype)
        <key with / as __>.npy (one file per leaf, on the host)

Leaf keys are the reference's: ``/``-joined dict keys and list indices
(``params/prologue/0/core/wq``, ``opt/step``).  numpy has no bfloat16, so
a bf16 leaf is written as its ``uint16`` bits with ``"dtype":
"bfloat16"`` in ``meta.json`` and restored bit for bit.  ``restore`` puts
each leaf on its template leaf's device (numpy leaves stay numpy), or,
with ``shardings=``, lays it out as a DTensor by its sharding's placements
on that sharding's mesh: the elastic-rescale path (``runtime.elastic``).

A tree of DTensors (a state on a mesh) is saved whole: every rank makes
its leaves whole (a collective), rank 0 alone writes and renames the step
directory, and the others wait for it; such a save does not return before
the directory is in place.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_map
from repro_torch.sharding.ctx import is_dtensor

BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the tree's order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _to_host(x: Any) -> np.ndarray:
    """A leaf as a numpy array; a bf16 tensor as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


class Checkpointer:
    def __init__(self, root: str, *, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Any] = None
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save(self, step: int, tree: Any, *, block: bool = False) -> None:
        """Copy to the host, then write on the worker (one save in flight:
        a second save waits for the first).  A tree with DTensor leaves is
        made whole on every rank and written by rank 0 while the others
        wait (a blocking save on every rank)."""
        if any(is_dtensor(v) for _, v in _flatten(tree)):
            self._save_from_mesh(step, tree)
            return
        dtypes = {k: BF16 for k, v in _flatten(tree)
                  if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16}
        host_tree = tree_map(_to_host, tree)
        self.wait()
        self._pending = self._pool.submit(self._write, step, host_tree,
                                          dtypes)
        if block or not self.async_save:
            self.wait()

    def _save_from_mesh(self, step: int, tree: Any) -> None:
        import torch.distributed as dist

        from repro_torch.runtime.elastic import whole
        tree = tree_map(whole, tree)
        if dist.get_rank() == 0:
            self.save(step, tree, block=True)
        dist.barrier()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Finish the save in flight and stop the worker."""
        self.wait()
        self._pool.shutdown()

    def _write(self, step: int, host_tree: Any, dtypes) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "leaves": {}}
        for key, leaf in _flatten(host_tree):
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), leaf)
            meta["leaves"][key] = {"file": fname,
                                   "shape": list(np.shape(leaf)),
                                   "dtype": dtypes.get(key,
                                                       str(leaf.dtype))}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Tuple[Any, int]:
        """Load into the structure of ``template`` (the latest step unless
        ``step`` is given); each leaf on its template leaf's device, or,
        with ``shardings`` (a tree of ``partition.NamedSharding`` of the
        template's structure), distributed by its placements (elastic
        reshard)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)

        def load(key, leaf, shard):
            info = meta["leaves"][key]
            arr = np.load(os.path.join(d, info["file"]))
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {want}")
            if not isinstance(leaf, torch.Tensor) and shard is None:
                return arr
            if info["dtype"] == BF16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if shard is not None:
                from repro_torch.runtime.elastic import distribute
                return distribute(t, shard,
                                  torch.device(shard.mesh.device_type))
            return t.to(leaf.device)

        shard_of = dict(_flatten(shardings)) if shardings is not None \
            else {}
        loaded = iter([load(k, v, shard_of.get(k))
                       for k, v in _flatten(template)])
        return tree_map(lambda _: next(loaded), template), step
