"""The train, prefill and decode steps, ported from ``repro.launch.steps``:
``TrainCfg``, ``make_train_step(cfg, tcfg, mesh=None)`` and the mesh half —
the spec trees (``param_specs``, ``param_shardings``, ``state_specs``,
``decode_rules``, ``cache_specs``, ``decode_ctx``, ``batch_specs_tree``)
and the step builders ``make_jitted_train_step``, ``make_jitted_prefill``
and ``make_jitted_decode`` — and the dry run's stand-ins, ``input_specs`` and
``abstract_state`` (meta tensors, no allocation).

The names are the reference's, so a reader finds them; nothing is
compiled (PyTorch runs eagerly).  On a mesh every rank runs the step
itself, on its own batch rows and shards, in a process of its own
(``launch.mesh.run_ranks``); the steps take the global inputs and cut the
rank's rows from them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import lm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import DecodeCtx
from repro_torch.models.params import (axes_tree, leaves, requires_grad,
                                       torch_dtype, tree_map, tree_zip)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.runtime.elastic import distribute, whole
from repro_torch.sharding import partition as pt
from repro_torch.sharding.ctx import (BatchShards, all_reduce, is_dtensor,
                                      mesh_coords, sharding_ctx)


@dataclass(frozen=True)
class TrainCfg:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "warmup_cosine"
    adam: adamw.AdamWCfg = dataclasses.field(default_factory=adamw.AdamWCfg)


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------


def param_specs(cfg, mesh):
    defs = lm.param_defs(cfg)
    return pt.spec_tree(axes_tree(defs), defs, mesh, pt.rules_for(cfg))


def param_shardings(cfg, mesh):
    return pt.tree_of_shardings(param_specs(cfg, mesh), mesh)


def state_specs(cfg, mesh, tcfg: TrainCfg):
    ps = param_specs(cfg, mesh)
    return {"params": ps, "opt": {"m": ps, "v": ps, "step": ()}}


def decode_rules(cfg, mesh, shape) -> Dict:
    seq_axes = pt.seq_shard_axes(mesh, shape.global_batch)
    batch_axes = pt.decode_batch_axes(mesh, shape.global_batch)
    return pt.rules_for(cfg, {"kv_seq": seq_axes, "batch": batch_axes})


def cache_specs(cfg, mesh, shape):
    rules = decode_rules(cfg, mesh, shape)
    defs = lm.cache_defs(cfg, shape.global_batch, shape.seq_len)
    return pt.spec_tree(axes_tree(defs), defs, mesh, rules)


def decode_ctx(cfg, mesh, shape) -> DecodeCtx:
    if mesh is None:
        return DecodeCtx()
    return DecodeCtx(mesh=mesh,
                     seq_axes=pt.seq_shard_axes(mesh, shape.global_batch),
                     batch_axes=pt.decode_batch_axes(mesh,
                                                     shape.global_batch))


def batch_specs_tree(cfg, mesh, batch: Dict[str, Any],
                     batch_axes: Tuple[str, ...]) -> Dict[str, pt.Spec]:
    """Specs for a train/prefill batch dict (its leaves need a
    ``shape``)."""
    b = pt.axes_entry(batch_axes)
    out = {}
    for k, v in batch.items():
        if k == "positions":              # (3, B, S)
            out[k] = (None, b, None)
        else:
            out[k] = (b, *([None] * (len(v.shape) - 1)))
    return out


def input_specs(cfg, shape) -> Dict[str, Any]:
    """Stand-ins for one (arch, shape) cell's step inputs: meta tensors of
    the reference's shapes and dtypes.  Train and prefill: ``{"batch"}``
    (``tokens`` or ``embeds``, M-RoPE ``positions``, an encoder-decoder's
    frame ``embeds``, ``targets`` for train).  Decode: ``{"cache",
    "batch": {"token"}, "length"}``, where ``length`` is the int
    ``seq_len - 1`` (the reference's is a 0-d int32): the port's
    ``decode_step`` takes the fill as a Python int, and an eager step's
    cost depends on it (``use_sparse``, each shard's valid rows, the
    chunks it selects), so the stand-in is a full cache and the costliest
    step."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"cache": lm.abstract_cache(cfg, B, S),
                "batch": {"token": meta((B,))}, "length": S - 1}
    batch: Dict[str, Any] = {}
    if cfg.embed_inputs and not cfg.is_encdec:
        batch["embeds"] = meta((B, S, cfg.d_model), dt)
        if cfg.rope == "mrope":
            batch["positions"] = meta((3, B, S))
    else:
        batch["tokens"] = meta((B, S))
    if cfg.is_encdec:
        batch["embeds"] = meta((B, lm.encoder_len(cfg, S), cfg.d_model), dt)
    if shape.kind == "train":
        batch["targets"] = meta((B, S))
    return {"batch": batch}


def abstract_state(cfg, tcfg: TrainCfg) -> Dict[str, Any]:
    """The train state ``{"params", "opt"}`` as meta tensors, the moments
    in the config's ``adam_dtype``."""
    adam = dataclasses.replace(tcfg.adam, state_dtype=cfg.runtime.adam_dtype)
    params = lm.abstract_params(cfg)
    return {"params": params, "opt": adamw.abstract_opt_state(params, adam)}


def _rows(batch: Dict[str, Any], mesh, axes: Tuple[str, ...], device
          ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (``batch_specs_tree``'s blocks);
    ranks that differ only off ``axes`` hold the same rows.  ``device``
    None leaves each block where its leaf is."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    specs = batch_specs_tree(None, mesh, batch, axes)
    coords = mesh_coords(mesh)
    return {k: pt.local_block(v, specs[k], mesh, coords).to(device)
            for k, v in batch.items()}


def whole_params(params: Any) -> Any:
    """Parameters made whole on every rank: DTensor leaves gathered
    (``full_tensor``), plain leaves taken as replicated."""
    return tree_map(whole, params)


def distribute_tree(tree: Any, specs: Any, mesh, device=None) -> Any:
    """A whole tree (the same on every rank) as DTensors laid out by a
    spec tree of the same structure (each rank cuts its own blocks: no
    collective)."""
    return pt.zip_axes(lambda spec, t: distribute(
        t, pt.NamedSharding.of(mesh, spec), device), specs, tree)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _microbatches(batch: Dict[str, Any], nm: int, device) -> list:
    """The batch split into ``nm`` microbatches of consecutive rows, as
    the reference splits it (``positions`` (3, B, S) along its B)."""
    out = [{} for _ in range(nm)]
    for k, v in batch.items():
        v = torch.as_tensor(v).to(device)
        axis = 1 if k == "positions" else 0
        if v.shape[axis] % nm:
            raise ValueError(f"batch[{k!r}] has {v.shape[axis]} rows, not a "
                             f"multiple of {nm} microbatches")
        for i, part in enumerate(v.chunk(nm, dim=axis)):
            out[i][k] = part
    return out


def _spec_pairs(tree: Any, specs: Any) -> list:
    """(leaf, spec) in the tree's leaf order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _spec_pairs(v,
                                                                specs[k])]
    if isinstance(tree, list):
        return [p for v, s in zip(tree, specs) for p in _spec_pairs(v, s)]
    return [(tree, specs)]


class _MeshLayout:
    """How a train step on ``mesh`` places the state: each parameter and
    moment leaf a DTensor laid out by ``param_specs``; each rank's rows of
    every microbatch by ``batch_axes(mesh)``."""

    def __init__(self, cfg, mesh):
        self.mesh = mesh
        self.specs = param_specs(cfg, mesh)
        self.batch_axes = pt.batch_axes(mesh)
        self.coords = mesh_coords(mesh)
        self.shards = BatchShards(mesh, self.batch_axes) \
            if pt.mesh_extent(mesh, self.batch_axes) > 1 else None

    def rows(self, mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return _rows(mb, self.mesh, self.batch_axes, None)

    def block(self, t: torch.Tensor, spec: pt.Spec) -> torch.Tensor:
        if is_dtensor(t):
            return t.to_local()
        return pt.local_block(t, spec, self.mesh, self.coords)

    def blocks(self, tree: Any) -> Any:
        return tree_zip(self.block, tree, self.specs)

    def distribute(self, tree: Any) -> Any:
        from torch.distributed.tensor import DTensor
        return tree_zip(lambda t, spec: DTensor.from_local(
            t, self.mesh, pt.placements(spec, self.mesh), run_check=False),
            tree, self.specs)

    def token_shares(self, mbs: list) -> list:
        """Each microbatch's weight: its rank's share of the microbatch's
        valid targets over every batch shard (None on one batch shard), so
        the shards' weighted cross-entropies sum to the microbatch's."""
        if self.shards is None:
            return [None] * len(mbs)
        local = torch.stack([(mb["targets"] >= 0).sum().float()
                             for mb in mbs])
        return list(local / self.shards.sum(local).clamp(min=1.0))

    def sum_over_batch(self, tree: Any) -> Any:
        if self.shards is None:
            return tree
        return tree_map(self.shards.sum, tree)

    def norm(self, tree: Any) -> torch.Tensor:
        """The global norm of the whole tree from this rank's blocks: each
        leaf's square sum reduced over the axes that shard it, then summed
        in leaf order (over one rank: ``adamw.global_norm``'s arithmetic)."""
        sq = []
        for leaf, spec in _spec_pairs(tree, self.specs):
            s = leaf.float().square().sum()
            axes = [a for e in spec for a in pt.entry_axes(e)]
            sq.append(all_reduce(s, self.mesh, axes, "sum") if axes else s)
        return torch.sqrt(sum(sq))


def make_train_step(cfg, tcfg: TrainCfg, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params", "opt"}`` (:func:`adamw.init_opt_state`);
    ``batch`` holds numpy arrays or tensors (``tokens``/``embeds``,
    ``targets``, optional ``positions``).  The batch is split into
    ``cfg.runtime.microbatches`` microbatches; each one's gradients come
    from ``torch.autograd.grad`` of :func:`lm.forward_train` and are
    summed into a tree in the reference's ``gzero`` dtype (the config's
    ``adam_dtype``), never into a bf16 ``.grad``.  Then the schedule's
    learning rate at the state's step and :func:`adamw.apply_updates`
    with ``grad_scale=1/nm``.  Metrics: the microbatches' mean ``loss``
    and ``accuracy``, ``grad_norm``, ``param_norm`` and ``lr``.  The
    input state is not written.

    On a ``mesh`` (a ``DeviceMesh``) every rank calls the step with the
    global batch and splits it into the same microbatches; each rank
    takes its rows of every microbatch (its block over
    ``batch_axes(mesh)``; ranks along ``model`` hold the same rows).  The
    parameters are made whole on every rank.  Each rank's loss is its
    rows' mean cross-entropy weighted by their share of the microbatch's
    valid targets, plus its rows' terms of the MoE aux losses, which
    ``lm.forward_train`` computes over the whole microbatch (capacity,
    expert ranks and routing statistics reduced over the batch axes).  So
    the ranks' losses and gradients sum to the microbatch's, as the
    reference's step computes it on the global batch.  The gradients are
    summed over the batch axes and each rank updates its own shards;
    ``grad_norm``, the clip and ``param_norm`` are those of the whole
    trees.  The state returned is DTensors laid out by
    :func:`state_specs` (the state given may be DTensors or whole
    tensors)."""
    sched = SCHEDULES[tcfg.schedule]
    nm = max(1, cfg.runtime.microbatches)
    gdt = torch_dtype(cfg.runtime.adam_dtype)
    layout = None if mesh is None else _MeshLayout(cfg, mesh)

    def train_step(state, batch):
        params = state["params"] if layout is None \
            else whole_params(state["params"])
        dev = leaves(params)[0].device
        mbs = _microbatches(batch, nm, dev)
        shards, shares = None, [None] * nm
        if layout is not None:
            mbs = [layout.rows(mb) for mb in mbs]
            shards, shares = layout.shards, layout.token_shares(mbs)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt,
                                              device=p.device), params)
        gleaves = leaves(gsum)
        msum = {k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in ("loss", "accuracy")}
        for mb, share in zip(mbs, shares):
            ptree = requires_grad(params)
            loss, metrics = lm.forward_train(ptree, cfg, mb, shards)
            acc = metrics["accuracy"].detach().float()
            if share is not None:
                loss = metrics["nll"] * share
                if "moe_lb_loss" in metrics:
                    loss = loss + mlp_mod.moe_loss(metrics, cfg)
                acc = acc * share
            grads = torch.autograd.grad(loss, leaves(ptree),
                                        allow_unused=True)
            with torch.no_grad():
                for a, g in zip(gleaves, grads):
                    if g is not None:
                        a.add_(g)
                msum["loss"] = msum["loss"] + loss.detach().float()
                msum["accuracy"] = msum["accuracy"] + acc
            del ptree, loss, metrics, grads
        lr = sched(whole(state["opt"]["step"]), peak_lr=tcfg.lr,
                   warmup_steps=tcfg.warmup_steps,
                   total_steps=tcfg.total_steps)
        if layout is None:
            params_new, opt_new, om = adamw.apply_updates(
                params, gsum, state["opt"], tcfg.adam, lr,
                grad_scale=1.0 / nm)
        else:
            gsum = layout.sum_over_batch(gsum)
            msum = layout.sum_over_batch(msum)
            opt = state["opt"]
            local = {"m": layout.blocks(opt["m"]),
                     "v": layout.blocks(opt["v"]),
                     "step": whole(opt["step"])}
            p_new, o_new, om = adamw.apply_updates(
                layout.blocks(state["params"]), layout.blocks(gsum), local,
                tcfg.adam, lr, grad_scale=1.0 / nm, norm=layout.norm)
            from torch.distributed.tensor import DTensor, Replicate
            params_new = layout.distribute(p_new)
            opt_new = {"m": layout.distribute(o_new["m"]),
                       "v": layout.distribute(o_new["v"]),
                       "step": DTensor.from_local(
                           o_new["step"], mesh,
                           [Replicate()] * len(mesh.mesh_dim_names),
                           run_check=False)}
        metrics = {k: v / nm for k, v in msum.items()}
        metrics.update(om)
        metrics["lr"] = lr
        return {"params": params_new, "opt": opt_new}, metrics

    return train_step


def make_jitted_train_step(cfg, mesh, tcfg: TrainCfg, shape):
    """The train step on ``mesh`` with the config's Adam state dtype, its
    state specs and its batch specs (the reference's in_shardings)."""
    adam = dataclasses.replace(tcfg.adam, state_dtype=cfg.runtime.adam_dtype)
    tcfg = dataclasses.replace(tcfg, adam=adam)
    step = make_train_step(cfg, tcfg, mesh)
    ss = state_specs(cfg, mesh, tcfg)
    bspec = batch_specs_tree(cfg, mesh, input_specs(cfg, shape)["batch"],
                             pt.batch_axes(mesh))
    return step, ss, bspec


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def make_jitted_prefill(cfg, mesh, shape):
    """``prefill_step(params, batch) -> (logits, cache)`` on ``mesh``: each
    rank prefills its decode batch rows whole (``decode_ctx``'s
    ``batch_axes``) and keeps its block of their cache
    (``lm.shard_cache``); the logits are its rows'.  ``batch`` is the
    global batch; parameters are DTensors (made whole) or plain tensors
    (taken as replicated)."""
    ctx = decode_ctx(cfg, mesh, shape)
    rules = decode_rules(cfg, mesh, shape)

    def prefill_step(params, batch):
        params = whole_params(params)
        dev = leaves(params)[0].device
        rows = _rows(batch, mesh, ctx.batch_axes, dev)
        with sharding_ctx(mesh, rules):
            return lm.prefill(params, cfg, rows, max_len=shape.seq_len,
                              ctx=ctx)

    return prefill_step


def make_jitted_decode(cfg, mesh, shape):
    """``decode_step(params, cache, batch, length, impl=None) -> (logits,
    cache)`` on ``mesh``: ``lm.decode_step`` under ``decode_ctx`` on this
    rank's cache block (as :func:`make_jitted_prefill` leaves it) and its
    rows of the global ``batch`` (``token`` (B,) or ``embeds``); returns
    its rows of the logits and its block of the cache (written in
    place)."""
    ctx = decode_ctx(cfg, mesh, shape)
    rules = decode_rules(cfg, mesh, shape)

    def decode_step(params, cache, batch, length, impl=None):
        params = whole_params(params)
        dev = leaves(params)[0].device
        rows = _rows(batch, mesh, ctx.batch_axes, dev)
        with sharding_ctx(mesh, rules):
            return lm.decode_step(params, cfg, cache, rows, length, ctx=ctx,
                                  impl=impl)

    return decode_step
