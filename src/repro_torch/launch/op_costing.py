"""Per-rank cost of one eager step, counted op by op: the port's
counterpart of ``repro.launch.hlo_costing``.

The reference parses a compiled SPMD module and scales loop bodies by
their trip counts.  PyTorch runs eagerly, so there is no module and no
loop to scale: :class:`OpCounter`, a ``TorchDispatchMode``, sees every op
that one rank dispatches — every layer, every iteration, every
recomputation of a remat block — and charges each by the reference's
rules:

* dots (``mm``, ``bmm``, ``addmm``, ``baddbmm``...): 2·M·N·K;
* pointwise ops: one FLOP per output element;
* reductions: output plus input elements (``hlo_costing.py``'s reduce);
* bytes: the operands plus the results of every op that computes; views
  and metadata ops cost nothing (the reference's skip list);
* in-place writes (``copy_``, ``index_copy_``, ``index_put_``): twice
  the written slice; gathers (``index_select``, ``gather``, advanced
  indexing): twice the output; scatters: twice the update;
* collectives (``c10d`` in-place ops and ``_c10d_functional`` ops): the
  reference's ring wire bytes per participant — all-reduce 2·b·(g−1)/g,
  all-gather and reduce-scatter b·(g−1)/g, all-to-all b·(g−1)/g, a
  broadcast b (the reference's collective-permute) — counted per kind,
  the group size g read from the op's group argument;
* the port's kernels (``torch.ops.repro_torch.*``): their own ``cost_*``
  formulas (``kernels/*/ops.py``), never their plain versions' ops.

Eager torch fuses nothing: every op's operands and results go through the
card's memory, so the bytes here are what the port moves, where the
reference's fused HLO moves fewer.  That is a finding about the port, not
a fault of the count.

The counter also keeps the live bytes per device (the analogue of the
reference's ``memory_analysis``): the inputs' storages, plus each new
output storage from its op until it is freed (a weakref finalizer on the
storage), as a maximum.  With ``trace=True`` it keeps one record a costed
op (JSON-able: op, kind, shapes, dtypes, group size, kernel arguments);
:func:`analyze` re-costs saved records with no retrace.

All numbers are per device: the counter runs in one rank's process.
"""

from __future__ import annotations

import json
import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_VIEWS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "transpose", "t", "permute", "movedim", "slice", "select",
    "unsqueeze", "squeeze", "detach", "alias", "as_strided", "split",
    "split_with_sizes", "chunk", "unbind", "narrow", "unfold", "diagonal",
    "view_as", "view_as_real", "view_as_complex", "lift_fresh", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "is_same_size", "conj", "_conj", "_neg_view", "real",
    "imag", "set_", "resize_",
}
# copies and casts move bytes but compute nothing (the reference's convert
# and copy are no FLOPs either)
_COPIES = {"clone", "_to_copy", "contiguous"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv", "addmv"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "var", "std", "var_mean", "std_mean", "logsumexp", "norm",
    "linalg_vector_norm", "_softmax", "_log_softmax", "cumsum", "cumprod",
    "logcumsumexp", "any", "all", "count_nonzero", "nansum", "aminmax",
}
_GATHERS = {"index_select", "gather", "index", "embedding", "take"}
_SCATTERS = {
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "index_reduce",
    "index_reduce_", "masked_scatter", "masked_scatter_", "slice_scatter",
    "select_scatter", "index_put",
}
_WRITES = {"copy_", "index_copy_", "index_copy", "index_put_",
           "_index_put_impl_"}
_FILLS = {"fill_", "zero_", "zeros", "ones", "full", "zeros_like",
          "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
          "scalar_tensor", "arange", "randn", "rand", "randint", "normal_",
          "uniform_", "random_", "bernoulli_", "lift_fresh_copy"}
# c10d in-place ops and _c10d_functional ops -> the reference's kinds
_COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional")
KERNEL_NS = "repro_torch"


def _kernel_costs() -> Dict[str, Any]:
    """The port's kernel ops and their cost formulas (imported on first
    use: the kernel modules register the ops)."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.sparse_decode import ops as sd
    return {"chunk_bounds": cb.cost_chunk_bounds,
            "chunk_bounds_gqa": cb.cost_chunk_bounds_gqa,
            "sparse_decode": sd.cost_sparse_decode}


# ---------------------------------------------------------------------------
# Cost
# ---------------------------------------------------------------------------


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0                      # operand+result traffic
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Cost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0) + v

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_json(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": self.total_collective_bytes}


# ---------------------------------------------------------------------------
# Records: one costed op, JSON-able
# ---------------------------------------------------------------------------

def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def _numel(shape: Iterable[int]) -> int:
    return math.prod(shape)


def _nbytes(desc) -> int:
    return _numel(desc[0]) * _itemsize(desc[1])


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (its shape is what the rank holds)."""
    return getattr(t, "_local_tensor", t)


def _collect(x, out: List[torch.Tensor]) -> None:
    if isinstance(x, torch.Tensor):
        out.append(_local(x))
    elif isinstance(x, (list, tuple)):
        for y in x:
            _collect(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _collect(y, out)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nested args tree, DTensors as their local blocks.
    (A module-level walk: a nested recursive closure would be a reference
    cycle holding the tensors until the garbage collector runs.)"""
    out: List[torch.Tensor] = []
    _collect(tree, out)
    return out


def _desc(t: torch.Tensor) -> List:
    return [list(t.shape), _dtype_name(t.dtype)]


def _group_size(args, kwargs) -> Optional[int]:
    """The size of the process group a collective runs over: a c10d op's
    ``ProcessGroup`` argument, or a functional op's group name."""
    import torch.distributed as dist
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(a).size()
    return None


def _written_index_put(self_t: torch.Tensor, indices) -> int:
    """Elements an ``index_put`` writes: the indexed positions times the
    dims it leaves whole (a boolean mask: every element of ``self``)."""
    idx = [i for i in indices if i is not None]
    if any(i.dtype == torch.bool for i in idx):
        return self_t.numel()
    shape = torch.broadcast_shapes(*(tuple(i.shape) for i in idx)) \
        if idx else ()
    rest = [s for j, s in enumerate(self_t.shape)
            if j >= len(indices) or indices[j] is None]
    return _numel(shape) * _numel(rest)


def _jsonable(a):
    if isinstance(a, torch.Tensor):
        return {"t": _desc(_local(a))}
    if isinstance(a, (list, tuple)):
        return [_jsonable(x) for x in a]
    if isinstance(a, (int, float, bool, str)) or a is None:
        return a
    return repr(a)


def _from_json(a):
    if isinstance(a, dict) and "t" in a:
        shape, dt = a["t"]
        return torch.empty(shape, dtype=getattr(torch, dt), device="meta")
    if isinstance(a, list):
        return [_from_json(x) for x in a]
    return a


def op_record(func, args, kwargs, out) -> Optional[Dict[str, Any]]:
    """The record of one dispatched op, or None for an op that moves no
    tensor (``prim.device``, a view that returns none...)."""
    ns = func.namespace
    if ns == "prim":                      # prim.device, prim.layout...
        return None
    name = func._overloadpacket.__name__
    ins = _tensors(args) + _tensors(kwargs)
    outs = _tensors(out)
    rec: Dict[str, Any] = {"op": f"{ns}.{name}",
                           "in": [_desc(t) for t in ins],
                           "out": [_desc(t) for t in outs]}
    if ns == KERNEL_NS:
        rec["kind"] = "kernel"
        rec["args"] = _jsonable(list(args))
        return rec
    if ns in _COLLECTIVE_NS:
        if name not in _COLLECTIVES:
            return None if not ins else {**rec, "kind": "view"}
        rec["kind"] = "collective"
        rec["coll"] = _COLLECTIVES[name]
        rec["g"] = _group_size(args, kwargs)
        return rec
    if not ins and not outs:
        return None
    if name in _VIEWS:
        rec["kind"] = "view"
    elif name in _WRITES:
        rec["kind"] = "write"
        self_t = ins[0]
        if name == "copy_":
            w = self_t.numel()
        elif name in ("index_put_", "_index_put_impl_"):
            w = _written_index_put(self_t, args[1])
        else:
            w = ins[-1].numel()
        rec["w"] = w * self_t.element_size()
    elif name in _SCATTERS:
        rec["kind"] = "scatter"
        self_t = ins[0]
        w = (_written_index_put(self_t, args[1]) if name == "index_put"
             else ins[-1].numel())
        rec["w"] = w * self_t.element_size()
    elif name in _GATHERS:
        rec["kind"] = "gather"
    elif name in _FILLS:
        rec["kind"] = "fill"
    elif name in _COPIES:
        rec["kind"] = "other"
    elif name in _DOTS:
        rec["kind"] = "dot"
        rec["k"] = int(ins[-2].shape[-1]) if len(ins) >= 2 else 1
    elif torch.Tag.pointwise in func.tags:
        rec["kind"] = "pointwise"
    elif name in _REDUCTIONS:
        rec["kind"] = "reduction"
    else:
        rec["kind"] = "other"
    return rec


def record_cost(rec: Dict[str, Any], n_devices: int = 1,
                kernels: Optional[Dict[str, Any]] = None) -> Cost:
    """The cost of one record, by the rules in the module docstring."""
    c = Cost()
    kind = rec["kind"]
    if kind == "view":
        return c
    ib = sum(_nbytes(d) for d in rec["in"])
    ob = sum(_nbytes(d) for d in rec["out"])
    if kind == "kernel":
        costs = kernels if kernels is not None else _kernel_costs()
        fn = costs[rec["op"].split(".", 1)[1]]
        flops, nbytes = fn(*_from_json(rec["args"]))
        c.flops, c.bytes = float(flops), float(nbytes)
        return c
    if kind == "collective":
        op = rec["coll"]
        g = rec.get("g") or n_devices
        b = ib
        if op == "all-reduce":
            wire = 2.0 * b * (g - 1) / max(g, 1)
        elif op in ("all-gather", "reduce-scatter"):
            wire = 1.0 * max(b, ob) * (g - 1) / max(g, 1)
        elif op == "all-to-all":
            wire = b * (g - 1) / max(g, 1)
        else:                                   # broadcast
            wire = float(b)
        c.collective_bytes[op] = wire
        c.collective_counts[op] = 1
        c.bytes = float(ib + ob)
        return c
    if kind in ("write", "scatter"):
        c.bytes = 2.0 * rec["w"]
        return c
    if kind == "gather":
        c.bytes = 2.0 * ob
        return c
    if kind == "fill":
        c.bytes = float(ob)
        return c
    out_elems = sum(_numel(d[0]) for d in rec["out"])
    if kind == "dot":
        c.flops = 2.0 * out_elems * rec["k"]
    elif kind == "pointwise":
        c.flops = float(out_elems)
    elif kind == "reduction":
        c.flops = float(out_elems + (_numel(rec["in"][0][0])
                                     if rec["in"] else 0))
    c.bytes = float(ib + ob)
    return c


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


class OpCounter(TorchDispatchMode):
    """Count the cost of every op dispatched inside the ``with`` block
    (see the module docstring).  ``add_inputs(*trees)`` first registers
    the step's inputs as live (their storages are the argument bytes);
    ``finish(outputs)`` after the step gives :meth:`memory`.  Works on
    real tensors (the card) and under ``FakeTensorMode`` (enter the fake
    mode first, so the counter sees each op before it is faked).
    ``trace=True`` keeps :attr:`records`."""

    def __init__(self, *, trace: bool = False, n_devices: int = 1):
        super().__init__()
        self.cost = Cost()
        self.records: Optional[List[Dict[str, Any]]] = [] if trace else None
        self.n_devices = n_devices
        self.ops = 0
        self._kernels = _kernel_costs()
        self._sizes: Dict[int, int] = {}       # live storage id -> bytes
        self._args: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0

    # -- live bytes -----------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        """Register ``t``'s storage if it is new; returns its new bytes."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return 0
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)
        return n

    def add_inputs(self, *trees: Any) -> None:
        for t in _tensors(list(trees)):
            key = id(t.untyped_storage())
            n = self._track(t)
            if n:
                self._args[key] = n
                self.argument_bytes += n
        self.peak = max(self.peak, self.live)

    def finish(self, outputs: Any) -> None:
        seen = set()
        for t in _tensors(outputs):
            key = id(t.untyped_storage())
            if key in seen:
                continue
            seen.add(key)
            if key in self._args:
                self.alias_bytes += self._args[key]
            elif key in self._sizes:
                self.output_bytes += self._sizes[key]

    def memory(self) -> Dict[str, int]:
        """The reference's ``memory`` keys: ``peak_bytes_per_device`` is
        the most bytes live at once; ``temp_bytes`` what the peak held
        beyond the arguments and the new outputs."""
        return {"argument_bytes": int(self.argument_bytes),
                "output_bytes": int(self.output_bytes),
                "temp_bytes": int(max(0, self.peak - self.argument_bytes
                                      - self.output_bytes)),
                "alias_bytes": int(self.alias_bytes),
                "peak_bytes_per_device": int(self.peak)}

    # -- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = op_record(func, args, kwargs, out)
        if rec is not None:
            self.ops += 1
            self.cost.add(record_cost(rec, self.n_devices, self._kernels))
            if self.records is not None:
                self.records.append(rec)
        for t in _tensors(out):
            self._track(t)
        self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# Saved traces
# ---------------------------------------------------------------------------


def save_trace(records: List[Dict[str, Any]], path: str) -> None:
    """One JSON line per record."""
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")


def load_trace(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def analyze(trace: Union[str, List[Dict[str, Any]]],
            n_devices: int = 1) -> Dict:
    """Re-cost a saved trace (a path or the records): the reference's
    ``analyze`` keys, per device.  ``n_devices`` is the group size of a
    collective whose record names none."""
    records = load_trace(trace) if isinstance(trace, str) else trace
    total = Cost()
    kernels = _kernel_costs()
    for r in records:
        total.add(record_cost(r, n_devices, kernels))
    return total.to_json()
