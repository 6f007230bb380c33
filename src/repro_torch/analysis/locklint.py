"""locklint: nothing slow, reentrant, or blocking under the store lock.

The tiered store's ``_lock`` serializes tier-table metadata; the
write-behind design only works because everything held under it is cheap
host work.  Three rule families:

1. **No host-device sync / memmap flush / compiled call under a lock** —
   ``.item()``, ``.tolist()``, ``.cpu()``, ``.synchronize()``
   (``torch.cuda.synchronize``, a stream's or an event's),
   ``.wait_stream()``, ``.wait_event()`` or ``.flush()`` holds the lock
   until the card (or the disk) has caught up with everything queued
   before it, stalling every worker that needs to land a write; so does
   a call into a ``torch.compile``'d function.  An eager torch op under a
   lock only enqueues work on the stream and is not a finding.
2. **No fence (or future wait) reachable under the store lock** —
   ``ingest_fence*`` waits on executor futures whose work items need the
   store lock to land writes: fence-under-lock is a deadlock, not a
   slowdown.  ``.result()`` on a future is flagged for the same reason.
3. **Lock-order acyclicity** — every nested ``with <lock>`` acquisition
   (including locks a callee acquires while the caller holds one) records
   an edge; a cycle anywhere in the graph (e.g. ``_lock`` →
   ``_futs_lock`` at one site and the reverse at another) is an ABBA
   deadlock, reported at the edge that closes the cycle.

Findings anchor where the lock is held: a direct violation at its own
line, and a call under a lock into a *lock-sensitive* callee (one that
transitively syncs / fences / waits / calls a compiled function) at the **call
site** — the function that owns the lock context carries the waiver, not
the innocent leaf (``compression.quantize`` is fine on the prefetch
executor; it is ``fetch_chunks_pooled`` that chooses to call it under
``_lock``)."""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, FuncInfo, Index,
                                       compile_reachable, compile_roots,
                                       scoped_lock_name, walk_in_func)

PASS_ID = "locklint"

#: attribute calls that wait for the device (a copy to the host, a stream,
#: event or device synchronization, a cross-stream wait) or the disk
_SYNC_ATTRS = {"item", "tolist", "cpu", "synchronize", "wait_stream",
               "wait_event", "flush"}
#: attribute calls that wait on executor futures
_WAIT_ATTRS = {"result"}


def _call_label(call: ast.Call) -> str:
    try:
        return ast.unparse(call.func)
    except Exception:  # pragma: no cover - unparse is total on py>=3.9
        return "<call>"


def _is_fence_name(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Attribute):
        return expr.attr.startswith("ingest_fence")
    if isinstance(expr, ast.Name):
        return expr.id.startswith("ingest_fence")
    return False


def _walk_expr(node: ast.AST) -> Iterable[ast.AST]:
    """Walk an expression tree without entering lambda bodies (those are
    separate functions and execute at call time, not here)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Lambda):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _local_op(call: ast.Call, compiled: Dict[FuncInfo, str],
              tgts: List[FuncInfo]) -> Optional[str]:
    """Short description if this call is itself slow/blocking, else None."""
    label = _call_label(call)
    if isinstance(call.func, ast.Attribute):
        if call.func.attr in _SYNC_ATTRS:
            return f"blocks on device/disk (`.{call.func.attr}()`)"
        if call.func.attr in _WAIT_ATTRS and not call.args:
            return "waits on a future (`.result()`)"
    if _is_fence_name(call.func):
        return f"waits on ingest workers (`{label}()`)"
    for t in tgts:
        if t in compiled:
            return f"calls compiled `{t.qualname}`"
    return None


class _Analysis:
    """Per-index lock analysis state (sensitivity + acquired-locks
    fixpoints are memoized across the whole run)."""

    def __init__(self, index: Index):
        self.index = index
        self.compiled = compile_reachable(index, compile_roots(index))
        self._sens: Dict[FuncInfo, Optional[str]] = {}
        self._acq: Dict[FuncInfo, Set[str]] = {}

    # -- transitive "dangerous to call under a lock" ---------------------
    def sensitivity(self, fi: FuncInfo) -> Optional[str]:
        """Description of the first slow/blocking op reachable from
        ``fi`` (ignoring lock context — the caller supplies that), or
        None if the whole call tree is cheap host work."""
        if fi in self._sens:
            return self._sens[fi]
        self._sens[fi] = None          # cycle guard: assume clean
        if fi in self.compiled:
            self._sens[fi] = f"is compiled ({self.compiled[fi]})"
            return self._sens[fi]
        for call, tgts in self.index.calls_in(fi):
            op = _local_op(call, self.compiled, tgts)
            if op is not None:
                self._sens[fi] = (f"{op} at "
                                  f"{fi.module.name}:{call.lineno}")
                return self._sens[fi]
        for call, tgts in self.index.calls_in(fi):
            for t in tgts:
                sub = self.sensitivity(t)
                if sub is not None:
                    self._sens[fi] = f"via {t.qualname}: {sub}"
                    return self._sens[fi]
        return self._sens[fi]

    # -- transitive acquired-lock set ------------------------------------
    def acquired(self, fi: FuncInfo) -> Set[str]:
        if fi in self._acq:
            return self._acq[fi]
        self._acq[fi] = set()          # cycle guard
        out: Set[str] = set()
        for node in walk_in_func(fi.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    ln = scoped_lock_name(item.context_expr, fi)
                    if ln is not None:
                        out.add(ln)
        for _call, tgts in self.index.calls_in(fi):
            for t in tgts:
                out |= self.acquired(t)
        self._acq[fi] = out
        return out


def _scan_function(ana: _Analysis, fi: FuncInfo,
                   findings: List[Finding],
                   edge_sites: List[Tuple[str, str, str, int]]) -> None:
    index, compiled = ana.index, ana.compiled

    def check_call(call: ast.Call, locks: Tuple[str, ...]) -> None:
        if not locks:
            return
        held = locks[-1]
        tgts = index.resolve(call.func, fi)
        op = _local_op(call, compiled, tgts)
        if op is not None:
            findings.append(Finding(
                fi.module.path, call.lineno, PASS_ID,
                f"{op} under lock '{held}' — "
                f"{'deadlock: the waited-on work needs this lock' if op.startswith('waits') else 'stalls every worker that needs the lock'}"))
            return
        for t in tgts:
            sub = ana.sensitivity(t)
            if sub is not None:
                findings.append(Finding(
                    fi.module.path, call.lineno, PASS_ID,
                    f"call to `{t.qualname}` under lock '{held}' — "
                    f"callee {sub}"))
                break
        for t in tgts:
            for ln in ana.acquired(t):
                if ln != held:
                    edge_sites.append((held, ln, fi.module.path,
                                       call.lineno))

    def scan_exprs_of(st: ast.stmt, locks: Tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(st):
            if isinstance(child, (ast.stmt, ast.excepthandler)):
                continue
            for node in _walk_expr(child):
                if isinstance(node, ast.Call):
                    check_call(node, locks)

    def scan_stmts(stmts, locks: Tuple[str, ...]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested defs scanned as their own functions
            if isinstance(st, ast.With):
                inner = locks
                for item in st.items:
                    for node in _walk_expr(item.context_expr):
                        if isinstance(node, ast.Call):
                            check_call(node, locks)
                    ln = scoped_lock_name(item.context_expr, fi)
                    if ln is not None:
                        if inner:
                            edge_sites.append((inner[-1], ln,
                                               fi.module.path,
                                               item.context_expr.lineno))
                        inner = inner + (ln,)
                scan_stmts(st.body, inner)
                continue
            scan_exprs_of(st, locks)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list):
                    scan_stmts([s for s in sub if isinstance(s, ast.stmt)],
                               locks)
            for h in getattr(st, "handlers", None) or []:
                scan_stmts(h.body, locks)

    body = fi.node.body if not isinstance(fi.node, ast.Lambda) \
        else [ast.Expr(fi.node.body)]
    scan_stmts(body, ())


def run(index: Index) -> List[Finding]:
    ana = _Analysis(index)
    findings: List[Finding] = []
    edge_sites: List[Tuple[str, str, str, int]] = []
    for fi in index.functions:
        _scan_function(ana, fi, findings, edge_sites)

    edges: Dict[str, Set[str]] = {}
    for a, b, _p, _line in edge_sites:
        edges.setdefault(a, set()).add(b)

    def path(src: str, dst: str) -> bool:
        stk, vis = [src], set()
        while stk:
            n = stk.pop()
            if n == dst:
                return True
            if n in vis:
                continue
            vis.add(n)
            stk.extend(edges.get(n, ()))
        return False

    reported: Set[Tuple[str, str]] = set()
    for a, b, p, line in edge_sites:
        if a == b:
            continue
        if path(b, a) and (a, b) not in reported and (b, a) not in reported:
            reported.add((a, b))
            findings.append(Finding(
                p, line, PASS_ID,
                f"lock-order cycle: '{a}' -> '{b}' here, but a "
                f"'{b}' -> … -> '{a}' acquisition exists elsewhere — "
                f"ABBA deadlock"))
    return findings
