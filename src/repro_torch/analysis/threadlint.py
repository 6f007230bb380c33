"""threadlint: executor work must never reach decode-thread-only code.

The device pool slab (and the engine's slot bookkeeping) are read by the
decode round's attention kernels WITHOUT the store lock; the contract
that makes that safe is "the decode thread is the sole mutator".  This
pass makes the contract structural:

* **Entry points** are every first argument of an ``executor.submit(...)``
  call (``_admit``, the nested prefetch ``work``, ``_ingest_cold``,
  ``_requant_chunks``, the checkpoint writer) plus every function
  decorated ``@worker_thread``.
* From each entry the pass walks the call graph in *worker context*; a
  reachable call into a ``@decode_thread_only`` function is a finding at
  the call site (one example path from the entry is included in the
  message).  ``@any_thread`` and undecorated functions are traversed.
* Functions explicitly decorated ``@decode_thread_only`` are not
  descended into (the first bad edge is the bug; everything below it is
  noise).

Legitimate deferred-fold sites (worker defers a pool mutation through
``pending_place`` for the decode thread to apply) are expected to carry a
``# leolint: waive[threadlint] reason=...`` pragma explaining why the
edge is never taken in worker context.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from repro_torch.analysis.core import (DECODE_ONLY_NAME, Finding, FuncInfo,
                                       Index)

PASS_ID = "threadlint"


def _submit_entries(index: Index) -> List[Tuple[FuncInfo, str]]:
    """(entry function, description) for every ``*.submit(fn, ...)``."""
    out: List[Tuple[FuncInfo, str]] = []
    for fi in index.functions:
        for call, _tgts in index.calls_in(fi):
            if not (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "submit" and call.args):
                continue
            for tgt in index.resolve(call.args[0], fi):
                out.append((tgt, f"submitted to an executor in "
                                 f"{fi.qualname} "
                                 f"({fi.module.name}:{call.lineno})"))
    return out


def run(index: Index) -> List[Finding]:
    entries: List[Tuple[FuncInfo, str]] = _submit_entries(index)
    for fi in index.functions:
        if fi.ownership == "worker_thread":
            entries.append((fi, "decorated @worker_thread"))

    findings: List[Finding] = []
    flagged: Set[Tuple[str, int, FuncInfo]] = set()
    # (visited func) -> already walked in worker context (entry-agnostic:
    # the first entry to reach a function claims it; findings are per call
    # site so coverage is unaffected)
    visited: Set[FuncInfo] = set()

    for entry, how in entries:
        if entry.ownership == DECODE_ONLY_NAME:
            findings.append(Finding(
                entry.module.path, entry.line, PASS_ID,
                f"{entry.qualname} is @decode_thread_only but is used as a "
                f"worker entry point ({how})"))
            continue
        stack: List[Tuple[FuncInfo, str]] = [(entry, entry.qualname)]
        while stack:
            fi, chain = stack.pop()
            if fi in visited:
                continue
            visited.add(fi)
            for call, tgts in index.calls_in(fi):
                for t in tgts:
                    if t.ownership == DECODE_ONLY_NAME:
                        key = (fi.module.path, call.lineno, t)
                        if key in flagged:
                            continue
                        flagged.add(key)
                        findings.append(Finding(
                            fi.module.path, call.lineno, PASS_ID,
                            f"call into decode-thread-only "
                            f"`{t.qualname}` reachable from worker entry "
                            f"`{entry.qualname}` ({how}) via {chain}"))
                    else:
                        stack.append((t, f"{chain} -> {t.qualname}"))
    return findings
