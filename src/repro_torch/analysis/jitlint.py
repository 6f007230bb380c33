"""jitlint: traced functions stay pure.

``torch.compile`` traces a function once per guard set (input shapes,
dtypes, the Python values it reads) and replays the compiled graph
thereafter.  Side effects inside the traced region therefore run at
trace time only, or break the graph — a ``time.time()`` reads the clock
once, a lock acquisition protects only the first call, a ``self.x = ...``
mutation stops happening or recompiles.  This pass walks every function
that ``torch.compile`` traces (decorator, explicit ``torch.compile(f)``
call, inline lambda, or factory pattern) plus everything reachable from
one through the call graph, and flags:

* ``time.*`` calls (stale-clock values baked into the trace);
* Python-level RNG (``np.random.*``, ``random.*`` — traced once, the
  "random" stream is a constant; use torch's random ops with an explicit
  ``torch.Generator``);
* lock acquisition (``with <lock>`` / ``.acquire()`` — protects only the
  trace, then silently stops synchronizing);
* Python-state mutation: attribute assignment, subscript assignment into
  an attribute-held container, ``global`` / ``nonlocal`` declarations.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.core import (Finding, FuncInfo, Index,
                                       compile_reachable, compile_roots,
                                       lock_name_of, walk_in_func)

PASS_ID = "jitlint"

_RNG_MODULES = {"random"}


def _dotted_root(expr: ast.AST) -> List[str]:
    """['np', 'random', 'randint'] for ``np.random.randint``."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return parts[::-1]


def run(index: Index) -> List[Finding]:
    reach: Dict[FuncInfo, str] = compile_reachable(index,
                                                   compile_roots(index))
    findings: List[Finding] = []
    for fi, how in reach.items():
        path = fi.module.path
        ctx = f"`{fi.qualname}` is traced ({how})"
        for node in walk_in_func(fi.node):
            if isinstance(node, ast.Call):
                parts = _dotted_root(node.func)
                if len(parts) >= 2 and parts[0] == "time":
                    findings.append(Finding(
                        path, node.lineno, PASS_ID,
                        f"`{'.'.join(parts)}()` inside a compiled function "
                        f"— the clock is read once at trace time; {ctx}"))
                elif len(parts) >= 2 and (
                        parts[0] in _RNG_MODULES
                        or (parts[0] in ("np", "numpy")
                            and len(parts) >= 3 and parts[1] == "random")):
                    findings.append(Finding(
                        path, node.lineno, PASS_ID,
                        f"Python RNG `{'.'.join(parts)}()` inside a compiled "
                        f"function — traced once, the stream is constant; "
                        f"use torch's random ops with a torch.Generator; "
                        f"{ctx}"))
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "acquire" \
                        and lock_name_of(node.func.value) is not None:
                    findings.append(Finding(
                        path, node.lineno, PASS_ID,
                        f"lock `.acquire()` inside a compiled function — "
                        f"synchronizes the trace only; {ctx}"))
            elif isinstance(node, ast.With):
                for item in node.items:
                    if lock_name_of(item.context_expr) is not None:
                        findings.append(Finding(
                            path, item.context_expr.lineno, PASS_ID,
                            f"lock held inside a compiled function — "
                            f"synchronizes the trace only; {ctx}"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        findings.append(Finding(
                            path, node.lineno, PASS_ID,
                            f"attribute assignment "
                            f"`{_safe_unparse(t)} = ...` inside a compiled "
                            f"function — Python-state mutation happens at "
                            f"trace time only; {ctx}"))
                    elif isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Attribute):
                        findings.append(Finding(
                            path, node.lineno, PASS_ID,
                            f"subscript store into attribute "
                            f"`{_safe_unparse(t)}` inside a compiled "
                            f"function — mutation happens at trace time "
                            f"only; {ctx}"))
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                findings.append(Finding(
                    path, node.lineno, PASS_ID,
                    f"`{'global' if isinstance(node, ast.Global) else 'nonlocal'}"
                    f" {', '.join(node.names)}` inside a compiled "
                    f"function; {ctx}"))
    return findings


def _safe_unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover
        return "<expr>"
