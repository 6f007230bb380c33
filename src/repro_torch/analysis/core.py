"""leolint core: module index, call graph, waiver pragmas, findings.

``leolint`` is a repo-specific static checker (stdlib ``ast`` only — no
third-party deps, so it runs anywhere CI does) for the tiered serving
engine's concurrency and billing contracts, here for the PyTorch
engine.  This module holds the shared machinery; the four passes
(:mod:`locklint`, :mod:`threadlint`, :mod:`billlint`, :mod:`jitlint`)
are thin rule sets over it:

* **Module index** — every analyzed file parsed once; every function
  (methods, nested defs, lambdas) registered as a :class:`FuncInfo` with
  its ownership decoration, enclosing class, and per-module import map.
* **Call resolution** — name-based, deliberately over-approximate where
  types are unknown: ``self.x(...)`` resolves within the enclosing class,
  ``alias.f(...)`` through the import map, bare names lexically then at
  module scope, and ``anything.m(...)`` to every analyzed class method
  named ``m`` (capped — a miss is an under-approximation, which a linter
  with waivers prefers over false certainty).
* **Waivers** — findings are suppressible ONLY via an inline pragma::

      # leolint: waive[pass1,pass2] reason=why this is safe

  attached to the flagged line, the comment line directly above it, or
  the enclosing ``def`` line (function-scoped waiver).  A waive without a
  ``reason=`` is itself reported: every exception stays auditable.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PASS_IDS = ("locklint", "threadlint", "billlint", "jitlint")

OWNERSHIP_DECORATORS = ("decode_thread_only", "worker_thread", "any_thread")
DECODE_ONLY_NAME = "decode_thread_only"

#: attribute (or bare-name) identifiers treated as locks by lock rules
LOCK_NAME_RE = re.compile(r"^_(?:[a-z0-9_]*_)?lock$")

WAIVE_RE = re.compile(
    r"#\s*leolint:\s*waive\[([a-zA-Z0-9_,\s*]+)\]\s*(?:reason\s*=\s*(.*\S))?")


@dataclass
class Finding:
    path: str
    line: int
    pass_id: str
    message: str
    waived: bool = False
    reason: str = ""

    def render(self) -> str:
        tag = f" (waived: {self.reason})" if self.waived else ""
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}{tag}"


@dataclass
class FuncInfo:
    module: "Module"
    node: ast.AST                    # FunctionDef / AsyncFunctionDef / Lambda
    name: str
    qualname: str
    cls: Optional[str]
    ownership: Optional[str]
    line: int
    parent: Optional["FuncInfo"] = None
    locals_: Dict[str, "FuncInfo"] = field(default_factory=dict)

    def __hash__(self):
        return id(self.node)

    def __eq__(self, other):
        return isinstance(other, FuncInfo) and other.node is self.node

    def __repr__(self):
        return f"<{self.module.name}:{self.qualname}>"


class Module:
    """One parsed source file plus its waiver table and import map."""

    def __init__(self, path: str, source: str, name: Optional[str] = None):
        self.path = path
        self.name = name or _module_name(path)
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        # line -> {pass_id -> reason}; pass id "*" waives every pass
        self.waivers: Dict[int, Dict[str, str]] = {}
        self.malformed: List[Tuple[int, str]] = []
        # alias -> dotted module name (import x as y / from pkg import mod)
        self.mod_aliases: Dict[str, str] = {}
        # name -> (module dotted name, attr) for `from pkg import fn`
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self._parse_waivers()
        self._parse_imports()

    def _parse_waivers(self) -> None:
        # only genuine COMMENT tokens count — pragma-looking text inside
        # docstrings / string literals (e.g. this checker's own docs) is
        # neither a waiver nor malformed
        src = "\n".join(self.lines) + "\n"
        try:
            tokens = tokenize.generate_tokens(io.StringIO(src).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except tokenize.TokenError:  # pragma: no cover - ast.parse ran
            comments = []
        for i, text in comments:
            m = WAIVE_RE.search(text)
            if not m:
                if "leolint" in text and "waive" in text:
                    self.malformed.append((i, text.strip()))
                continue
            passes = [p.strip() for p in m.group(1).split(",") if p.strip()]
            reason = (m.group(2) or "").strip()
            if not reason or not passes:
                self.malformed.append((i, text.strip()))
                continue
            slot = self.waivers.setdefault(i, {})
            for p in passes:
                slot[p] = reason

    def _parse_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod_aliases[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (node.module,
                                                             a.name)

    def waiver_for(self, line: int, pass_id: str,
                   def_line: Optional[int] = None) -> Optional[str]:
        """Reason string if ``line`` (or its pragma-carrying neighbors /
        enclosing def) waives ``pass_id``; None otherwise."""
        for cand in self._waiver_lines(line, def_line):
            slot = self.waivers.get(cand)
            if slot:
                r = slot.get(pass_id) or slot.get("*")
                if r:
                    return r
        return None

    def _waiver_lines(self, line: int, def_line: Optional[int]
                      ) -> Iterable[int]:
        yield line
        # a standalone comment line directly above the statement
        j = line - 1
        while j >= 1 and j > line - 4 \
                and self.lines[j - 1].lstrip().startswith("#"):
            yield j
            j -= 1
        if def_line is not None and def_line != line:
            yield def_line


def _module_name(path: str) -> str:
    """Dotted module name from a path (rooted at a ``src`` dir when one is
    on the path, else the bare stem — fixtures)."""
    norm = os.path.normpath(os.path.abspath(path))
    parts = norm.split(os.sep)
    stem = [p for p in parts if p]
    if "src" in stem:
        stem = stem[stem.index("src") + 1:]
    else:
        stem = stem[-1:]
    if stem and stem[-1].endswith(".py"):
        stem[-1] = stem[-1][:-3]
    if stem and stem[-1] == "__init__":
        stem = stem[:-1]
    return ".".join(stem)


def _decorator_name(dec: ast.AST) -> Optional[str]:
    if isinstance(dec, ast.Name):
        return dec.id
    if isinstance(dec, ast.Attribute):
        return dec.attr
    if isinstance(dec, ast.Call):
        return _decorator_name(dec.func)
    return None


class Index:
    """Cross-module function index + call graph resolution."""

    #: cap for untyped ``obj.m(...)`` fan-out — beyond it the name is too
    #: generic to mean anything and edges would be noise
    METHOD_MATCH_CAP = 4

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)
        self.by_module: Dict[str, Module] = {m.name: m for m in modules}
        self.functions: List[FuncInfo] = []
        # simple name -> FuncInfos (methods and module-level separately)
        self.methods: Dict[str, List[FuncInfo]] = {}
        self.mod_level: Dict[Tuple[str, str], FuncInfo] = {}
        self.cls_methods: Dict[Tuple[str, str, str], FuncInfo] = {}
        for m in modules:
            self._index_module(m)

    # -- construction ---------------------------------------------------
    def _index_module(self, mod: Module) -> None:
        def visit(node, cls: Optional[str], parent: Optional[FuncInfo],
                  prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    own = None
                    for dec in child.decorator_list:
                        d = _decorator_name(dec)
                        if d in OWNERSHIP_DECORATORS:
                            own = d
                    qn = f"{prefix}{child.name}"
                    fi = FuncInfo(mod, child, child.name, qn, cls, own,
                                  child.lineno, parent)
                    self._register(fi)
                    if parent is not None:
                        parent.locals_[child.name] = fi
                    visit(child, cls, fi, qn + ".<locals>.")
                elif isinstance(child, ast.ClassDef):
                    visit(child, child.name, None, child.name + ".")
                elif isinstance(child, ast.Lambda):
                    self._index_lambda(child, mod, cls, parent, prefix)
                else:
                    # lambdas nested in arbitrary statements (compile
                    # roots)
                    for sub in ast.walk(child):
                        if isinstance(sub, ast.Lambda):
                            self._index_lambda(sub, mod, cls, parent, prefix)

        visit(mod.tree, None, None, "")

    def _index_lambda(self, node: ast.Lambda, mod: Module,
                      cls: Optional[str], parent: Optional[FuncInfo],
                      prefix: str) -> None:
        fi = FuncInfo(mod, node, "<lambda>",
                      f"{prefix}<lambda@{node.lineno}>", cls, None,
                      node.lineno, parent)
        self._register(fi)

    def _register(self, fi: FuncInfo) -> None:
        self.functions.append(fi)
        if fi.cls is not None:
            self.methods.setdefault(fi.name, []).append(fi)
            self.cls_methods[(fi.module.name, fi.cls, fi.name)] = fi
        elif fi.parent is None and fi.name != "<lambda>":
            self.mod_level[(fi.module.name, fi.name)] = fi

    def func_of(self, node: ast.AST) -> Optional[FuncInfo]:
        for fi in self.functions:
            if fi.node is node:
                return fi
        return None

    # -- resolution -----------------------------------------------------
    def resolve(self, expr: ast.AST, ctx: FuncInfo) -> List[FuncInfo]:
        """Possible targets of calling ``expr`` from inside ``ctx``."""
        if isinstance(expr, ast.Name):
            return self._resolve_name(expr.id, ctx)
        if isinstance(expr, ast.Attribute):
            return self._resolve_attr(expr, ctx)
        if isinstance(expr, ast.Lambda):
            fi = self.func_of(expr)
            return [fi] if fi else []
        return []

    def _resolve_name(self, name: str, ctx: FuncInfo) -> List[FuncInfo]:
        scope = ctx
        while scope is not None:               # lexical nested defs
            if name in scope.locals_:
                return [scope.locals_[name]]
            scope = scope.parent
        fi = self.mod_level.get((ctx.module.name, name))
        if fi is not None:
            return [fi]
        imp = ctx.module.from_imports.get(name)
        if imp is not None:
            tgt = self.mod_level.get(imp)
            if tgt is not None:
                return [tgt]
        return []

    def _resolve_attr(self, expr: ast.Attribute, ctx: FuncInfo
                      ) -> List[FuncInfo]:
        attr, value = expr.attr, expr.value
        if isinstance(value, ast.Name):
            if value.id in ("self", "cls") and ctx.cls is not None:
                fi = self.cls_methods.get((ctx.module.name, ctx.cls, attr))
                if fi is not None:
                    return [fi]
            # module alias: exact resolution through the import map
            dotted = ctx.module.mod_aliases.get(value.id)
            if dotted is None:
                imp = ctx.module.from_imports.get(value.id)
                if imp is not None:
                    dotted = f"{imp[0]}.{imp[1]}"
            if dotted is not None:
                fi = self.mod_level.get((dotted, attr))
                return [fi] if fi is not None else []
        # untyped receiver: every analyzed class method with this name
        cands = self.methods.get(attr, [])
        if 0 < len(cands) <= self.METHOD_MATCH_CAP:
            return list(cands)
        return []

    # -- traversal helpers ----------------------------------------------
    def calls_in(self, fi: FuncInfo) -> List[Tuple[ast.Call,
                                                   List[FuncInfo]]]:
        """All Call nodes lexically inside ``fi`` (excluding nested defs),
        with their resolved targets (possibly empty)."""
        out = []
        for node in walk_in_func(fi.node):
            if isinstance(node, ast.Call):
                out.append((node, self.resolve(node.func, fi)))
        return out


def walk_in_func(fn_node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk over a function body, NOT descending into nested function
    definitions or lambdas (they are separate FuncInfos)."""
    body = fn_node.body if not isinstance(fn_node, ast.Lambda) \
        else [fn_node.body]
    stack = list(body) if isinstance(body, list) else [body]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def lock_name_of(expr: ast.AST) -> Optional[str]:
    """Lock identifier of a ``with`` context expr (or ``None``): matches
    ``self._lock`` / ``obj._futs_lock`` attribute locks and bare
    ``_x_lock`` module-level names.  Attribute locks are scoped by the
    receiver when it is a plain name so distinct classes' ``_lock``\\ s do
    not alias in the order graph."""
    if isinstance(expr, ast.Attribute) and LOCK_NAME_RE.match(expr.attr):
        return expr.attr
    if isinstance(expr, ast.Name) and LOCK_NAME_RE.match(expr.id):
        return expr.id
    return None


def scoped_lock_name(expr: ast.AST, ctx: FuncInfo) -> Optional[str]:
    base = lock_name_of(expr)
    if base is None:
        return None
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and ctx.cls is not None:
        return f"{ctx.cls}.{base}"
    if isinstance(expr, ast.Name):
        return f"{ctx.module.name}.{base}"
    return base


# ----------------------------------------------------------------------
# Compile root detection (shared by jitlint and locklint's dispatch rule)
# ----------------------------------------------------------------------
def _is_torch_compile(expr: ast.AST, mod: Module) -> bool:
    """True for ``torch.compile`` (through the module's import map: ``import
    torch as th`` / ``from torch import compile``), for ``torch.compile(
    mode=...)`` with no function argument (a decorator factory) and for
    ``functools.partial(torch.compile, ...)`` wrappers."""
    if isinstance(expr, ast.Attribute) and expr.attr == "compile" \
            and isinstance(expr.value, ast.Name):
        return mod.mod_aliases.get(expr.value.id) == "torch"
    if isinstance(expr, ast.Name):
        return mod.from_imports.get(expr.id) == ("torch", "compile")
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Attribute) and fn.attr == "partial" \
                or isinstance(fn, ast.Name) and fn.id == "partial":
            return any(_is_torch_compile(a, mod) for a in expr.args)
        return not expr.args and _is_torch_compile(fn, mod)
    return False


def compile_roots(index: Index) -> Dict[FuncInfo, str]:
    """Every function that ``torch.compile`` traces: decorated with it (or
    with ``torch.compile(mode=...)`` / a ``functools.partial`` of it),
    passed to a ``torch.compile(...)`` call (names, attributes, inline
    lambdas), or — for the factory pattern ``torch.compile(make_step(...))``
    — every nested def of the factory.  Returns {func: how it became a
    root} for messages."""
    roots: Dict[FuncInfo, str] = {}
    for fi in index.functions:
        node = fi.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_torch_compile(dec, fi.module):
                    roots.setdefault(fi, "decorated with torch.compile")

    def from_call(call: ast.Call, ctx: FuncInfo, where: str) -> None:
        if not (_is_torch_compile(call.func, ctx.module) and call.args):
            return
        arg = call.args[0]
        for tgt in index.resolve(arg, ctx):
            roots.setdefault(tgt, f"passed to torch.compile {where}")
        if isinstance(arg, ast.Call):     # torch.compile(factory(...))
            for fac in index.resolve(arg.func, ctx):
                for nested in fac.locals_.values():
                    roots.setdefault(
                        nested, f"returned by factory {fac.qualname} "
                                f"passed to torch.compile")

    for fi in index.functions:
        for call, _tgts in index.calls_in(fi):
            from_call(call, fi, f"in {fi.qualname}")
    # module-level compile calls: `step_fn = torch.compile(...)` outside
    # any def
    for m in index.modules:
        ctx = FuncInfo(m, m.tree, "<module>", "<module>", None, None, 1,
                       None)
        for node in walk_in_func(m.tree):
            if isinstance(node, ast.Call):
                from_call(node, ctx, f"at module level of {m.name}")
    return roots


def compile_reachable(index: Index, roots: Dict[FuncInfo, str]
                      ) -> Dict[FuncInfo, str]:
    """Transitive closure of the compile roots over the call graph: a
    callee of a compiled function is traced inside it."""
    out = dict(roots)
    work = list(roots)
    while work:
        fi = work.pop()
        for _call, tgts in index.calls_in(fi):
            for t in tgts:
                if t not in out:
                    out[t] = f"called from compiled {fi.qualname}"
                    work.append(t)
    return out


# ----------------------------------------------------------------------
# File collection / running the passes
# ----------------------------------------------------------------------
def collect_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
        elif p.endswith(".py"):
            files.append(p)
    return files


def load_modules(paths: Sequence[str]) -> List[Module]:
    mods = []
    for f in collect_files(paths):
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        mods.append(Module(f, src))
    return mods


def apply_waivers(findings: List[Finding], index: Index,
                  def_lines: Optional[Dict[Tuple[str, int], int]] = None
                  ) -> List[Finding]:
    """Mark findings waived where a matching pragma covers them."""
    by_path = {m.path: m for m in index.modules}
    for f in findings:
        mod = by_path.get(f.path)
        if mod is None:
            continue
        dl = (def_lines or {}).get((f.path, f.line))
        reason = mod.waiver_for(f.line, f.pass_id, dl)
        if reason:
            f.waived, f.reason = True, reason
    return findings


def enclosing_def_lines(index: Index) -> Dict[Tuple[str, int], int]:
    """(path, line) -> def line of the innermost enclosing function, for
    function-scoped waivers."""
    out: Dict[Tuple[str, int], int] = {}
    for fi in index.functions:
        node = fi.node
        end = getattr(node, "end_lineno", None) or node.lineno
        for line in range(node.lineno, end + 1):
            key = (fi.module.path, line)
            # innermost wins: later (nested) functions overwrite only if
            # they start later
            prev = out.get(key)
            if prev is None or node.lineno >= prev:
                out[key] = node.lineno
    return out


def run_passes(paths: Sequence[str],
               passes: Optional[Sequence[str]] = None
               ) -> Tuple[List[Finding], Index]:
    """Load ``paths``, run the requested passes (default: all four), apply
    waivers, and append malformed-waiver findings.  Returns (findings,
    index)."""
    from repro_torch.analysis import billlint, jitlint, locklint, threadlint
    table = {"locklint": locklint.run, "threadlint": threadlint.run,
             "billlint": billlint.run, "jitlint": jitlint.run}
    mods = load_modules(paths)
    index = Index(mods)
    findings: List[Finding] = []
    for pid in (passes or PASS_IDS):
        findings.extend(table[pid](index))
    findings = apply_waivers(findings, index, enclosing_def_lines(index))
    for mod in mods:
        for line, text in mod.malformed:
            findings.append(Finding(
                mod.path, line, "waiver",
                f"malformed waiver pragma (need "
                f"`# leolint: waive[pass] reason=...` with a non-empty "
                f"reason): {text!r}"))
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    return findings, index
