"""Statically-built cross-module lock-acquisition graph with cycle
(potential-deadlock) reporting.

Nodes are *definitively defined* locks — ``self._x = threading.Lock()``
inside ``class C`` in module ``m`` becomes node ``m.C._x``; module-level
``_g = threading.Lock()`` becomes ``m._g``. (Name-heuristic "lockish"
expressions are excluded: a fuzzy node would alias unrelated locks
across files and fabricate cycles.)

Edges: ``A -> B`` when some function acquires B (``with b:``) while
lexically holding A, **or** calls — possibly across modules, resolved
through imports — a function whose transitive acquire-set contains B.
Call resolution covers ``self.m()``, same-module ``f()``, and
``mod.f()`` / ``from mod import f`` call sites; attribute calls on
arbitrary objects are out of scope (documented limitation).

A strongly-connected component with more than one lock means two code
paths take the same locks in opposite orders — the classic AB/BA
deadlock — and is reported once per component with example edge sites.
The runtime twin of this rule is :mod:`pio_tpu_torch.analysis.runtime`.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from pio_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    ModuleInfo,
    ProjectRule,
    register,
)
from pio_tpu_torch.analysis.locks import (
    CV_FACTORY_NAMES,
    LOCK_FACTORY_NAMES,
    _factory_name,
)


@dataclass
class _FnInfo:
    qual: str
    direct_locks: Set[str] = field(default_factory=set)
    #: (held lock ids at the call, callee key, line)
    calls: List[Tuple[Tuple[str, ...], str, int]] = field(default_factory=list)


@dataclass
class _ModuleLocks:
    class_attrs: Dict[str, Dict[str, str]] = field(default_factory=dict)
    module_names: Dict[str, str] = field(default_factory=dict)


_Edge = Tuple[str, str]                      # (from lock id, to lock id)
_Site = Tuple[str, int]                      # (display path, line)


class _ModuleScanner:
    """One pass over a module: lock defs, per-function acquire/call
    records, and direct nesting edges."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.mod = module.module_name
        self.locks = _ModuleLocks()
        self.fns: Dict[str, _FnInfo] = {}
        self.edges: Dict[_Edge, _Site] = {}
        self.imports: Dict[str, str] = {}    # alias -> module name
        self.from_imports: Dict[str, str] = {}  # bare name -> "mod.name"
        self._collect_defs()

    # -- pass 1: lock definitions + imports --------------------------------
    def _collect_defs(self) -> None:
        factories = LOCK_FACTORY_NAMES | CV_FACTORY_NAMES
        for node in ast.walk(self.module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] = \
                        alias.name if alias.asname else alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"
        for top in self.module.tree.body:
            if isinstance(top, ast.ClassDef):
                for sub in ast.walk(top):
                    self._def_from_assign(sub, top.name)
            else:
                for sub in ast.walk(top):
                    self._def_from_assign(sub, None)

    def _def_from_assign(self, node: ast.AST, cls: Optional[str]) -> None:
        if not isinstance(node, ast.Assign):
            return
        factory = _factory_name(node.value)
        if factory not in LOCK_FACTORY_NAMES | CV_FACTORY_NAMES:
            return
        for t in node.targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self" and cls is not None):
                self.locks.class_attrs.setdefault(cls, {})[t.attr] = \
                    f"{self.mod}.{cls}.{t.attr}"
            elif isinstance(t, ast.Name) and cls is None:
                self.locks.module_names[t.id] = f"{self.mod}.{t.id}"

    # -- pass 2: function bodies -------------------------------------------
    def scan_functions(self) -> None:
        for top in self.module.tree.body:
            if isinstance(top, ast.ClassDef):
                for item in top.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._scan_fn(item, top.name)
            elif isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_fn(top, None)

    def _lock_id(self, expr: ast.expr, cls: Optional[str]) -> Optional[str]:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and cls is not None):
            return self.locks.class_attrs.get(cls, {}).get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.locks.module_names.get(expr.id)
        return None

    def _callee_key(self, call: ast.Call, cls: Optional[str]) -> Optional[str]:
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in self.from_imports:
                return self.from_imports[fn.id]
            return f"{self.mod}.{fn.id}"
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    return f"{self.mod}.{cls}.{fn.attr}"
                target = self.imports.get(base.id)
                if target is not None:
                    return f"{target}.{fn.attr}"
        return None

    def _scan_fn(self, fn, cls: Optional[str]) -> None:
        qual = f"{self.mod}.{cls}.{fn.name}" if cls else f"{self.mod}.{fn.name}"
        info = self.fns.setdefault(qual, _FnInfo(qual))

        def scan_stmts(stmts, held: List[str]) -> None:
            for stmt in stmts:
                scan_stmt(stmt, held)

        def scan_stmt(stmt, held: List[str]) -> None:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return  # nested scopes don't run here
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in stmt.items:
                    walk_expr(item.context_expr, inner)
                    lock = self._lock_id(item.context_expr, cls)
                    if lock is not None:
                        info.direct_locks.add(lock)
                        for h in inner:
                            if h != lock:
                                self.edges.setdefault(
                                    (h, lock),
                                    (self.module.display, stmt.lineno))
                        inner = inner + [lock]
                scan_stmts(stmt.body, inner)
                return
            for _f, value in ast.iter_fields(stmt):
                if isinstance(value, list):
                    if value and isinstance(value[0], ast.stmt):
                        scan_stmts(value, held)
                    else:
                        for v in value:
                            if isinstance(v, ast.expr):
                                walk_expr(v, held)
                            elif isinstance(v, ast.excepthandler):
                                scan_stmts(v.body, held)
                elif isinstance(value, ast.expr):
                    walk_expr(value, held)

        def walk_expr(expr, held: List[str]) -> None:
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    key = self._callee_key(node, cls)
                    if key is not None:
                        info.calls.append((tuple(held), key, node.lineno))

        scan_stmts(fn.body, [])


@register
class LockOrderCycleRule(ProjectRule):
    id = "lock-order-cycle"
    family = "concurrency"
    description = (
        "Two code paths acquire the same locks in opposite orders "
        "(cycle in the static cross-module lock-acquisition graph): a "
        "potential AB/BA deadlock."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> List[Finding]:
        scanners = [_ModuleScanner(m) for m in modules]
        for s in scanners:
            s.scan_functions()

        fns: Dict[str, _FnInfo] = {}
        edges: Dict[_Edge, _Site] = {}
        for s in scanners:
            fns.update(s.fns)
            for e, site in s.edges.items():
                edges.setdefault(e, site)

        # transitive acquire-set fixpoint over resolved calls
        trans: Dict[str, Set[str]] = {
            q: set(i.direct_locks) for q, i in fns.items()
        }
        changed = True
        while changed:
            changed = False
            for q, info in fns.items():
                for _held, callee, _line in info.calls:
                    sub = trans.get(callee)
                    if sub and not sub <= trans[q]:
                        trans[q] |= sub
                        changed = True

        # call-induced edges: held locks order before everything the
        # callee (transitively) acquires
        for s in scanners:
            for info in s.fns.values():
                for held, callee, line in info.calls:
                    for lock in trans.get(callee, ()):
                        for h in held:
                            if h != lock:
                                edges.setdefault(
                                    (h, lock),
                                    (fns_site(s, line)))

        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())

        findings: List[Finding] = []
        for comp in _sccs(graph):
            if len(comp) < 2:
                continue
            comp_sorted = sorted(comp)
            comp_edges = sorted(
                (e, site) for e, site in edges.items()
                if e[0] in comp and e[1] in comp
            )
            detail = "; ".join(
                f"{a} -> {b} at {path}:{line}"
                for (a, b), (path, line) in comp_edges[:4]
            )
            path, line = comp_edges[0][1]
            findings.append(Finding(
                self.id, path, line, 0,
                f"lock-order cycle between {{{', '.join(comp_sorted)}}} "
                f"(potential deadlock): {detail}",
            ))
        return findings


def fns_site(scanner: _ModuleScanner, line: int) -> _Site:
    return (scanner.module.display, line)


def _sccs(graph: Dict[str, Set[str]]) -> List[Set[str]]:
    """Iterative Tarjan strongly-connected components."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)
    return out
