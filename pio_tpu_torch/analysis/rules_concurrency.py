"""Concurrency rules: blocking work under a held lock, unguarded
``Condition.wait``, ``notify`` without the CV's lock, and admission /
breaker handles that escape their ``finally``.

All of these are lexical checks — they look at what a function does
*while a ``with <lock>:`` block is open* (nested ``def``s reset the
context: defining a closure under a lock runs nothing).
"""

from __future__ import annotations

import ast
from typing import Callable, Iterable, List, Optional, Tuple

from pio_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    ModuleInfo,
    ProjectRule,
    Rule,
    register,
)
from pio_tpu_torch.analysis.locks import (
    LockIndex,
    build_lock_index,
    is_known_condition,
    lock_name_of,
    unparse,
)

# ---------------------------------------------------------------------------
# shared lexical scanner

#: (held, while_depth): held is [(short_name, with_expr_text)], innermost last
ScanCtx = Tuple[List[Tuple[str, str]], int]


class LockScanner:
    """Walks a module, calling ``on_call(call, held, while_depth, cls)``
    for every Call expression with its lexical lock context."""

    def __init__(self, module: ModuleInfo,
                 on_call: Callable[[ast.Call, List[Tuple[str, str]],
                                    int, Optional[str]], None]):
        self.module = module
        self.idx: LockIndex = build_lock_index(module.tree)
        self.on_call = on_call
        self._cls: Optional[str] = None

    def run(self) -> None:
        self._scan_stmts(self.module.tree.body, [], 0)

    # -- statements --------------------------------------------------------
    def _scan_stmts(self, stmts, held, while_depth) -> None:
        for stmt in stmts:
            self._scan_stmt(stmt, held, while_depth)

    def _scan_stmt(self, stmt, held, while_depth) -> None:
        if isinstance(stmt, ast.ClassDef):
            prev, self._cls = self._cls, stmt.name
            self._scan_stmts(stmt.body, [], 0)
            self._cls = prev
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def's body does not run under the enclosing locks
            self._scan_stmts(stmt.body, [], 0)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed: List[Tuple[str, str]] = []
            for item in stmt.items:
                self._walk_expr(item.context_expr, held, while_depth)
                name = lock_name_of(item.context_expr, self.idx, self._cls)
                if name is not None:
                    entry = (name, unparse(item.context_expr))
                    pushed.append(entry)
                    held = held + [entry]   # `with a, b:` -> a held for b
            self._scan_stmts(stmt.body, held, while_depth)
            return
        if isinstance(stmt, ast.While):
            self._walk_expr(stmt.test, held, while_depth)
            self._scan_stmts(stmt.body, held, while_depth + 1)
            self._scan_stmts(stmt.orelse, held, while_depth)
            return
        # generic compound/simple statement: recurse into stmt lists,
        # walk expression fields for calls
        for _field, value in ast.iter_fields(stmt):
            if isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    self._scan_stmts(value, held, while_depth)
                else:
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._walk_expr(v, held, while_depth)
                        elif isinstance(v, ast.excepthandler):
                            self._scan_stmts(v.body, held, while_depth)
            elif isinstance(value, ast.expr):
                self._walk_expr(value, held, while_depth)

    # -- expressions -------------------------------------------------------
    def _walk_expr(self, expr, held, while_depth) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self.on_call(node, held, while_depth, self._cls)


# ---------------------------------------------------------------------------
# rule: blocking call while a lock is held

#: (receiver-substring-or-None, method-name) pairs considered blocking.
#: receiver None means "any receiver" for that method name.
_BLOCKING_METHODS = (
    ("time", "sleep"),
    ("subprocess", "run"),
    ("subprocess", "call"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("subprocess", "Popen"),
    (None, "urlopen"),
    (None, "serve_forever"),
    (None, "create_connection"),
    ("sock", "recv"),
    ("sock", "accept"),
    ("sock", "connect"),
    ("conn", "commit"),     # sqlite3 fsync-on-commit under a lock
    ("db", "commit"),
)
_BLOCKING_BARE = {"sleep", "urlopen"}


def _blocking_reason(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id in _BLOCKING_BARE:
            return f"{fn.id}()"
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    recv = unparse(fn.value).lower()
    for needle, meth in _BLOCKING_METHODS:
        if fn.attr != meth:
            continue
        if needle is None or needle in recv:
            return f"{unparse(fn.value)}.{fn.attr}()"
    return None


@register
class LockBlockingCallRule(ProjectRule):
    id = "lock-blocking-call"
    family = "concurrency"
    description = (
        "Blocking call (sleep / subprocess / socket / urlopen / sqlite "
        "commit) inside a `with <lock>:` block — directly or through a "
        "resolvable callee whose effect summary blocks — stalls every "
        "other thread contending for that lock."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        # lexical fallback: no project context, direct calls only
        return self._check_module(module, None)

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        from pio_tpu_torch.analysis.effects import get_analysis
        analysis = get_analysis(modules, ctx)
        findings: List[Finding] = []
        for m in modules:
            findings.extend(self._check_module(m, analysis))
        return findings

    def _check_module(self, module: ModuleInfo, analysis) -> List[Finding]:
        findings: List[Finding] = []
        scanner = analysis.scanner_for(module) if analysis else None

        def on_call(call, held, while_depth, cls):
            if not held:
                return
            lock = held[-1][1]
            reason = _blocking_reason(call)
            if reason is not None:
                findings.append(Finding(
                    self.id, module.display, call.lineno, call.col_offset,
                    f"blocking {reason} while holding `{lock}`; move the "
                    f"blocking work outside the lock or suppress if the "
                    f"serialization is intentional",
                ))
                return
            # interprocedural: a resolvable callee whose effect summary
            # blocks is just as much of a stall, one-or-more frames down
            if scanner is None:
                return
            key = scanner.callee_key(call, cls)
            if key is None:
                return
            chained = analysis.blocking_chain(key, self.id)
            if chained is None:
                return
            site, chain = chained
            via = " -> ".join(q.rsplit(".", 1)[-1] for q in chain)
            findings.append(Finding(
                self.id, module.display, call.lineno, call.col_offset,
                f"call while holding `{lock}` reaches blocking "
                f"{site.render()} via {via}; move the blocking work "
                f"outside the lock or suppress if the serialization is "
                f"intentional",
            ))

        LockScanner(module, on_call).run()
        return findings


# ---------------------------------------------------------------------------
# rule: Condition.wait outside a while-predicate loop

@register
class CvWaitOutsideLoopRule(Rule):
    id = "cv-wait-outside-loop"
    family = "concurrency"
    description = (
        "Condition.wait() must sit inside a `while <predicate>:` loop — "
        "wakeups are advisory (spurious wakeups, stolen batons), so an "
        "`if`-guarded or bare wait() loses updates."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        idx = build_lock_index(module.tree)

        def on_call(call, held, while_depth, cls):
            fn = call.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "wait"):
                return
            # wait_for embeds its own predicate loop; Events have no
            # predicate obligation — only real Conditions are checked
            if not is_known_condition(fn.value, idx, cls):
                return
            if while_depth == 0:
                findings.append(Finding(
                    self.id, module.display, call.lineno, call.col_offset,
                    f"`{unparse(fn.value)}.wait()` is not inside a "
                    f"`while <predicate>:` loop; use "
                    f"`while not <ready>: cv.wait()` (or wait_for) so "
                    f"spurious/stolen wakeups re-check the predicate",
                ))

        LockScanner(module, on_call).run()
        return findings


# ---------------------------------------------------------------------------
# rule: notify()/notify_all() without holding the CV's lock

@register
class CvNotifyUnlockedRule(Rule):
    id = "cv-notify-unlocked"
    family = "concurrency"
    description = (
        "Condition.notify()/notify_all() must run with the CV's lock "
        "held (`with cv:`); unlocked notify raises RuntimeError at "
        "runtime and indicates a racy handoff."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        idx = build_lock_index(module.tree)

        def on_call(call, held, while_depth, cls):
            fn = call.func
            if not (isinstance(fn, ast.Attribute)
                    and fn.attr in ("notify", "notify_all")):
                return
            if not is_known_condition(fn.value, idx, cls):
                return
            cv_text = unparse(fn.value)
            if any(text == cv_text for _name, text in held):
                return
            findings.append(Finding(
                self.id, module.display, call.lineno, call.col_offset,
                f"`{cv_text}.{fn.attr}()` without `with {cv_text}:` "
                f"held in the enclosing block",
            ))

        LockScanner(module, on_call).run()
        return findings


# ---------------------------------------------------------------------------
# rule: admission / breaker-call handles must be released in a finally

def _assigned_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [e.id for e in target.elts if isinstance(e, ast.Name)]
    return []


def _is_admission_acquire(value: ast.expr) -> Optional[str]:
    """``x.admit(...)`` or ``<breaker-ish>.acquire(...)`` → a short
    description, else None."""
    if not (isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)):
        return None
    attr = value.func.attr
    recv = unparse(value.func.value).lower()
    if attr == "admit":
        return f"{unparse(value.func)}()"
    if attr == "acquire" and "breaker" in recv:
        return f"{unparse(value.func)}()"
    return None


@register
class ReleaseInFinallyRule(Rule):
    id = "release-in-finally"
    family = "convention"
    skip_tests = True
    description = (
        "A handle from `<gate>.admit(...)` or `<breaker>.acquire()` "
        "must be released/cancelled in a `finally` in the same "
        "function, or returned to the caller (ownership transfer); "
        "otherwise an early exit leaks the inflight slot / probe grant."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            findings.extend(self._check_fn(fn, module))
        return findings

    @staticmethod
    def _walk_local(fn):
        """Yield nodes of ``fn`` without descending into nested defs
        (they are analysed as functions in their own right)."""
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def _check_fn(self, fn, module: ModuleInfo) -> Iterable[Finding]:
        acquires: List[Tuple[str, ast.Assign, str]] = []  # (var, node, what)
        returned: set = set()
        finally_released: set = set()

        for node in self._walk_local(fn):
            if isinstance(node, ast.Assign):
                what = _is_admission_acquire(node.value)
                if what is not None:
                    for t in node.targets:
                        names = _assigned_names(t)
                        if names:
                            acquires.append((names[0], node, what))
            elif isinstance(node, ast.Return) and node.value is not None:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name):
                        returned.add(sub.id)
            elif isinstance(node, ast.Try) and node.finalbody:
                for sub in ast.walk(ast.Module(body=node.finalbody,
                                               type_ignores=[])):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in ("release", "cancel")):
                        base = sub.func.value
                        if isinstance(base, ast.Name):
                            finally_released.add(base.id)

        for var, node, what in acquires:
            if var in returned or var in finally_released:
                continue
            yield Finding(
                self.id, module.display, node.lineno, node.col_offset,
                f"`{var} = {what}` is neither released/cancelled in a "
                f"`finally` nor returned; an exception or early return "
                f"leaks the admission slot / breaker probe",
            )
