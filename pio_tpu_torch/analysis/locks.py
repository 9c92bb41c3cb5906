"""Shared lock/CV identification for the concurrency rules.

Locks are recognised two ways, in preference order:

1. **Definitions** — an assignment whose RHS is ``threading.Lock()``,
   ``threading.RLock()``, ``threading.Condition()`` (bare names imported
   from threading count too) or one of the project's debug factories
   ``make_lock()`` / ``make_rlock()`` / ``make_condition()``. Targets
   ``self.<attr>`` (inside a class) and module-level names are indexed.
2. **Naming convention fallback** — an attribute/name that *looks* like
   a lock (``…lock``, ``_cv``, ``…cond``) so `with`-statements over
   locks defined in a different file still participate.

``threading.Event`` is deliberately NOT a lock: ``event.wait()`` has no
predicate-loop obligation and holding no mutex is its whole point.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Optional, Set

#: RHS callables that create a mutex-like object
LOCK_FACTORY_NAMES = {"Lock", "RLock", "make_lock", "make_rlock"}
CV_FACTORY_NAMES = {"Condition", "make_condition"}

_LOCKISH_SUFFIXES = ("lock", "_cv", "cond", "mutex")


def _factory_name(node: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` / ``make_lock(...)`` → the
    callable's terminal name, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


@dataclass
class LockIndex:
    """Lock/CV definitions for one module."""

    #: "ClassName" -> set of self-attribute names that hold locks
    class_attrs: Dict[str, Set[str]] = field(default_factory=dict)
    #: module-level names that hold locks
    module_names: Set[str] = field(default_factory=set)
    #: subset of the above that are Conditions ("Class.attr" / "name")
    conditions: Set[str] = field(default_factory=set)

    def is_condition(self, cls: Optional[str], name: str) -> bool:
        key = f"{cls}.{name}" if cls else name
        return key in self.conditions


def build_lock_index(tree: ast.Module) -> LockIndex:
    idx = LockIndex()

    def record(cls: Optional[str], name: str, factory: str) -> None:
        if cls:
            idx.class_attrs.setdefault(cls, set()).add(name)
            key = f"{cls}.{name}"
        else:
            idx.module_names.add(name)
            key = name
        if factory in CV_FACTORY_NAMES:
            idx.conditions.add(key)

    def scan(body, cls: Optional[str]) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    _scan_assign(sub, node.name)
            else:
                for sub in ast.walk(node):
                    _scan_assign(sub, cls)

    def _scan_assign(node: ast.AST, cls: Optional[str]) -> None:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            return
        factory = _factory_name(value)
        if factory not in LOCK_FACTORY_NAMES | CV_FACTORY_NAMES:
            return
        for t in targets:
            if isinstance(t, ast.Name):
                # module-level name, or a function-local lock: either
                # way `with <name>:` in this module should resolve
                record(None, t.id, factory)
            elif (isinstance(t, ast.Attribute)
                  and isinstance(t.value, ast.Name)
                  and t.value.id == "self" and cls is not None):
                record(cls, t.attr, factory)

    scan(tree.body, None)
    return idx


def looks_lockish(name: str) -> bool:
    low = name.lower()
    return low.endswith(_LOCKISH_SUFFIXES) or low in ("cv", "cond")


def lock_name_of(node: ast.expr, idx: LockIndex,
                 cls: Optional[str]) -> Optional[str]:
    """If ``node`` (a with-item / method receiver) denotes a known or
    lockish-looking lock, return its short name, else None."""
    if isinstance(node, ast.Attribute):
        base_self = isinstance(node.value, ast.Name) and node.value.id == "self"
        if base_self and cls and node.attr in idx.class_attrs.get(cls, ()):
            return node.attr
        if looks_lockish(node.attr):
            return node.attr
        return None
    if isinstance(node, ast.Name):
        if node.id in idx.module_names or looks_lockish(node.id):
            return node.id
    return None


def is_known_condition(node: ast.expr, idx: LockIndex,
                       cls: Optional[str]) -> bool:
    """True when ``node`` denotes a Condition: a tracked Condition
    definition, or an attribute/name following the ``_cv``/``…cond``
    convention."""
    if isinstance(node, ast.Attribute):
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and cls is not None and idx.is_condition(cls, node.attr)):
            return True
        low = node.attr.lower()
        return low in ("cv", "_cv") or low.endswith(("cond", "_cv"))
    if isinstance(node, ast.Name):
        if node.id in idx.conditions:
            return True
        low = node.id.lower()
        return low in ("cv", "cond") or low.endswith(("cond", "_cv"))
    return False


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"
