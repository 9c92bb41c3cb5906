"""Interprocedural effect analysis + shm frame-layout verifier.

Two halves, both project rules over the whole parsed file set:

**Effect summaries.** Every function gets a summary of what it *does*
to the machine — ``blocks`` (sleep / subprocess / socket / file IO /
fsync / sqlite commit / event & CV waits), ``json_codec`` (json
encode/decode), ``copies_bytes`` (``bytes()``, ``.decode``/``.encode``,
``.tobytes``, ``b"".join``, slicing a bytes-ish buffer), ``allocates``
(comprehensions, container constructors) and ``wallclock`` (time.time /
datetime.now reads). Summaries propagate to a fixpoint over the same
call edges :mod:`pio_tpu_torch.analysis.lockgraph` resolves — ``self.m()``,
same-module ``f()``, ``mod.f()`` and ``from mod import f`` — plus two
extensions: ``from mod import Cls`` method calls (``Cls.m()``) and
re-export chains through package ``__init__``\\s (so
``pio_tpu_torch.faults.failpoint`` resolves to the def in
``faults/registry.py``). Attribute calls on arbitrary objects stay out
of scope, exactly like the lock graph (documented limitation).

Hot-path roots are declared in source with a marker comment::

    def query(self, req):  # pio: hotpath
    def submit(self, body):  # pio: hotpath=zerocopy

``hotpath-blocking`` reports every *reachable* ``blocks`` effect from
any root, with the full call chain; ``hotpath-zero-copy`` additionally
reports reachable ``json_codec``/``copies_bytes`` effects from
``zerocopy`` roots — the contract the epoll/int8 front must hold.
A ``# pio: disable=<rule>`` comment suppresses at
three grains: on the root's def/marker line (the whole root), on a call
site along the chain (cuts that edge for everything behind it), or on
the effect line itself (that one site, for every root).

**Frame layouts.** ``shm-frame-layout`` cross-checks the writer and
reader sides of every ``struct`` wire format. Call sites and
``struct.Struct`` declarations opt in with ``# pio: frame=<family>``;
within a family the union of writer fields (offset → type code) must
equal the union of reader fields — field count, per-offset type,
pad-stripped extent, declared struct size, and endianness prefix all
have to agree, and a module that declares any family must assign every
``struct`` use to one (so a new ``pack_into`` cannot dodge the check).
Magic/size constants participate: a reader whose absolute offset lands
inside the module's ``MAGIC`` bytes, or a header family that overflows
``HEADER_BYTES``, is a finding.
"""

from __future__ import annotations

import ast
import os
import re
import struct as _structmod
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from pio_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    ModuleInfo,
    ProjectRule,
    register,
)

# ---------------------------------------------------------------------------
# effect lexicon

#: (receiver-substring-or-None, method) -> blocking; mirrors (and
#: extends) the lexical lock-rule lexicon in rules_concurrency
_BLOCKING_ATTRS = (
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
    ("sock", "sendall"),
    ("conn", "commit"),
    ("db", "commit"),
    ("os", "fsync"),
)
_BLOCKING_BARE = {"sleep", "urlopen"}

#: bytes-ish receiver names whose slice reads count as a copy
_BYTEISH_RE = re.compile(
    r"(payload|body|buf|data|frame|raw|blob|_m)\b", re.IGNORECASE
)

_ALLOC_CALLS = {"list", "dict", "set", "bytearray"}

EFFECT_KINDS = (
    "blocks", "json_codec", "copies_bytes", "allocates", "wallclock",
)


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


@dataclass(frozen=True)
class EffectSite:
    """One direct effect occurrence inside a function body."""

    kind: str       # one of EFFECT_KINDS
    what: str       # human label, e.g. "time.sleep()"
    path: str       # module display path
    line: int

    def render(self) -> str:
        return f"{self.what} at {self.path}:{self.line}"


@dataclass
class FnEffects:
    """Per-function scan result: direct effects + resolved call edges."""

    qual: str
    module: ModuleInfo
    line: int                      # def line
    marker: Optional[str] = None   # None | "" (hotpath) | "zerocopy"
    direct: List[EffectSite] = field(default_factory=list)
    calls: List[Tuple[str, int]] = field(default_factory=list)


def _resolve_import_from(module: ModuleInfo, node: ast.ImportFrom
                         ) -> Optional[str]:
    """Absolute dotted module a ``from X import …`` refers to, handling
    relative levels against this module's own dotted name."""
    if node.level == 0:
        return node.module
    parts = module.module_name.split(".")
    is_pkg = os.path.basename(module.path) == "__init__.py"
    drop = node.level - (1 if is_pkg else 0)
    if drop > len(parts):
        return None
    if drop > 0:
        parts = parts[:-drop]
    base = ".".join(parts)
    if node.module:
        return f"{base}.{node.module}" if base else node.module
    return base or None


class _EffectScanner:
    """One pass over a module: imports, per-function direct effects and
    call records, and hot-path markers bound to their defs."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.mod = module.module_name
        self.fns: Dict[str, FnEffects] = {}
        self.imports: Dict[str, str] = {}        # alias -> module
        self.from_imports: Dict[str, str] = {}   # name -> "mod.name"
        self._collect_imports()

    def _collect_imports(self) -> None:
        for node in ast.walk(self.module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] = \
                        alias.name if alias.asname else alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                target = _resolve_import_from(self.module, node)
                if target is None:
                    continue
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = \
                        f"{target}.{alias.name}"

    def scan(self) -> None:
        for top in self.module.tree.body:
            if isinstance(top, ast.ClassDef):
                for item in top.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._scan_fn(item, top.name)
            elif isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_fn(top, None)

    # -- call resolution ----------------------------------------------------
    def callee_key(self, call: ast.Call, cls: Optional[str]) -> Optional[str]:
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
                target = self.from_imports.get(base.id)
                if target is not None:          # from mod import Cls; Cls.m()
                    return f"{target}.{fn.attr}"
        return None

    # -- direct effects -----------------------------------------------------
    def _effects_of_call(self, call: ast.Call) -> Iterable[Tuple[str, str]]:
        fn = call.func
        if isinstance(fn, ast.Name):
            name = fn.id
            if name in _BLOCKING_BARE:
                yield "blocks", f"{name}()"
            elif name == "open":
                yield "blocks", "open() file IO"
            elif name == "bytes" and call.args:
                yield "copies_bytes", "bytes() copy"
            elif name in _ALLOC_CALLS and (call.args or call.keywords):
                yield "allocates", f"{name}() construction"
            resolved = self.from_imports.get(name, "")
            if resolved in ("json.loads", "json.dumps",
                            "json.load", "json.dump"):
                yield "json_codec", f"{resolved}()"
            return
        if not isinstance(fn, ast.Attribute):
            return
        recv = _unparse(fn.value)
        recv_l = recv.lower()
        attr = fn.attr
        for needle, meth in _BLOCKING_ATTRS:
            if attr == meth and (needle is None or needle in recv_l):
                yield "blocks", f"{recv}.{attr}()"
                break
        else:
            if attr in ("wait", "wait_for"):
                yield "blocks", f"{recv}.{attr}() lock/event wait"
            elif attr == "join" and "thread" in recv_l:
                yield "blocks", f"{recv}.join()"
        if recv_l == "json" and attr in ("loads", "dumps", "load", "dump"):
            yield "json_codec", f"json.{attr}()"
        if attr in ("decode", "encode"):
            yield "copies_bytes", f"{recv}.{attr}()"
        elif attr == "tobytes":
            yield "copies_bytes", f"{recv}.tobytes()"
        elif (attr == "join" and isinstance(fn.value, ast.Constant)
                and isinstance(fn.value.value, bytes)):
            yield "copies_bytes", "bytes .join()"
        if attr in ("time", "time_ns") and recv_l == "time":
            yield "wallclock", f"time.{attr}()"
        elif attr in ("now", "utcnow") and "datetime" in recv_l:
            yield "wallclock", f"{recv}.{attr}()"

    def _scan_fn(self, fn, cls: Optional[str]) -> None:
        qual = f"{self.mod}.{cls}.{fn.name}" if cls else f"{self.mod}.{fn.name}"
        marker = self.module.hotpath_markers.get(fn.lineno)
        if marker is None and fn.decorator_list:
            # marker above a decorated def covers the first decorator line
            marker = self.module.hotpath_markers.get(
                fn.decorator_list[0].lineno
            )
        info = self.fns.setdefault(
            qual, FnEffects(qual, self.module, fn.lineno, marker)
        )
        display = self.module.display
        seen: Set[Tuple[str, str, int]] = set()

        def note(kind: str, what: str, line: int) -> None:
            key = (kind, what, line)
            if key not in seen:
                seen.add(key)
                info.direct.append(EffectSite(kind, what, display, line))

        for node in _walk_local(fn):
            if isinstance(node, ast.Call):
                for kind, what in self._effects_of_call(node):
                    note(kind, what, node.lineno)
                key = self.callee_key(node, cls)
                if key is not None:
                    info.calls.append((key, node.lineno))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                note("allocates", "comprehension", node.lineno)
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.slice, ast.Slice)
                    and isinstance(node.ctx, ast.Load)
                    and _BYTEISH_RE.search(_unparse(node.value))):
                note("copies_bytes",
                     f"slice of {_unparse(node.value)}", node.lineno)


def _walk_local(fn) -> Iterable[ast.AST]:
    """Walk ``fn``'s body without descending into nested defs/classes
    (a closure defined here runs elsewhere, if at all)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# the project-wide analysis

class EffectAnalysis:
    """Call graph + effect summaries over one parsed module set."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        scanners = [_EffectScanner(m) for m in modules]
        for s in scanners:
            s.scan()
        self.fns: Dict[str, FnEffects] = {}
        self._scanner_by_module: Dict[str, _EffectScanner] = {}
        #: "mod.name" re-export/alias targets from every from-import
        alias: Dict[str, str] = {}
        for s in scanners:
            self.fns.update(s.fns)
            self._scanner_by_module[s.module.path] = s
            for name, target in s.from_imports.items():
                alias.setdefault(f"{s.mod}.{name}", target)
        self._alias = alias

        # resolved edges (only those landing on a known function)
        self.edges: Dict[str, List[Tuple[str, int]]] = {}
        for info in self.fns.values():
            out = []
            for key, line in info.calls:
                target = self.resolve(key)
                if target is not None and target != info.qual:
                    out.append((target, line))
            self.edges[info.qual] = out

        # transitive effect-kind fixpoint (cycle-safe, like lockgraph)
        self.trans: Dict[str, Set[str]] = {
            q: {site.kind for site in i.direct}
            for q, i in self.fns.items()
        }
        changed = True
        while changed:
            changed = False
            for q in self.fns:
                mine = self.trans[q]
                for callee, _line in self.edges[q]:
                    sub = self.trans.get(callee)
                    if sub and not sub <= mine:
                        mine |= sub
                        changed = True

    # -- lookups ------------------------------------------------------------
    def resolve(self, key: str) -> Optional[str]:
        """Follow re-export aliases until ``key`` names a known function
        (or give up). ``pkg.name`` re-exported from ``pkg.sub`` resolves
        through the package ``__init__``'s from-imports; ``mod.Cls.m``
        follows an aliased ``mod.Cls`` prefix."""
        seen = set()
        while key not in self.fns and key not in seen:
            seen.add(key)
            nxt = self._alias.get(key)
            if nxt is None and "." in key:
                head, _, tail = key.rpartition(".")
                base = self._alias.get(head)
                if base is not None:
                    nxt = f"{base}.{tail}"
            if nxt is None:
                return None
            key = nxt
        return key if key in self.fns else None

    def scanner_for(self, module: ModuleInfo) -> Optional[_EffectScanner]:
        return self._scanner_by_module.get(module.path)

    def roots(self) -> List[FnEffects]:
        return sorted(
            (i for i in self.fns.values() if i.marker is not None),
            key=lambda i: i.qual,
        )

    # -- reachability -------------------------------------------------------
    def reachable_sites(self, start: str, kinds: Sequence[str],
                        rule_id: Optional[str] = None
                        ) -> List[Tuple[EffectSite, List[str]]]:
        """Every direct effect site of ``kinds`` reachable from
        ``start`` (inclusive), with the shortest call chain (function
        quals, ``start`` first). ``rule_id`` applies suppressions: a
        disabled call line cuts the edge, a disabled effect line drops
        the site."""
        out: List[Tuple[EffectSite, List[str]]] = []
        seen: Set[str] = {start}
        queue: List[Tuple[str, List[str]]] = [(start, [start])]
        wanted = set(kinds)
        while queue:
            qual, chain = queue.pop(0)
            info = self.fns.get(qual)
            if info is None:
                continue
            for site in info.direct:
                if site.kind not in wanted:
                    continue
                if rule_id is not None and info.module.suppressed(
                        rule_id, site.line):
                    continue
                out.append((site, chain))
            for callee, line in self.edges.get(qual, ()):
                if callee in seen:
                    continue
                if rule_id is not None and info.module.suppressed(
                        rule_id, line):
                    continue  # suppressed call: the chain is cut here
                seen.add(callee)
                queue.append((callee, chain + [callee]))
        return out

    def blocking_chain(self, key: str, rule_id: str
                       ) -> Optional[Tuple[EffectSite, List[str]]]:
        """Shortest unsuppressed chain from call target ``key`` (a raw
        callee key — resolved here) to a ``blocks`` effect, or None."""
        target = self.resolve(key)
        if target is None or "blocks" not in self.trans.get(target, ()):
            return None
        sites = self.reachable_sites(target, ("blocks",), rule_id)
        return sites[0] if sites else None


def get_analysis(modules: Sequence[ModuleInfo],
                 ctx: LintContext) -> EffectAnalysis:
    """Build (or reuse) the effect analysis for this lint run — the
    hot-path rules and the interprocedural lock rule share one fixpoint
    per ``LintContext``."""
    key = tuple(m.path for m in modules)
    cached = getattr(ctx, "_effects_analysis", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    analysis = EffectAnalysis(modules)
    ctx._effects_analysis = (key, analysis)
    return analysis


def _chain_text(chain: List[str]) -> str:
    return " -> ".join(q.rsplit(".", 1)[-1] for q in chain)


def _root_suppressed(root: FnEffects, rule_id: str) -> bool:
    lines = [root.line]
    for ln, _v in root.module.hotpath_markers.items():
        if abs(ln - root.line) <= 1:
            lines.append(ln)
    return root.module.suppressed_at_any(rule_id, lines)


# ---------------------------------------------------------------------------
# rules: hot-path contracts

@register
class HotpathBlockingRule(ProjectRule):
    id = "hotpath-blocking"
    family = "hotpath"
    description = (
        "A function marked `# pio: hotpath` (query/dispatch/drain "
        "roots) reaches a blocking call — sleep, subprocess, socket, "
        "file IO, fsync, sqlite commit or event/CV wait — through the "
        "interprocedural call graph; the full chain is reported."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> List[Finding]:
        analysis = get_analysis(modules, ctx)
        findings: List[Finding] = []
        for root in analysis.roots():
            if _root_suppressed(root, self.id):
                continue
            for site, chain in analysis.reachable_sites(
                    root.qual, ("blocks",), self.id):
                findings.append(Finding(
                    self.id, root.module.display, root.line, 0,
                    f"hot path `{root.qual}` reaches blocking "
                    f"{site.render()} via {_chain_text(chain)}; move the "
                    f"blocking work off the hot path or suppress at the "
                    f"site with a justification",
                ))
        return findings


@register
class HotpathZeroCopyRule(ProjectRule):
    id = "hotpath-zero-copy"
    family = "hotpath"
    description = (
        "A function marked `# pio: hotpath=zerocopy` (the int8 packed-"
        "frame path) reaches a JSON encode/decode or a bytes copy "
        "(bytes()/.decode/.encode/.tobytes/slice) — the zero-copy "
        "contract the epoll front depends on."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> List[Finding]:
        analysis = get_analysis(modules, ctx)
        findings: List[Finding] = []
        for root in analysis.roots():
            if root.marker != "zerocopy":
                continue
            if _root_suppressed(root, self.id):
                continue
            for site, chain in analysis.reachable_sites(
                    root.qual, ("json_codec", "copies_bytes"), self.id):
                findings.append(Finding(
                    self.id, root.module.display, root.line, 0,
                    f"zero-copy path `{root.qual}` reaches {site.kind} "
                    f"{site.render()} via {_chain_text(chain)}; keep the "
                    f"packed frame untouched or suppress at the site "
                    f"with a justification",
                ))
        return findings


# ---------------------------------------------------------------------------
# frame-layout verifier

@dataclass
class FrameRecord:
    family: str
    role: str                  # "writer" | "reader"
    fmt: str
    delta: Optional[int]       # constant byte offset (None = none given)
    absolute: bool             # delta was a bare constant offset arg
    path: str
    line: int

    def site(self) -> str:
        return f"{self.path}:{self.line}"


def _parse_fmt(fmt: str):
    """(endian, fields [(offset, code, size)], total size, non-pad
    extent) or None when the format does not parse."""
    endian = fmt[0] if fmt[:1] in "<>=!@" else "@"
    body = fmt[1:] if fmt[:1] in "<>=!@" else fmt
    try:
        total = _structmod.calcsize(fmt)
    except _structmod.error:
        return None
    fields: List[Tuple[int, str, int]] = []
    consumed = ""
    extent = 0
    for count_s, code in re.findall(r"\s*(\d*)([a-zA-Z?])", body):
        pre = _structmod.calcsize((fmt[:1] if endian != "@" else "")
                                  + consumed) if consumed else 0
        consumed += count_s + code
        if code == "x":
            continue
        count = int(count_s) if count_s else 1
        if code == "s":
            fields.append((pre, f"{count}s", count))
            extent = max(extent, pre + count)
            continue
        size = _structmod.calcsize(
            (fmt[:1] if endian != "@" else "") + code
        )
        for i in range(count):
            fields.append((pre + i * size, code, size))
        extent = max(extent, pre + count * size)
    return endian, fields, total, extent


_PACK_METHS = {"pack", "pack_into"}
_UNPACK_METHS = {"unpack", "unpack_from", "iter_unpack"}


def _const_offset(node: Optional[ast.expr]) -> Tuple[Optional[int], bool]:
    """(constant byte delta, was-absolute) for an offset argument:
    a bare constant is absolute; ``base + C`` contributes delta C from
    a symbolic base; anything else is symbolic delta 0."""
    if node is None:
        return None, False
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value, True
    if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)):
        for a, b in ((node.left, node.right), (node.right, node.left)):
            if isinstance(b, ast.Constant) and isinstance(b.value, int) \
                    and not isinstance(a, ast.Constant):
                return b.value, False
    return 0, False


class _FrameScanner:
    """Collect frame records + magic/size constants from one module."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.records: List[FrameRecord] = []
        self.unassigned: List[Tuple[str, int]] = []   # (what, line)
        self.magics: Dict[str, bytes] = {}
        self.consts: Dict[str, int] = {}
        self._struct_vars: Dict[str, Tuple[str, Optional[str]]] = {}
        if module.frame_markers:
            self._scan()

    def _family_at(self, line: int) -> Optional[str]:
        return self.module.frame_markers.get(line)

    def _scan(self) -> None:
        tree = self.module.tree
        for top in tree.body:
            if not isinstance(top, ast.Assign):
                continue
            for t in top.targets:
                if not isinstance(t, ast.Name):
                    continue
                v = top.value
                if isinstance(v, ast.Constant) and isinstance(v.value, bytes) \
                        and "MAGIC" in t.id:
                    self.magics[t.id] = v.value
                elif isinstance(v, ast.Constant) and isinstance(v.value, int):
                    self.consts[t.id] = v.value
                elif (isinstance(v, ast.Call)
                        and isinstance(v.func, ast.Attribute)
                        and v.func.attr == "Struct"
                        and v.args
                        and isinstance(v.args[0], ast.Constant)
                        and isinstance(v.args[0].value, str)):
                    fam = self._family_at(top.lineno)
                    self._struct_vars[t.id] = (v.args[0].value, fam)
                    if fam is None:
                        self.unassigned.append(
                            (f"struct.Struct assigned to {t.id}", top.lineno)
                        )
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._scan_call(node)

    def _record(self, family: Optional[str], role: str, fmt: str,
                off_node: Optional[ast.expr], line: int, what: str) -> None:
        if family is None:
            family = self._family_at(line)
        if family is None:
            self.unassigned.append((what, line))
            return
        delta, absolute = _const_offset(off_node)
        self.records.append(FrameRecord(
            family, role, fmt, delta, absolute,
            self.module.display, line,
        ))

    def _scan_call(self, call: ast.Call) -> None:
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return
        attr = fn.attr
        if attr not in _PACK_METHS | _UNPACK_METHS:
            return
        role = "writer" if attr in _PACK_METHS else "reader"
        base = fn.value
        if isinstance(base, ast.Name) and base.id == "struct":
            # struct.pack(fmt, ...) / struct.pack_into(fmt, buf, off, ...)
            if not (call.args and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)):
                return
            fmt = call.args[0].value
            off = None
            if attr in ("pack_into", "unpack_from"):
                off = call.args[2] if len(call.args) > 2 else None
                if off is None:
                    off = next((kw.value for kw in call.keywords
                                if kw.arg == "offset"), None)
            self._record(None, role, fmt, off, call.lineno,
                         f"struct.{attr}({fmt!r}, …)")
            return
        if isinstance(base, ast.Name) and base.id in self._struct_vars:
            fmt, fam = self._struct_vars[base.id]
            off = None
            if attr in ("pack_into", "unpack_from"):
                off = call.args[1] if len(call.args) > 1 else None
                if off is None:
                    off = next((kw.value for kw in call.keywords
                                if kw.arg == "offset"), None)
            self._record(fam, role, fmt, off, call.lineno,
                         f"{base.id}.{attr}(…)")


@dataclass
class _FamilyState:
    records: List[FrameRecord] = field(default_factory=list)
    magics: Dict[str, bytes] = field(default_factory=dict)
    consts: Dict[str, int] = field(default_factory=dict)


def _family_layouts(fam: str, state: _FamilyState):
    """Per-role normalized field maps + metadata; yields findings for
    parse failures and intra-role conflicts, returns the summary."""
    findings: List[str] = []   # (message) — caller attaches path/line
    roles: Dict[str, Dict[int, Tuple[str, int, FrameRecord]]] = {}
    endians: Dict[str, Set[Tuple[str, str]]] = {}
    declared: Dict[str, Dict[int, FrameRecord]] = {}
    min_raw_reader: Optional[int] = None
    for rec in state.records:
        parsed = _parse_fmt(rec.fmt)
        if parsed is None:
            findings.append(
                f"frame family `{fam}`: unparsable struct format "
                f"{rec.fmt!r} at {rec.site()}"
            )
            continue
        endian, fields, total, extent = parsed
        endians.setdefault(rec.role, set()).add((endian, rec.site()))
        base = rec.delta or 0
        if rec.role == "reader" and rec.absolute and rec.delta is not None:
            if min_raw_reader is None or rec.delta < min_raw_reader:
                min_raw_reader = rec.delta
        # a record that lays out the whole frame (multi-field or padded,
        # anchored at the frame base) declares the frame's true size
        if (rec.delta in (None, 0) or rec.absolute) \
                and (len(fields) > 1 or total > extent):
            declared.setdefault(rec.role, {})[total] = rec
        entries = roles.setdefault(rec.role, {})
        for off, code, size in fields:
            key = base + off
            prev = entries.get(key)
            if prev is not None and prev[0] != code:
                findings.append(
                    f"frame family `{fam}`: conflicting {rec.role} field "
                    f"at byte {key}: `{prev[0]}` ({prev[2].site()}) vs "
                    f"`{code}` ({rec.site()})"
                )
            entries[key] = (code, size, rec)
    # normalize each role to its own base (a header writer that packs
    # sequentially after the magic and a reader that unpack_from's at
    # the absolute offset describe the same fields)
    norm: Dict[str, Dict[int, Tuple[str, int, FrameRecord]]] = {}
    for role, entries in roles.items():
        if not entries:
            continue
        lo = min(entries)
        norm[role] = {off - lo: v for off, v in entries.items()}
    return findings, norm, endians, declared, min_raw_reader


def _check_family(fam: str, state: _FamilyState) -> List[str]:
    msgs, norm, endians, declared, min_reader = _family_layouts(fam, state)
    # endianness: every record in the family must agree
    prefixes = {e for sides in endians.values() for (e, _s) in sides}
    if len(prefixes) > 1:
        detail = "; ".join(
            f"{role}: " + ", ".join(
                sorted(f"{e!r} at {s}" for e, s in sides)
            )
            for role, sides in sorted(endians.items())
        )
        msgs.append(
            f"frame family `{fam}`: endianness prefixes disagree "
            f"({detail})"
        )
    writer = norm.get("writer")
    reader = norm.get("reader")
    if writer and reader:
        if len(writer) != len(reader):
            msgs.append(
                f"frame family `{fam}`: field count disagrees — "
                f"writers cover {len(writer)} field(s), readers "
                f"{len(reader)}"
            )
        for off in sorted(set(writer) | set(reader)):
            w, r = writer.get(off), reader.get(off)
            if w is None or r is None:
                side, rec = ("writer", r) if w is None else ("reader", w)
                msgs.append(
                    f"frame family `{fam}`: byte {off} has no {side} "
                    f"(field `{(w or r)[0]}` from {(w or r)[2].site()})"
                )
            elif w[0] != r[0]:
                msgs.append(
                    f"frame family `{fam}`: field type at byte {off} "
                    f"disagrees — writer `{w[0]}` ({w[2].site()}) vs "
                    f"reader `{r[0]}` ({r[2].site()})"
                )
        w_ext = max(o + v[1] for o, v in writer.items())
        r_ext = max(o + v[1] for o, v in reader.items())
        if w_ext != r_ext:
            msgs.append(
                f"frame family `{fam}`: field extent disagrees — "
                f"writers end at byte {w_ext}, readers at {r_ext}"
            )
        dw, dr = declared.get("writer"), declared.get("reader")
        if dw and dr and set(dw) != set(dr):
            w_sz, r_sz = sorted(dw), sorted(dr)
            msgs.append(
                f"frame family `{fam}`: computed byte size disagrees — "
                f"writer frame {w_sz} byte(s) "
                f"({dw[w_sz[0]].site()}) vs reader frame {r_sz} byte(s) "
                f"({dr[r_sz[0]].site()})"
            )
    # magic/header constants: a reader anchored at an absolute offset
    # must clear the magic, and a header frame must fit HEADER_BYTES
    if min_reader is not None and state.magics:
        magic_len = max(len(v) for v in state.magics.values())
        if 0 < min_reader < magic_len:
            msgs.append(
                f"frame family `{fam}`: reader offset {min_reader} "
                f"lands inside the {magic_len}-byte magic"
            )
        hdr = state.consts.get("HEADER_BYTES")
        if hdr is not None and reader:
            r_ext = max(o + v[1] for o, v in reader.items())
            if min_reader >= magic_len and min_reader + r_ext > hdr:
                msgs.append(
                    f"frame family `{fam}`: header fields end at byte "
                    f"{min_reader + r_ext}, past HEADER_BYTES={hdr}"
                )
    return msgs


@register
class ShmFrameLayoutRule(ProjectRule):
    id = "shm-frame-layout"
    family = "layout"
    description = (
        "Writer/reader struct layouts of a shared-memory or on-disk "
        "frame family (`# pio: frame=<name>` markers) disagree in "
        "field count, per-offset type, computed byte size or "
        "endianness — or a struct call in a frame module is not "
        "assigned to any family."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        families: Dict[str, _FamilyState] = {}
        anchor: Dict[str, Tuple[str, int]] = {}
        for m in modules:
            sc = _FrameScanner(m)
            for what, line in sc.unassigned:
                findings.append(Finding(
                    self.id, m.display, line, 0,
                    f"{what} in a frame-declaring module is not "
                    f"assigned to a family; add `# pio: frame=<name>`",
                ))
            for rec in sc.records:
                st = families.setdefault(rec.family, _FamilyState())
                st.records.append(rec)
                st.magics.update(sc.magics)
                st.consts.update(sc.consts)
                anchor.setdefault(rec.family, (rec.path, rec.line))
        for fam in sorted(families):
            path, line = anchor[fam]
            for msg in _check_family(fam, families[fam]):
                findings.append(Finding(self.id, path, line, 0, msg))
        return findings


# ---------------------------------------------------------------------------
# debug surfaces (pio lint --dump-callgraph / --dump-effects)

def callgraph_inventory(modules: Sequence[ModuleInfo]) -> dict:
    """Resolved call edges, caller qual -> sorted callee quals."""
    analysis = EffectAnalysis(modules)
    return {
        qual: sorted({callee for callee, _line in edges})
        for qual, edges in sorted(analysis.edges.items())
        if edges
    }


def effects_inventory(modules: Sequence[ModuleInfo]) -> dict:
    """Hot-path roots + per-function effect summaries (functions with
    at least one direct effect; `reaches` is the transitive kind set)."""
    analysis = EffectAnalysis(modules)
    functions = {}
    for qual, info in sorted(analysis.fns.items()):
        if not info.direct and not analysis.trans.get(qual):
            continue
        functions[qual] = {
            "direct": sorted(
                f"{s.kind}: {s.what} @ {s.path}:{s.line}"
                for s in info.direct
            ),
            "reaches": sorted(analysis.trans.get(qual, ())),
        }
    return {
        "roots": [
            {
                "function": r.qual,
                "marker": "zerocopy" if r.marker == "zerocopy" else "hotpath",
                "path": r.module.display,
                "line": r.line,
            }
            for r in analysis.roots()
        ],
        "functions": functions,
        "stats": {
            "functions": len(analysis.fns),
            "edges": sum(len(e) for e in analysis.edges.values()),
        },
    }


def frame_inventory(modules: Sequence[ModuleInfo]) -> dict:
    """Per-family writer/reader census — the guard test's view that the
    real frame families each have at least one verified pair."""
    families: Dict[str, _FamilyState] = {}
    for m in modules:
        sc = _FrameScanner(m)
        for rec in sc.records:
            st = families.setdefault(rec.family, _FamilyState())
            st.records.append(rec)
            st.magics.update(sc.magics)
            st.consts.update(sc.consts)
    out = {}
    for fam, st in sorted(families.items()):
        _msgs, norm, _endians, _declared, _min = _family_layouts(fam, st)
        writers = [r for r in st.records if r.role == "writer"]
        readers = [r for r in st.records if r.role == "reader"]
        disagreements = _check_family(fam, st)
        fields = norm.get("reader") or norm.get("writer") or {}
        out[fam] = {
            "writers": len(writers),
            "readers": len(readers),
            "fields": len(fields),
            "extent": (
                max(o + v[1] for o, v in fields.items()) if fields else 0
            ),
            "verified": bool(writers) and bool(readers)
            and not disagreements,
            "findings": len(disagreements),
        }
    return out
