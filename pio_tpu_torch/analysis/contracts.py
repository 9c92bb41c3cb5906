"""Cross-surface contract extraction: who writes which JSON keys, who
reads them, which ``X-Pio-*`` headers flow, and every ``PIO_TPU_*`` env
knob read with its parse type and default.

The distributed planes (router scraping member ``/fleet.json``, the
rollout judge reading candidate metrics, the CLI/dashboard parsing every
status endpoint) communicate through JSON payloads that no type checker
sees — a renamed producer key fails silently as ``None`` in another
process. This pass makes those surfaces checkable:

* **Producers** — payload-builder functions found via ``# pio:
  endpoint=/fleet.json`` markers and route-registration literals
  (``router.add("GET", "/fleet\\.json", self.fleet_json)``). Helper
  functions reached through the effect call graph contribute
  their dict keys to the root's endpoint, so ``_member_entry`` keys
  attribute to ``/fleet.json``.
* **Consumers** — ``.get("k")``/``["k"]`` chains over values tainted by
  an endpoint: fetched with a literal path argument, seeded by a
  ``# pio: consumes=/fleet.json`` marker (for payloads that crossed a
  process boundary before arriving as a parameter), or read off an
  attribute a scrape loop stored a tainted payload into.
* **Headers** — ``X-Pio-*`` writes (subscript stores, dict literals,
  ``send_header``/``add_header``) vs reads (``.get``/``[...]``/
  ``.getheader``), resolving module header constants across imports.
* **Knobs** — every ``env_int``/``env_float``/``os.environ`` read of a
  literal ``PIO_TPU_*`` name (including names held in module constants)
  plus registry reads via :mod:`pio_tpu_torch.utils.knobs`.

``rules_contracts`` turns disagreements into findings; ``pio lint
--dump-contracts`` emits the whole inventory as JSON.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from pio_tpu_torch.analysis.core import LintContext, ModuleInfo
from pio_tpu_torch.analysis.effects import get_analysis

#: a JSON endpoint path at the end of a (possibly larger URL) literal
_ENDPOINT_RE = re.compile(r"(/[A-Za-z0-9_\-][A-Za-z0-9_\-/.]*\.json)$")
_KNOB_RE = re.compile(r"^PIO_TPU_[A-Z0-9_]+$")
_HEADER_PREFIX = "x-pio-"


@dataclass(frozen=True)
class ProducerRoot:
    """One payload-builder function attributed to an endpoint."""

    endpoint: str
    qual: str
    path: str                      # display path
    line: int


@dataclass(frozen=True)
class ConsumerRead:
    """One key chain a consumer reads off an endpoint payload."""

    endpoint: str
    key: str                       # dotted, e.g. "members.slo.worstBurn"
    path: str
    line: int
    is_test: bool


@dataclass(frozen=True)
class HeaderUse:
    """One ``X-Pio-*`` header touch point."""

    header: str                    # lower-cased for set algebra
    canonical: str                 # as written in source
    role: str                      # "write" | "read" | "declare"
    path: str
    line: int
    is_test: bool


#: sentinel: the read site passed no default expression at all
NO_DEFAULT = object()
#: sentinel: a default expression was present but not statically foldable
DYNAMIC_DEFAULT = object()


@dataclass(frozen=True)
class KnobRead:
    """One ``PIO_TPU_*`` env read site."""

    name: str
    via: str                       # "registry" | "envutil" | "environ"
    kind: str                      # "int" | "float" | "str" | "raw"
    default: object                # literal default / NO_DEFAULT / DYNAMIC...
    path: str
    line: int
    is_test: bool
    module_name: str


@dataclass
class Contracts:
    """The extracted cross-surface inventory for one module set."""

    producers: Dict[str, List[ProducerRoot]] = field(default_factory=dict)
    #: endpoint -> flat union of every key any reached builder writes
    keys: Dict[str, Set[str]] = field(default_factory=dict)
    reads: List[ConsumerRead] = field(default_factory=list)
    headers: List[HeaderUse] = field(default_factory=list)
    knob_reads: List[KnobRead] = field(default_factory=list)


def get_contracts(modules: Sequence[ModuleInfo],
                  ctx: LintContext) -> Contracts:
    """Build (or reuse) the contract extraction for this lint run —
    all contract rules and ``--dump-contracts`` share one pass per
    :class:`LintContext`, like :func:`effects.get_analysis`."""
    key = tuple(m.path for m in modules)
    cached = getattr(ctx, "_contracts", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    extracted = _extract(modules, ctx)
    ctx._contracts = (key, extracted)
    return extracted


# ---------------------------------------------------------------------------
# shared per-module scaffolding

class _ModScan:
    """Imports, module-level constants, and top-level function nodes of
    one module — the cheap per-file substrate every extractor shares."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.mod = module.module_name
        self.imports: Dict[str, str] = {}        # alias -> module
        self.from_imports: Dict[str, str] = {}   # name -> "mod.name"
        self.str_consts: Dict[str, str] = {}     # NAME -> value
        self.num_consts: Dict[str, object] = {}  # NAME -> folded number
        #: (qual, class name or None, fn node)
        self.fns: List[Tuple[str, Optional[str], ast.AST]] = []
        self._collect()

    def _collect(self) -> None:
        from pio_tpu_torch.analysis.effects import _resolve_import_from
        for node in self.module.tree.body:
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
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str):
                    self.str_consts[name] = node.value.value
                else:
                    num = _fold_number(node.value)
                    if num is not None:
                        self.num_consts[name] = num
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.fns.append(
                            (f"{self.mod}.{node.name}.{item.name}",
                             node.name, item))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.fns.append((f"{self.mod}.{node.name}", None, node))


def _fold_number(node: ast.AST) -> Optional[object]:
    """Statically fold a numeric constant expression (``4 * 1024 *
    1024``, ``-1.5``) — how declared defaults held in module constants
    become comparable values."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _fold_number(node.operand)
        return None if inner is None else -inner
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Mult, ast.Add, ast.Sub, ast.FloorDiv, ast.Div)):
        left, right = _fold_number(node.left), _fold_number(node.right)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.FloorDiv):
                return left // right
            return left / right
        except (ZeroDivisionError, OverflowError):
            return None
    return None


def _resolve_str(node: ast.AST, scan: _ModScan,
                 global_consts: Dict[str, str]) -> Optional[str]:
    """A string-valued expression: literal, module constant, imported
    constant, or ``mod.CONST`` attribute."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in scan.str_consts:
            return scan.str_consts[node.id]
        target = scan.from_imports.get(node.id)
        if target is not None:
            return global_consts.get(target)
        return None
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        target = scan.imports.get(node.value.id)
        if target is not None:
            return global_consts.get(f"{target}.{node.attr}")
        target = scan.from_imports.get(node.value.id)
        if target is not None:
            return global_consts.get(f"{target}.{node.attr}")
    return None


# ---------------------------------------------------------------------------
# producers

def _route_registrations(scan: _ModScan) -> List[ProducerRoot]:
    """``router.add("GET", "/fleet\\.json", self.fleet_json)`` calls —
    the handler method becomes a producer root for the unescaped path."""
    out: List[ProducerRoot] = []
    for qual, cls, fn in scan.fns:
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add"
                    and len(node.args) >= 3):
                continue
            pat = node.args[1]
            if not (isinstance(pat, ast.Constant)
                    and isinstance(pat.value, str)):
                continue
            path = pat.value.replace("\\", "")
            if not _ENDPOINT_RE.search(path):
                continue
            handler = node.args[2]
            if isinstance(handler, ast.Attribute) \
                    and isinstance(handler.value, ast.Name) \
                    and handler.value.id == "self" and cls is not None:
                hq = f"{scan.mod}.{cls}.{handler.attr}"
            elif isinstance(handler, ast.Name):
                hq = f"{scan.mod}.{handler.id}"
            else:
                continue
            out.append(ProducerRoot(path, hq, scan.module.display,
                                    node.lineno))
    return out


def _marker_roots(scan: _ModScan) -> List[ProducerRoot]:
    out: List[ProducerRoot] = []
    markers = scan.module.endpoint_markers
    if not markers:
        return out
    for qual, _cls, fn in scan.fns:
        ep = markers.get(fn.lineno)
        if ep:
            out.append(ProducerRoot(ep, qual, scan.module.display,
                                    fn.lineno))
    return out


def _produced_keys(fn: ast.AST) -> Set[str]:
    """Every JSON key this function can write: dict-literal keys,
    ``payload["k"] = ...`` stores, ``dict(k=...)`` keywords, and
    ``.setdefault("k", ...)`` seeds.

    A dynamic map — dict comprehension, f-string/computed key, plain
    ``dict(pairs)``, ``dataclasses.asdict(...)`` — contributes the
    wildcard ``"*"``: its keys are runtime values (breaker names, burn
    windows, partition ids) the AST cannot enumerate, so consumers of
    that endpoint get the benefit of the doubt for unknown segments."""
    keys: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
                else:
                    keys.add("*")
        elif isinstance(node, ast.DictComp):
            keys.add("*")
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Store):
            if isinstance(node.slice, ast.Constant):
                if isinstance(node.slice.value, str):
                    keys.add(node.slice.value)
            else:
                keys.add("*")
        elif isinstance(node, ast.Call):
            fname = node.func
            if isinstance(fname, ast.Name) and fname.id == "dict":
                keys.update(kw.arg for kw in node.keywords if kw.arg)
                if node.args:
                    keys.add("*")
            elif (isinstance(fname, ast.Name) and fname.id == "asdict") \
                    or (isinstance(fname, ast.Attribute)
                        and fname.attr == "asdict"):
                keys.add("*")
            elif isinstance(fname, ast.Attribute) \
                    and fname.attr == "setdefault" and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    keys.add(a0.value)
    return keys


# ---------------------------------------------------------------------------
# consumers

#: taint = (endpoint, dotted prefix inside its payload; "" = the root).
#: Every binding carries a *set* of taints: a name rebound across two
#: scrape loops (``for p in fleet[...]`` then ``for p in storage[...]``)
#: is ambiguous, and reads through an ambiguous name are skipped rather
#: than misattributed.
_Taint = Tuple[str, str]
_Taints = Set[_Taint]


def _join(prefix: str, key: str) -> str:
    return f"{prefix}.{key}" if prefix else key


def _endpoint_in_call(node: ast.Call) -> Optional[str]:
    """An endpoint path literal anywhere in the call's arguments —
    ``_get_json(m, "/train.json")``, ``urlopen(url + "/slo.json")``,
    f-string URLs. Route registrations (``.add``) don't count: they
    declare a producer, they don't fetch."""
    if isinstance(node.func, ast.Attribute) and node.func.attr == "add":
        return None
    for arg in node.args + [kw.value for kw in node.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                m = _ENDPOINT_RE.search(sub.value)
                if m:
                    return m.group(1)
    return None


class _ConsumerScan:
    """Per-module taint pass binding payload values to endpoints and
    recording the key chains read off them."""

    def __init__(self, scan: _ModScan):
        self.scan = scan
        #: attribute name -> endpoints, from ``m.train = <tainted>``
        self.attr_bindings: Dict[str, Set[str]] = {}
        self.reads: List[ConsumerRead] = []

    def run(self) -> None:
        # two passes so attribute bindings written in one function
        # (scrape loop) are visible to taints in another (renderer)
        fn_taints: Dict[str, Dict[str, _Taints]] = {}
        for _pass in range(2):
            for qual, _cls, fn in self.scan.fns:
                fn_taints[qual] = self._taints_of(fn)
        for qual, _cls, fn in self.scan.fns:
            self._collect_reads(fn, fn_taints[qual])

    # -- taint seeding ------------------------------------------------------
    def _taints_of(self, fn: ast.AST) -> Dict[str, _Taints]:
        taints: Dict[str, _Taints] = {}
        marker = self.scan.module.consumes_markers.get(fn.lineno)
        if marker:
            for arg in list(fn.args.posonlyargs) + list(fn.args.args) \
                    + list(fn.args.kwonlyargs):
                if arg.arg not in ("self", "cls"):
                    taints[arg.arg] = {(marker, "")}
        # assignments/loops to a local fixpoint (chains assign forward,
        # so a few passes close out nested rebinding)
        for _round in range(3):
            before = sum(len(s) for s in taints.values())
            for node in ast.walk(fn):
                self._seed_stmt(node, taints)
            if sum(len(s) for s in taints.values()) == before:
                break
        return taints

    def _bind(self, taints: Dict[str, _Taints], name: str,
              t: _Taints, value: ast.AST) -> None:
        if t:
            taints.setdefault(name, set()).update(t)
        elif name in taints \
                and not isinstance(value, (ast.Constant, ast.Dict,
                                           ast.List, ast.Tuple, ast.Set)):
            # the name is rebound to something we can't trace (a helper
            # call, a different loop's iterable): the flat per-function
            # table can no longer say WHICH binding a later read sees, so
            # poison it to ambiguous rather than misattribute.  Literal
            # inits (``x = None`` before the fetch) don't poison.
            taints[name].add(("?", ""))

    def _seed_stmt(self, node: ast.AST,
                   taints: Dict[str, _Taints]) -> None:
        if isinstance(node, ast.Assign):
            t = self._taint_of(node.value, taints)
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self._bind(taints, target.id, t, node.value)
                elif isinstance(target, ast.Tuple) and target.elts \
                        and isinstance(target.elts[-1], ast.Name):
                    # ``status, body = http(...)`` / ``st, hdrs, body =``
                    # — the JSON payload rides last in every fetch-helper
                    # idiom in this tree; the status/headers positions
                    # must NOT inherit payload taint (their reads are
                    # HTTP metadata, not payload keys)
                    self._bind(taints, target.elts[-1].id, t, node.value)
                elif isinstance(target, ast.Attribute) and t:
                    # m.train = train  -> every later `<x>.train` read in
                    # this module is a /train.json payload
                    self.attr_bindings.setdefault(
                        target.attr, set()).update(ep for ep, _pfx in t)
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            self._bind(taints, node.target.id,
                       self._taint_of(node.value, taints), node.value)
        elif isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            self._bind(taints, node.target.id,
                       self._taint_of(node.iter, taints), node.iter)
        elif isinstance(node, ast.comprehension) \
                and isinstance(node.target, ast.Name):
            self._bind(taints, node.target.id,
                       self._taint_of(node.iter, taints), node.iter)
        elif isinstance(node, ast.withitem) \
                and node.optional_vars is not None \
                and isinstance(node.optional_vars, ast.Name):
            self._bind(taints, node.optional_vars.id,
                       self._taint_of(node.context_expr, taints),
                       node.context_expr)

    # -- expression taint ---------------------------------------------------
    def _taint_of(self, node: ast.AST,
                  taints: Dict[str, _Taints]) -> _Taints:
        if isinstance(node, ast.Name):
            return taints.get(node.id, set())
        if isinstance(node, ast.Await):
            return self._taint_of(node.value, taints)
        if isinstance(node, ast.Attribute):
            return {(ep, "")
                    for ep in self.attr_bindings.get(node.attr, ())}
        if isinstance(node, ast.Subscript):
            base = self._taint_of(node.value, taints)
            if isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                key = node.slice.value
                return {(ep, _join(pfx, key)) for ep, pfx in base}
            # list indexing / slicing keeps the payload position
            return base
        if isinstance(node, ast.BoolOp):
            return self._taint_of(node.values[0], taints)
        if isinstance(node, ast.IfExp):
            return (self._taint_of(node.body, taints)
                    | self._taint_of(node.orelse, taints))
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                base = self._taint_of(fn.value, taints)
                if fn.attr == "get" and node.args:
                    a0 = node.args[0]
                    if isinstance(a0, ast.Constant) \
                            and isinstance(a0.value, str):
                        key = a0.value
                        return {(ep, _join(pfx, key))
                                for ep, pfx in base}
                    return set()
                if fn.attr in ("read", "json", "copy", "items", "values"):
                    # decode/iterate wrappers keep the payload taint
                    return base
            ep = _endpoint_in_call(node)
            if ep is not None:
                return {(ep, "")}
            # json.load(resp) / json.loads(body) propagate their
            # argument's root taint through the decode
            return {t for arg in node.args
                    for t in self._taint_of(arg, taints) if t[1] == ""}
        return set()

    # -- reads --------------------------------------------------------------
    def _collect_reads(self, fn: ast.AST,
                       taints: Dict[str, _Taints]) -> None:
        module = self.scan.module
        seen: Set[Tuple[str, str, int]] = set()
        for node in ast.walk(fn):
            key = ep = line = None
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" and node.args:
                a0 = node.args[0]
                base = self._taint_of(node.func.value, taints)
                if len(base) == 1 and isinstance(a0, ast.Constant) \
                        and isinstance(a0.value, str):
                    (bep, pfx), = base
                    ep, key, line = bep, _join(pfx, a0.value), node.lineno
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                base = self._taint_of(node.value, taints)
                if len(base) == 1:
                    (bep, pfx), = base
                    ep, key, line = bep, \
                        _join(pfx, node.slice.value), node.lineno
            if ep is None or key is None:
                continue
            mark = (ep, key, line)
            if mark in seen:
                continue
            seen.add(mark)
            self.reads.append(ConsumerRead(ep, key, module.display,
                                           line, module.is_test))


# ---------------------------------------------------------------------------
# headers

def _resolve_header(node: ast.AST, scan: _ModScan,
                    global_consts: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "lower" and not node.args:
        return _resolve_header(node.func.value, scan, global_consts)
    val = _resolve_str(node, scan, global_consts)
    if val is not None and val.lower().startswith(_HEADER_PREFIX):
        return val
    return None


def _scan_headers(scan: _ModScan, global_consts: Dict[str, str],
                  out: List[HeaderUse]) -> None:
    module = scan.module

    def use(node: ast.AST, role: str, line: int) -> None:
        name = _resolve_header(node, scan, global_consts)
        if name is not None:
            out.append(HeaderUse(name.lower(), name, role,
                                 module.display, line, module.is_test))

    for name, value in scan.str_consts.items():
        if value.lower().startswith(_HEADER_PREFIX):
            out.append(HeaderUse(value.lower(), value, "declare",
                                 module.display, 0, module.is_test))
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Subscript) \
                and not isinstance(node.slice, ast.Slice):
            role = "write" if isinstance(node.ctx, ast.Store) else "read"
            use(node.slice, role, node.lineno)
        elif isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    use(k, "write", getattr(k, "lineno", node.lineno))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) and node.args:
            attr = node.func.attr
            if attr in ("send_header", "add_header", "putheader"):
                use(node.args[0], "write", node.lineno)
            elif attr in ("get", "getheader", "header", "pop",
                          "setdefault"):
                # `.header(NAME)` is the tree's Request accessor
                use(node.args[0], "read", node.lineno)


# ---------------------------------------------------------------------------
# knobs

_ENV_READ_FNS = {"env_int": "int", "env_float": "float"}
_REGISTRY_FNS = {"knob_int": "int", "knob_float": "float",
                 "knob_str": "str", "knob_raw": "raw"}


def _is_environ(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ") \
        or (isinstance(node, ast.Name) and node.id == "environ")


def _fn_leaf(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _scan_knobs(scan: _ModScan, global_consts: Dict[str, str],
                out: List[KnobRead]) -> None:
    module = scan.module

    def knob_name(node: ast.AST) -> Optional[str]:
        val = _resolve_str(node, scan, global_consts)
        if val is not None and _KNOB_RE.match(val):
            return val
        return None

    def default_of(call: ast.Call, idx: int) -> object:
        args = list(call.args)
        for kw in call.keywords:
            if kw.arg in ("default", "fallback"):
                args = args[:idx] + [kw.value]
                break
        if len(args) <= idx:
            return NO_DEFAULT
        node = args[idx]
        if isinstance(node, ast.Constant) and not isinstance(
                node.value, bool):
            return node.value
        num = _fold_number(node)
        if num is not None:
            return num
        if isinstance(node, ast.Name):
            if node.id in scan.num_consts:
                return scan.num_consts[node.id]
            if node.id in scan.str_consts:
                return scan.str_consts[node.id]
        return DYNAMIC_DEFAULT

    for top in ast.walk(module.tree):
        name = via = kind = None
        default: object = NO_DEFAULT
        line = 0
        if isinstance(top, ast.Call):
            leaf = _fn_leaf(top.func)
            if leaf in _ENV_READ_FNS and top.args:
                name = knob_name(top.args[0])
                via, kind = "envutil", _ENV_READ_FNS[leaf]
                default = default_of(top, 1)
            elif leaf in _REGISTRY_FNS and top.args:
                name = knob_name(top.args[0])
                via, kind = "registry", _REGISTRY_FNS[leaf]
                default = default_of(top, 1)
            elif leaf in ("get", "getenv") and top.args:
                recv_ok = (
                    leaf == "getenv"
                    or (isinstance(top.func, ast.Attribute)
                        and _is_environ(top.func.value))
                )
                if recv_ok:
                    name = knob_name(top.args[0])
                    via, kind = "environ", "str"
                    default = default_of(top, 1)
            line = top.lineno
        elif isinstance(top, ast.Subscript) \
                and isinstance(top.ctx, ast.Load) \
                and _is_environ(top.value):
            name = knob_name(top.slice)
            via, kind, line = "environ", "str", top.lineno
        if name is None or via is None:
            continue
        out.append(KnobRead(name, via, kind, default, module.display,
                            line, module.is_test, module.module_name))


# ---------------------------------------------------------------------------
# the extraction pass + inventory dump

def _extract(modules: Sequence[ModuleInfo], ctx: LintContext) -> Contracts:
    scans = [_ModScan(m) for m in modules]
    global_consts: Dict[str, str] = {}
    for s in scans:
        for name, value in s.str_consts.items():
            global_consts.setdefault(f"{s.mod}.{name}", value)
    # re-export propagation: a package facade that `from x import C`s a
    # constant republishes it under its own name (pio_tpu_torch.qos exposes
    # deadline.py's DEADLINE_HEADER), and consumers import through the
    # facade — chase the chains to a fixpoint so they still resolve
    for _ in range(3):
        changed = False
        for s in scans:
            for name, target in s.from_imports.items():
                value = global_consts.get(target)
                key = f"{s.mod}.{name}"
                if value is not None and key not in global_consts:
                    global_consts[key] = value
                    changed = True
        if not changed:
            break

    c = Contracts()

    # producers: marker + route roots, then keys over the call graph
    fn_nodes: Dict[str, ast.AST] = {}
    for s in scans:
        for qual, _cls, fn in s.fns:
            fn_nodes[qual] = fn
    roots: List[ProducerRoot] = []
    for s in scans:
        roots.extend(_marker_roots(s))
        roots.extend(_route_registrations(s))
    analysis = get_analysis(modules, ctx)
    for root in roots:
        c.producers.setdefault(root.endpoint, []).append(root)
        keys = c.keys.setdefault(root.endpoint, set())
        stack, visited = [root.qual], {root.qual}
        while stack:
            qual = stack.pop()
            node = fn_nodes.get(qual)
            if node is not None:
                keys |= _produced_keys(node)
            for callee, _line in analysis.edges.get(qual, ()):
                if callee not in visited:
                    visited.add(callee)
                    stack.append(callee)

    for s in scans:
        consumer = _ConsumerScan(s)
        consumer.run()
        c.reads.extend(consumer.reads)
        _scan_headers(s, global_consts, c.headers)
        _scan_knobs(s, global_consts, c.knob_reads)
    return c


def _default_json(value: object) -> object:
    if value is NO_DEFAULT:
        return None
    if value is DYNAMIC_DEFAULT:
        return "<dynamic>"
    return value


def contracts_inventory(modules: Sequence[ModuleInfo],
                        ctx: LintContext) -> dict:
    """The ``pio lint --dump-contracts`` payload: endpoints with their
    producer roots / produced keys / consumer reads, header flows, and
    the knob inventory joined against the canonical registry."""
    c = get_contracts(modules, ctx)
    endpoints = {}
    for ep in sorted(set(c.producers) | {r.endpoint for r in c.reads}):
        endpoints[ep] = {
            "producers": [
                {"function": p.qual, "file": p.path, "line": p.line}
                for p in sorted(c.producers.get(ep, ()),
                                key=lambda p: (p.path, p.line))
            ],
            "keys": sorted(c.keys.get(ep, ())),
            "consumers": [
                {"key": r.key, "file": r.path, "line": r.line}
                for r in sorted((r for r in c.reads if r.endpoint == ep),
                                key=lambda r: (r.path, r.line, r.key))
            ],
        }
    headers: Dict[str, dict] = {}
    for h in c.headers:
        entry = headers.setdefault(
            h.header, {"canonical": h.canonical, "produced": [],
                       "consumed": [], "declared": []})
        bucket = {"write": "produced", "read": "consumed",
                  "declare": "declared"}[h.role]
        entry[bucket].append({"file": h.path, "line": h.line})
    knobs: Dict[str, dict] = {}
    registry = ctx.knob_registry
    for site in c.knob_reads:
        entry = knobs.setdefault(site.name, {"sites": []})
        entry["sites"].append({
            "file": site.path, "line": site.line, "via": site.via,
            "kind": site.kind, "default": _default_json(site.default),
        })
    for name, knob in registry.items():
        entry = knobs.setdefault(name, {"sites": []})
        entry.update({
            "kind": knob.kind, "default": knob.default,
            "positive": knob.positive, "doc": knob.doc,
        })
    for entry in knobs.values():
        entry["sites"].sort(key=lambda s: (s["file"], s["line"]))
    return {
        "endpoints": endpoints,
        "headers": {k: headers[k] for k in sorted(headers)},
        "knobs": {k: knobs[k] for k in sorted(knobs)},
    }
