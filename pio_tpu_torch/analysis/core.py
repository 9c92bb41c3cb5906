"""Checker framework behind ``pio lint``: file collection, the rule
registry, per-line suppressions, and the ``run_lint`` entry point.

Rules come in two shapes. A *module rule* inspects one parsed file at a
time (``check(module, ctx)``); a *project rule* sees every parsed file
at once (``check_project(modules, ctx)``) — that is how cross-module
properties (lock-order cycles, failpoint uniqueness) are checked.

Suppressions are comments, checked per finding line::

    time.time()  # pio: disable=wallclock-duration
    # pio: disable=lock-blocking-call   <- alone on a line: covers the
    conn.commit()                          line immediately below
    # pio: disable-file=metric-name     <- anywhere: whole file

Suppression comments are read from the token stream (not regexed out of
raw source), so a string literal that merely *contains* the marker text
never suppresses anything.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

_SUPPRESS_RE = re.compile(
    r"#\s*pio:\s*disable(?P<whole_file>-file)?=(?P<rules>[A-Za-z0-9_,\- ]+)"
)

#: analysis markers, same comment grammar as suppressions:
#:   # pio: hotpath                  <- function is a hot-path root
#:   # pio: hotpath=zerocopy         <- additionally no JSON / bytes copies
#:   # pio: frame=lane-slot          <- struct call site belongs to a frame
#:   # pio: endpoint=/fleet.json     <- function builds this endpoint's payload
#:   # pio: consumes=/fleet.json     <- function parses this endpoint's payload
#: A marker alone on its line covers the line below it (so a def whose
#: signature spans lines can carry the marker above itself).
_MARKER_RE = re.compile(
    r"#\s*pio:\s*(?P<kind>hotpath|frame|endpoint|consumes)"
    r"(?:=(?P<value>[A-Za-z0-9_./\-]+))?"
)

#: directories never descended into when a lint path is a directory
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


@dataclass(frozen=True)
class Finding:
    """One lint diagnostic, pointing at ``path:line``."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


@dataclass
class ModuleInfo:
    """One parsed source file plus everything rules need to know about it."""

    path: str                      # absolute path on disk
    display: str                   # path as reported in findings
    source: str
    tree: ast.Module
    is_test: bool                  # under tests/ or named test_*/conftest
    module_name: str               # dotted name ("pio_tpu_torch.qos.gate" / "a")
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    file_suppressions: Set[str] = field(default_factory=set)
    #: line -> "" (plain hotpath) | "zerocopy"  (`# pio: hotpath[=...]`)
    hotpath_markers: Dict[int, str] = field(default_factory=dict)
    #: line -> frame family name  (`# pio: frame=<family>`)
    frame_markers: Dict[int, str] = field(default_factory=dict)
    #: line -> endpoint path  (`# pio: endpoint=/fleet.json`)
    endpoint_markers: Dict[int, str] = field(default_factory=dict)
    #: line -> endpoint path  (`# pio: consumes=/fleet.json`)
    consumes_markers: Dict[int, str] = field(default_factory=dict)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppressions:
            return True
        rules = self.suppressions.get(line)
        return bool(rules) and rule in rules

    def suppressed_at_any(self, rule: str, lines: Iterable[int]) -> bool:
        """True when any of ``lines`` carries a disable for ``rule`` —
        how project rules honor a disable placed on a root function's
        def/marker line rather than on the finding's own line."""
        return any(self.suppressed(rule, ln) for ln in lines)


class LintContext:
    """Shared, lazily-populated state handed to every rule."""

    def __init__(self, repo_root: Optional[str] = None,
                 catalog: Optional[Set[str]] = None,
                 knob_registry: Optional[Dict[str, object]] = None):
        self.repo_root = repo_root or _default_repo_root()
        self._catalog = catalog
        self._catalog_loaded = catalog is not None
        self._catalog_kinds: Optional[Dict[str, str]] = None
        # an injected catalog (tests) has no type info: skip kind checks
        self._catalog_kinds_loaded = catalog is not None
        self._knob_registry = knob_registry

    @property
    def knob_registry(self) -> Dict[str, object]:
        """Canonical knob declarations (name -> :class:`~pio_tpu_torch.utils.
        knobs.Knob`). The in-tree registry by default; tests inject a
        synthetic one to lint fixtures against it."""
        if self._knob_registry is None:
            from pio_tpu_torch.utils.knobs import KNOBS
            self._knob_registry = dict(KNOBS)
        return self._knob_registry

    @property
    def metric_catalog(self) -> Optional[Set[str]]:
        """Metric names documented in ``docs/observability.md`` (the
        backticked ``pio_tpu_*`` tokens), or ``None`` when the doc is
        not present (catalog agreement is then skipped)."""
        if not self._catalog_loaded:
            self._catalog = _load_catalog(self.repo_root)
            self._catalog_loaded = True
        return self._catalog

    @property
    def metric_catalog_kinds(self) -> Optional[Dict[str, str]]:
        """Documented metric type per catalog name, parsed from the
        ``| `name` | type | ...`` table rows of docs/observability.md —
        lets the metric-name rule flag a registration whose kind
        disagrees with its documented row (e.g. a counter documented as
        a gauge), not just an undocumented name. ``None`` when the doc
        is absent."""
        if not self._catalog_kinds_loaded:
            self._catalog_kinds = _load_catalog_kinds(self.repo_root)
            self._catalog_kinds_loaded = True
        return self._catalog_kinds


class Rule:
    """Base class for module rules. Subclasses set the class attrs and
    implement :meth:`check`."""

    id: str = ""
    family: str = ""               # "concurrency" | "convention"
    description: str = ""
    #: convention rules about production registrations/call sites skip
    #: test files (tests register scratch metrics, seed failpoints, and
    #: poke os.environ on purpose); concurrency rules apply everywhere
    skip_tests: bool = False

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        raise NotImplementedError


class ProjectRule(Rule):
    """Rule that needs the whole file set at once."""

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        return ()

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        raise NotImplementedError


_RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and index the rule by its id."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _RULES:
        raise ValueError(f"duplicate rule id {inst.id!r}")
    _RULES[inst.id] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    _load_rule_modules()
    return dict(_RULES)


def _load_rule_modules() -> None:
    # deferred so core can be imported by the rule modules themselves
    from pio_tpu_torch.analysis import effects  # noqa: F401
    from pio_tpu_torch.analysis import lockgraph  # noqa: F401
    from pio_tpu_torch.analysis import rules_concurrency  # noqa: F401
    from pio_tpu_torch.analysis import rules_contracts  # noqa: F401
    from pio_tpu_torch.analysis import rules_convention  # noqa: F401


def _default_repo_root() -> str:
    # pio_tpu_torch/analysis/core.py -> repo root two levels above the package
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_paths(repo_root: Optional[str] = None) -> List[str]:
    """What ``pio lint`` lints with no paths: the port's package and the
    port's tests (``tests/test_torch_*.py`` and their helpers
    ``tests/torch_*.py``). The reference's tests are left out: their reads
    of the reference's payloads are not consumers of the port's
    producers."""
    root = repo_root or _default_repo_root()
    tests = os.path.join(root, "tests")
    port_tests = sorted(
        os.path.join(tests, n) for n in (
            os.listdir(tests) if os.path.isdir(tests) else ()
        )
        if n.endswith(".py") and n.startswith(("test_torch_", "torch_"))
    )
    return [os.path.join(root, "pio_tpu_torch")] + port_tests


def _load_catalog(repo_root: str) -> Optional[Set[str]]:
    doc = os.path.join(repo_root, "docs", "observability.md")
    try:
        with open(doc, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return None
    return set(re.findall(r"`(pio_tpu_[a-z0-9_]+)`", text))


#: catalog table row: ``| `pio_tpu_x` | counter | ... |`` — first two
#: cells are the name and the documented type
_CATALOG_ROW_RE = re.compile(
    r"^\|\s*`(pio_tpu_[a-z0-9_]+)`\s*\|\s*([a-z]+)\s*\|", re.MULTILINE
)


def _load_catalog_kinds(repo_root: str) -> Optional[Dict[str, str]]:
    doc = os.path.join(repo_root, "docs", "observability.md")
    try:
        with open(doc, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return None
    return dict(_CATALOG_ROW_RE.findall(text))


def _is_test_path(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    base = os.path.basename(path)
    return (
        "tests" in parts
        or base.startswith("test_")
        or base == "conftest.py"
    )


def _module_name(path: str) -> str:
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    stem = os.path.splitext(parts[-1])[0]
    if "pio_tpu_torch" in parts:
        i = parts.index("pio_tpu_torch")
        dotted = parts[i:-1] + ([] if stem == "__init__" else [stem])
        return ".".join(dotted)
    return stem


def _collect_suppressions(source: str):
    per_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    hotpath: Dict[int, str] = {}
    frames: Dict[int, str] = {}
    endpoints: Dict[int, str] = {}
    consumes: Dict[int, str] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            alone = tok.line[:tok.start[1]].strip() == ""
            line = tok.start[0]
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                rules = {
                    r.strip() for r in m.group("rules").split(",") if r.strip()
                }
                if m.group("whole_file"):
                    whole_file |= rules
                    continue
                per_line.setdefault(line, set()).update(rules)
                # a comment alone on its line covers the line below it
                if alone:
                    per_line.setdefault(line + 1, set()).update(rules)
                continue
            m = _MARKER_RE.search(tok.string)
            if not m:
                continue
            kind, value = m.group("kind"), m.group("value") or ""
            if kind == "hotpath":
                hotpath[line] = value
                if alone:
                    hotpath.setdefault(line + 1, value)
            elif kind == "frame" and value:
                frames[line] = value
                if alone:
                    frames.setdefault(line + 1, value)
            elif kind == "endpoint" and value:
                endpoints[line] = value
                if alone:
                    endpoints.setdefault(line + 1, value)
            elif kind == "consumes" and value:
                consumes[line] = value
                if alone:
                    consumes.setdefault(line + 1, value)
    except tokenize.TokenError:
        pass
    return per_line, whole_file, hotpath, frames, endpoints, consumes


def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand the lint targets into a sorted, de-duplicated .py list."""
    out: List[str] = []
    seen: Set[str] = set()
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in _SKIP_DIRS and not d.startswith(".")
                )
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        full = os.path.join(dirpath, name)
                        if full not in seen:
                            seen.add(full)
                            out.append(full)
        elif p.endswith(".py"):
            full = p
            if full not in seen:
                seen.add(full)
                out.append(full)
    return out


def parse_module(path: str, display: Optional[str] = None
                 ) -> "ModuleInfo | Finding":
    """Parse one file; returns a ``parse-error`` Finding on bad syntax."""
    display = display or _display_path(path)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return Finding("parse-error", display, exc.lineno or 0,
                       exc.offset or 0, f"syntax error: {exc.msg}")
    except OSError as exc:
        return Finding("parse-error", display, 0, 0, f"unreadable: {exc}")
    (per_line, whole_file, hotpath, frames,
     endpoints, consumes) = _collect_suppressions(source)
    return ModuleInfo(
        path=os.path.abspath(path),
        display=display,
        source=source,
        tree=tree,
        is_test=_is_test_path(path),
        module_name=_module_name(path),
        suppressions=per_line,
        file_suppressions=whole_file,
        hotpath_markers=hotpath,
        frame_markers=frames,
        endpoint_markers=endpoints,
        consumes_markers=consumes,
    )


def _display_path(path: str) -> str:
    ap = os.path.abspath(path)
    cwd = os.getcwd()
    if ap.startswith(cwd + os.sep):
        return os.path.relpath(ap, cwd)
    return path


def run_lint(paths: Sequence[str],
             rule_ids: Optional[Sequence[str]] = None,
             catalog: Optional[Set[str]] = None,
             repo_root: Optional[str] = None,
             only: Optional[Sequence[str]] = None,
             knob_registry: Optional[Dict[str, object]] = None
             ) -> List[Finding]:
    """Lint ``paths`` and return the surviving (unsuppressed) findings,
    sorted by file/line. ``rule_ids`` restricts to a subset of rules;
    ``catalog`` overrides the docs/observability.md metric catalog
    (tests use this to lint fixtures against a synthetic catalog).
    ``only`` (absolute or display paths) keeps findings from just those
    files while every file in ``paths`` still feeds project context —
    the ``pio lint --changed`` fast path: call graphs and frame
    families are built whole-tree, findings are reported per-diff."""
    rules = all_rules()
    if rule_ids is not None:
        unknown = set(rule_ids) - set(rules)
        if unknown:
            raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
        rules = {rid: rules[rid] for rid in rule_ids}
    ctx = LintContext(repo_root=repo_root, catalog=catalog,
                      knob_registry=knob_registry)

    modules: List[ModuleInfo] = []
    findings: List[Finding] = []
    for path in collect_files(paths):
        parsed = parse_module(path)
        if isinstance(parsed, Finding):
            findings.append(parsed)
        else:
            modules.append(parsed)

    mod_by_path = {m.display: m for m in modules}
    for rule in rules.values():
        if isinstance(rule, ProjectRule):
            findings.extend(rule.check_project(modules, ctx))
        else:
            for m in modules:
                if rule.skip_tests and m.is_test:
                    continue
                findings.extend(rule.check(m, ctx))

    focus: Optional[Set[str]] = None
    if only is not None:
        focus = set()
        for p in only:
            focus.add(p)
            focus.add(os.path.abspath(p))

    kept = []
    for f in findings:
        m = mod_by_path.get(f.path)
        if m is not None and m.suppressed(f.rule, f.line):
            continue
        if focus is not None:
            fp = m.path if m is not None else os.path.abspath(f.path)
            if f.path not in focus and fp not in focus:
                continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def render_text(findings: Sequence[Finding]) -> str:
    if not findings:
        return "pio lint: clean"
    lines = [f.render() for f in findings]
    lines.append(f"pio lint: {len(findings)} finding(s)")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    return json.dumps(
        {"findings": [f.to_dict() for f in findings],
         "count": len(findings)},
        indent=2, sort_keys=True,
    )
