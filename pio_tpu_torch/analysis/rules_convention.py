"""Convention rules: metric naming/catalog agreement, failpoint
uniqueness + namespaces, hardened env parsing, the one-clock rule, and
the span-name convention.

These encode project conventions that no general-purpose linter knows:

* every registered metric is ``pio_tpu_*``, counters end ``_total``,
  and the name appears in the catalog in ``docs/observability.md``;
* every ``failpoint("…")`` call-site name is unique and lives in a
  documented namespace (the same inventory backs
  ``pio lint --dump-failpoints``);
* numeric env knobs go through ``pio_tpu_torch.utils.envutil`` (warn +
  default on garbage) instead of ``float(os.environ.get(...))``;
* durations are measured with ``pio_tpu_torch.obs.monotonic_s`` — raw
  ``time.time()`` / ``time.monotonic()`` calls are flagged (suppress
  the rare true wall-clock use, e.g. an HTTP Date header);
* trace span/stage names are dot-scoped ``stage`` / ``stage.substage``
  atoms of ``[a-z0-9_]`` — the /debug/hotpath.json budget math keys on
  exactly this shape (top-level stages tile; dotted substages nest).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Tuple

from pio_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    ModuleInfo,
    ProjectRule,
    Rule,
    register,
)
from pio_tpu_torch.analysis.locks import unparse

# ---------------------------------------------------------------------------
# rule: metric naming + catalog agreement

_METRIC_METHODS = ("counter", "gauge", "histogram")
_METRIC_NAME_RE = re.compile(r"^pio_tpu_[a-z0-9_]+$")


@register
class MetricNameRule(Rule):
    id = "metric-name"
    family = "convention"
    skip_tests = True
    description = (
        "Registered metric names must match pio_tpu_[a-z0-9_]+, "
        "counters must end _total (gauges/histograms must not), and "
        "the name must appear in the docs/observability.md catalog."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        catalog = ctx.metric_catalog
        kinds = ctx.metric_catalog_kinds
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_METHODS
                    and len(node.args) >= 2):
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue  # dynamic names are out of scope
            name = first.value
            kind = node.func.attr
            msg = self._bad(name, kind, catalog, kinds)
            if msg:
                yield Finding(self.id, module.display, node.lineno,
                              node.col_offset, msg)

    @staticmethod
    def _bad(name: str, kind: str, catalog,
             kinds: Optional[Dict[str, str]] = None) -> Optional[str]:
        if not _METRIC_NAME_RE.match(name):
            return (f"metric `{name}` must match pio_tpu_[a-z0-9_]+ "
                    f"(project namespace prefix)")
        if kind == "counter" and not name.endswith("_total"):
            return f"counter `{name}` must end with `_total`"
        if kind != "counter" and name.endswith("_total"):
            return (f"{kind} `{name}` must not end with `_total` "
                    f"(reserved for counters)")
        if catalog is not None and name not in catalog:
            return (f"metric `{name}` is not in the docs/observability.md "
                    f"catalog; add a row (or fix the name)")
        # kind agreement with the catalog's Type column: a name whose row
        # documents a different type is a doc/code drift bug (names only
        # mentioned in prose, with no table row, are skipped)
        if kinds is not None:
            doc_kind = kinds.get(name)
            if doc_kind is not None and doc_kind != kind:
                return (f"{kind} `{name}` is documented as `{doc_kind}` in "
                        f"the docs/observability.md catalog; fix the row "
                        f"or the registration")
        return None


# ---------------------------------------------------------------------------
# rule: failpoint names — unique, namespaced; powers --dump-failpoints

#: documented failpoint namespaces (see docs/engine-development.md);
#: a call-site name must start with one of these prefixes
FAILPOINT_NAMESPACES = (
    "eventlog.",
    "storage.",
    "groupcommit.",
    "scorer.",
    # device-resident serving sub-namespaces (subsumed by "scorer." but
    # listed so --dump-failpoints readers see them as first-class)
    "scorer.h2d.",
    "scorer.donate.",
    "worker.",
    "batchlane.",
    # partitioned event log + its replication protocol
    "partlog.",
    "repl.",
    # mesh-sharded placement + shard-manifest reassembly
    "shard.",
    # streamed training feed executor (parallel/stream.py)
    "stream.",
    # training telemetry plane (obs/trainwatch.py)
    "trainwatch.",
    # device telemetry plane (obs/devicewatch.py)
    "devicewatch.",
    # serving fabric front tier (router/)
    "router.",
    # progressive-delivery rollout controller (router/rollout.py)
    "rollout.",
)


def _failpoint_name(call: ast.Call) -> Optional[Tuple[str, bool]]:
    """``failpoint(...)`` first arg → (name_or_static_prefix, dynamic)."""
    fn = call.func
    fname = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    if fname != "failpoint" or not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        prefix = ""
        for part in arg.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                prefix += part.value
            else:
                break
        return prefix, True
    return None


def failpoint_inventory(modules: List[ModuleInfo]) -> List[dict]:
    """Machine-readable inventory of every failpoint call site in
    non-test modules: ``{point, dynamic, file, line}`` sorted by name.
    Dynamic (f-string) sites report their static prefix."""
    out: List[dict] = []
    for m in modules:
        if m.is_test:
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            named = _failpoint_name(node)
            if named is None:
                continue
            point, dynamic = named
            out.append({
                "point": point,
                "dynamic": dynamic,
                "file": m.display,
                "line": node.lineno,
            })
    out.sort(key=lambda d: (d["point"], d["file"], d["line"]))
    return out


@register
class FailpointNameRule(ProjectRule):
    id = "failpoint-name"
    family = "convention"
    skip_tests = True
    description = (
        "failpoint() call-site names must be globally unique and start "
        "with a documented namespace (eventlog./storage./groupcommit./"
        "scorer./worker.); chaos specs target points by name, so a "
        "duplicate makes two distinct sites indistinguishable."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        inventory = failpoint_inventory(modules)
        by_name: Dict[str, List[dict]] = {}
        for entry in inventory:
            ns_ok = any(entry["point"].startswith(ns)
                        for ns in FAILPOINT_NAMESPACES)
            if not ns_ok:
                yield Finding(
                    self.id, entry["file"], entry["line"], 0,
                    f"failpoint `{entry['point']}` is outside the "
                    f"documented namespaces "
                    f"({', '.join(FAILPOINT_NAMESPACES)})",
                )
            if not entry["dynamic"]:
                by_name.setdefault(entry["point"], []).append(entry)
        for name, sites in sorted(by_name.items()):
            if len(sites) < 2:
                continue
            first = sites[0]
            for s in sites[1:]:
                yield Finding(
                    self.id, s["file"], s["line"], 0,
                    f"failpoint `{name}` duplicates "
                    f"{first['file']}:{first['line']}; chaos specs can't "
                    f"target one site — rename (e.g. `{name}.<variant>`)",
                )


# ---------------------------------------------------------------------------
# rule: hardened env parsing

@register
class EnvHardeningRule(Rule):
    id = "env-hardening"
    family = "convention"
    skip_tests = True
    description = (
        "int()/float() directly over os.environ reads crashes the "
        "process on a garbled knob; use pio_tpu_torch.utils.envutil.env_int/"
        "env_float (warn + default on garbage)."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        if module.module_name == "pio_tpu_torch.utils.envutil":
            return  # the helpers themselves
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in ("int", "float")
                    and node.args):
                continue
            inner = node.args[0]
            if self._is_environ_read(inner):
                yield Finding(
                    self.id, module.display, node.lineno, node.col_offset,
                    f"`{node.func.id}({unparse(inner)})` raises on a "
                    f"garbled env value; use pio_tpu_torch.utils.envutil."
                    f"env_{node.func.id}(name, default) instead",
                )

    @staticmethod
    def _is_environ_read(node: ast.expr) -> bool:
        # os.environ.get(...) / os.environ[...] / environ.get(...)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr != "get":
                return False
            node = node.func.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            return False
        text = unparse(node)
        return text in ("os.environ", "environ")


# ---------------------------------------------------------------------------
# rule: one duration clock

@register
class WallclockDurationRule(Rule):
    id = "wallclock-duration"
    family = "convention"
    description = (
        "Durations are measured with pio_tpu_torch.obs.monotonic_s — the one "
        "project clock (time.perf_counter). time.time() jumps with NTP "
        "and time.monotonic() forks the clock domain; suppress only "
        "true wall-clock uses (Date headers, log timestamps)."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("time", "monotonic")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "time"):
                continue
            yield Finding(
                self.id, module.display, node.lineno, node.col_offset,
                f"`time.{node.func.attr}()`: use pio_tpu_torch.obs.monotonic_s "
                f"for durations (suppress if this is a true wall-clock "
                f"read)",
            )


# ---------------------------------------------------------------------------
# rule: span-name convention

_SPAN_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")
#: span-recording entry points whose first positional arg is a name
_SPAN_METHODS = ("span", "add_span", "add_active_span")


@register
class SpanNameRule(Rule):
    id = "span-name"
    family = "convention"
    skip_tests = True
    description = (
        "Trace span/stage names must be dot-scoped [a-z0-9_] atoms "
        "(`stage` or `stage.substage`) — /debug/hotpath.json budget "
        "math treats undotted names as tiling top-level stages and "
        "dotted ones as nested substages, so a stray name silently "
        "corrupts the attribution sums. Checked at .span()/.add_span()/"
        "add_active_span() literal call sites and *_STAGES/*_SUBSTAGES "
        "tuple declarations."
    )

    def check(self, module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                fname = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None)
                if fname not in _SPAN_METHODS or not node.args:
                    continue
                arg = node.args[0]
                if (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)
                        and not _SPAN_NAME_RE.match(arg.value)):
                    yield Finding(
                        self.id, module.display, node.lineno,
                        node.col_offset,
                        f"span name `{arg.value}` breaks the "
                        f"`stage.substage` convention "
                        f"([a-z0-9_] atoms joined by dots)",
                    )
            elif isinstance(node, ast.Assign):
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
                if not any(n.endswith(("_STAGES", "_SUBSTAGES"))
                           for n in names):
                    continue
                if not isinstance(node.value, ast.Tuple):
                    continue
                for elt in node.value.elts:
                    if (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)
                            and not _SPAN_NAME_RE.match(elt.value)):
                        yield Finding(
                            self.id, module.display, elt.lineno,
                            elt.col_offset,
                            f"declared stage `{elt.value}` breaks the "
                            f"`stage.substage` convention "
                            f"([a-z0-9_] atoms joined by dots)",
                        )


# ---------------------------------------------------------------------------
# rule: metric catalog drift (fleet/replication families)

#: high-churn metric namespaces whose docs/observability.md rows must
#: have a live registration (or collector emission) in the source set —
#: a row surviving a family rename/removal would document a phantom
_CATALOG_DRIFT_PREFIXES = ("pio_tpu_fleet_", "pio_tpu_repl_",
                           "pio_tpu_train_", "pio_tpu_device_",
                           "pio_tpu_xla_", "pio_tpu_router_",
                           "pio_tpu_rollout_")

_CATALOG_ROW_RE = re.compile(r"^\|\s*`(pio_tpu_[a-z0-9_]+)`\s*\|")


@register
class MetricCatalogDriftRule(ProjectRule):
    id = "metric-catalog-drift"
    family = "convention"
    description = (
        "Every documented pio_tpu_fleet_*/pio_tpu_repl_*/pio_tpu_train_* "
        "catalog row in "
        "docs/observability.md must correspond to a live registration "
        "or collector emission in the linted sources (the inverse of "
        "metric-name: code->doc there, doc->code here)."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        # only meaningful against the real tree: fixture subsets (the
        # lint rule tests) and partial runs would see phantom drift
        if not any(m.module_name == "pio_tpu_torch.obs.fleet" for m in modules):
            return
        import os as _os

        doc = _os.path.join(ctx.repo_root, "docs", "observability.md")
        try:
            with open(doc, "r", encoding="utf-8") as fh:
                doc_lines = fh.readlines()
        except OSError:
            return
        emitted = self._emitted_names(modules)
        for lineno, line in enumerate(doc_lines, 1):
            mm = _CATALOG_ROW_RE.match(line.strip())
            if not mm:
                continue
            name = mm.group(1)
            if not name.startswith(_CATALOG_DRIFT_PREFIXES):
                continue
            if name not in emitted:
                yield Finding(
                    self.id, _os.path.join("docs", "observability.md"),
                    lineno, 0,
                    f"catalog row `{name}` has no registration or "
                    f"emission in the linted sources — remove the row "
                    f"or restore the family",
                )

    @staticmethod
    def _emitted_names(modules: List[ModuleInfo]) -> set:
        """Metric names the code can actually expose: first args of
        counter/gauge/histogram registrations plus any pio_tpu_* token
        inside a string literal (collector-emitted families render
        their exposition lines from literals)."""
        out: set = set()
        for m in modules:
            for node in ast.walk(m.tree):
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)):
                    continue
                out.update(re.findall(
                    r"(pio_tpu_[a-z0-9_]+)", node.value
                ))
        return out
