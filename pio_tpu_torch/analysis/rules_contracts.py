"""Contract-drift rules: the cross-process JSON/header/knob surfaces
extracted by :mod:`pio_tpu_torch.analysis.contracts` must agree end to end.

These close the silent-failure class the distributed planes opened: a
producer renames ``worstBurn`` and the router's shed logic quietly reads
``None`` forever; two modules read the same env knob with different
defaults and behave differently in the same process tree; a failpoint
nobody arms bit-rots until the day it matters.

Rules (family ``contracts``):

* ``endpoint-drift`` — a consumer reads a payload key no producer of
  that endpoint writes (with producer file + nearest-key suggestion).
* ``header-drift`` — an ``X-Pio-*`` header is consumed but never
  produced anywhere, or produced but never consumed (tests count as
  consumers — an assertion is a contract).
* ``knob-default-drift`` — a literal ``PIO_TPU_*`` read bypasses the
  canonical registry (:mod:`pio_tpu_torch.utils.knobs`), disagrees with its
  declared default/kind, or reads a name the registry never declared.
* ``knob-doc-drift`` — the registry and the ``pio_tpu_torch/KNOBS.md``
  knob table must match both ways, defaults included.
* ``failpoint-coverage`` — every registered failpoint must be armed by
  at least one test or a scripts/smoke.sh chaos spec (suppressible
  with justification where coverage is genuinely impossible).
"""

from __future__ import annotations

import ast
import difflib
import os
import re
from typing import Dict, Iterable, List, Set, Tuple

from pio_tpu_torch.analysis.contracts import (
    DYNAMIC_DEFAULT,
    NO_DEFAULT,
    get_contracts,
)
from pio_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    ModuleInfo,
    ProjectRule,
    register,
)

#: modules allowed to touch env primitives directly: the registry and
#: the parse helpers it delegates to
_KNOB_EXEMPT_MODULES = {"pio_tpu_torch.utils.knobs",
                        "pio_tpu_torch.utils.envutil"}


@register
class EndpointDriftRule(ProjectRule):
    id = "endpoint-drift"
    family = "contracts"
    description = (
        "A consumer reads a JSON payload key that no producer of that "
        "endpoint writes. Producers are payload builders carrying a "
        "`# pio: endpoint=/x.json` marker (plus route-registration "
        "handlers); consumer chains are tracked through fetch literals, "
        "`# pio: consumes=` markers, and scrape-loop attribute stores."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        c = get_contracts(modules, ctx)
        seen: Set[Tuple[str, str, int]] = set()
        for read in c.reads:
            producers = c.producers.get(read.endpoint)
            if not producers:
                # endpoint not built by anything in the linted set
                # (partial lint / member endpoint of another process
                # class) — nothing to check against
                continue
            keys = c.keys.get(read.endpoint, set())
            missing = next(
                (seg for seg in read.key.split(".") if seg not in keys),
                None,
            )
            if missing is None or "*" in keys:
                # "*": a producer builds a dynamic map (breaker names,
                # burn windows) — unknown segments get the benefit of
                # the doubt for this endpoint
                continue
            mark = (read.path, read.key, read.line)
            if mark in seen:
                continue
            seen.add(mark)
            prod = producers[0]
            hint = difflib.get_close_matches(missing, sorted(keys), n=1)
            suggestion = f"; closest produced key: {hint[0]!r}" \
                if hint else ""
            yield Finding(
                self.id, read.path, read.line, 0,
                f"reads {read.key!r} from {read.endpoint} but no "
                f"producer writes {missing!r} (producer: {prod.qual} "
                f"at {prod.path}:{prod.line}){suggestion}",
            )


@register
class HeaderDriftRule(ProjectRule):
    id = "header-drift"
    family = "contracts"
    description = (
        "X-Pio-* request/response headers must be both produced and "
        "consumed somewhere in the linted set — a header only written "
        "is dead weight on every response, a header only read is a "
        "contract nobody fulfils. Tests count as consumers."
    )

    #: forwarding allow-list: `forward_headers` copies the whole
    #: ``X-Pio-*`` prefix, so producing for downstream hops is not
    #: itself consumption
    _sentinel = "pio_tpu_torch.obs.tracing"

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        names = {m.module_name for m in modules}
        # partial runs over a slice of the real tree would see phantom
        # one-sided headers; fixture sets (no pio_tpu.* modules) still
        # exercise the rule
        if any(n.startswith("pio_tpu_torch.") for n in names) \
                and self._sentinel not in names:
            return
        c = get_contracts(modules, ctx)
        produced = {h.header for h in c.headers if h.role == "write"}
        consumed = {h.header for h in c.headers if h.role == "read"}
        for h in c.headers:
            if h.role == "read" and h.header not in produced:
                yield Finding(
                    self.id, h.path, h.line, 0,
                    f"header {h.canonical!r} is consumed here but never "
                    f"produced anywhere in the linted set",
                )
            elif h.role == "write" and h.header not in consumed:
                yield Finding(
                    self.id, h.path, h.line, 0,
                    f"header {h.canonical!r} is produced here but never "
                    f"consumed anywhere in the linted set (tests count)",
                )


def _fmt_default(value: object) -> str:
    if value is NO_DEFAULT:
        return "<none>"
    if value is DYNAMIC_DEFAULT:
        return "<dynamic>"
    return repr(value)


@register
class KnobDefaultDriftRule(ProjectRule):
    id = "knob-default-drift"
    family = "contracts"
    description = (
        "Every literal PIO_TPU_* env read must go through the canonical "
        "knob registry (pio_tpu_torch.utils.knobs) — direct os.environ / "
        "env_int reads bypass the single declared default, and a "
        "bypassing site whose inline default disagrees with the "
        "registry is exactly the multi-module drift this rule exists "
        "to kill."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        registry = ctx.knob_registry
        c = get_contracts(modules, ctx)
        for site in c.knob_reads:
            if site.is_test or site.module_name in _KNOB_EXEMPT_MODULES:
                continue
            knob = registry.get(site.name)
            if site.via == "registry":
                if knob is None:
                    yield Finding(
                        self.id, site.path, site.line, 0,
                        f"knob_{site.kind}({site.name!r}) reads a knob "
                        f"the registry never declared — add it to "
                        f"pio_tpu_torch/utils/knobs.py",
                    )
                elif site.kind not in ("raw", knob.kind):
                    yield Finding(
                        self.id, site.path, site.line, 0,
                        f"{site.name} is declared {knob.kind} but read "
                        f"as {site.kind} here",
                    )
                continue
            if knob is None:
                yield Finding(
                    self.id, site.path, site.line, 0,
                    f"undeclared knob {site.name} read via "
                    f"{site.via} — declare it in pio_tpu_torch/utils/knobs.py "
                    f"and read it through knob_int/knob_float/knob_str",
                )
                continue
            detail = ""
            if site.default not in (NO_DEFAULT, DYNAMIC_DEFAULT) \
                    and site.default != knob.default:
                detail = (
                    f" and its inline default "
                    f"{_fmt_default(site.default)} disagrees with the "
                    f"declared default {knob.default!r}"
                )
            elif site.kind not in ("raw", "str", knob.kind):
                detail = (
                    f" and parses it as {site.kind} against the "
                    f"declared kind {knob.kind}"
                )
            yield Finding(
                self.id, site.path, site.line, 0,
                f"{site.name} read via {site.via} bypasses the knob "
                f"registry (use knobs.knob_{knob.kind}"
                f"({site.name!r})){detail}",
            )


#: the port's knob table, relative to the repo root (the reference's
#: docs/operations.md documents the reference's knobs, not the port's)
KNOB_DOC = ("pio_tpu_torch", "KNOBS.md")

#: docs table row: ``| `PIO_TPU_X` | kind | `default` | doc |``
_DOC_ROW_RE = re.compile(
    r"^\|\s*`(?P<name>PIO_TPU_[A-Z0-9_]+)`\s*\|\s*(?P<kind>[a-z]+)\s*\|"
    r"\s*`(?P<default>[^`]*)`\s*\|"
)


@register
class KnobDocDriftRule(ProjectRule):
    id = "knob-doc-drift"
    family = "contracts"
    description = (
        "The generated knob table in pio_tpu_torch/KNOBS.md must "
        "match the registry both ways: every declared knob documented, "
        "every documented row declared, kind and default cells "
        "agreeing. Regenerate with `python -m pio_tpu_torch.utils.knobs`."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        doc = os.path.join(ctx.repo_root, *KNOB_DOC)
        try:
            with open(doc, "r", encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except OSError:
            return                 # no doc, no contract to keep
        display = os.path.join(*KNOB_DOC)
        rows: Dict[str, Tuple[int, str, str]] = {}
        for i, line in enumerate(lines, start=1):
            m = _DOC_ROW_RE.match(line.strip())
            if m:
                rows[m.group("name")] = (i, m.group("kind"),
                                         m.group("default"))
        registry = ctx.knob_registry
        for name in sorted(set(registry) - set(rows)):
            yield Finding(
                self.id, display, 0, 0,
                f"knob {name} is declared in the registry but missing "
                f"from the {display} knob table — regenerate "
                f"it with `python -m pio_tpu_torch.utils.knobs`",
            )
        for name in sorted(set(rows) - set(registry)):
            line, _kind, _default = rows[name]
            yield Finding(
                self.id, display, line, 0,
                f"documented knob {name} does not exist in the "
                f"registry — stale row, or the declaration was removed",
            )
        for name in sorted(set(rows) & set(registry)):
            line, kind, default = rows[name]
            knob = registry[name]
            if kind != knob.kind:
                yield Finding(
                    self.id, display, line, 0,
                    f"{name} documented as {kind} but declared "
                    f"{knob.kind}",
                )
            elif default != knob.default_repr():
                yield Finding(
                    self.id, display, line, 0,
                    f"{name} documented default `{default}` disagrees "
                    f"with the declared default "
                    f"`{knob.default_repr()}`",
                )


@register
class FailpointCoverageRule(ProjectRule):
    id = "failpoint-coverage"
    family = "contracts"
    description = (
        "Every registered failpoint must be armed by at least one test "
        "or a scripts/smoke.sh chaos spec — an unarmed failpoint is "
        "untested error handling wearing a tested-looking name. "
        "Suppress with justification where arming is impossible."
    )

    def check_project(self, modules: List[ModuleInfo],
                      ctx: LintContext) -> Iterable[Finding]:
        test_modules = [m for m in modules if m.is_test]
        if not test_modules:
            # linting a production slice: the arming corpus isn't in
            # view, so absence proves nothing
            return
        from pio_tpu_torch.analysis.rules_convention import failpoint_inventory

        corpus: List[str] = []
        for m in test_modules:
            for node in ast.walk(m.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    corpus.append(node.value)
        smoke = os.path.join(ctx.repo_root, "scripts", "smoke.sh")
        try:
            with open(smoke, "r", encoding="utf-8") as fh:
                corpus.append(fh.read())
        except OSError:
            pass
        blob = "\n".join(corpus)
        seen_points: Set[str] = set()
        for entry in failpoint_inventory(modules):
            point = entry["point"]
            if point in seen_points:
                continue
            seen_points.add(point)
            # dynamic sites report a static prefix; any armed name
            # under the prefix covers the site
            needle = point.split("{")[0] if entry["dynamic"] else point
            if needle and needle in blob:
                continue
            yield Finding(
                self.id, entry["file"], entry["line"], 0,
                f"failpoint {point!r} is never armed by tests/ or a "
                f"scripts/smoke.sh chaos spec",
            )
