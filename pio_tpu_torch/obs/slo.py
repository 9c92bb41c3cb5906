"""SLO objectives and multi-window burn-rate evaluation.

The port's copy of ``pio_tpu/obs/slo.py`` (the port imports nothing of
``pio_tpu``).

Turns the cumulative counters/histograms the obs registry already
maintains into the operator-facing question: *are we meeting our service
level objective, and how fast are we burning the error budget?* No
external dependency — the same arithmetic Prometheus alert rules would
run, executed in-process and surfaced as ``GET /slo.json`` plus
``pio_tpu_slo_*`` gauges.

**Objectives** are declared as compact specs (the ``pio deploy --slo``
syntax)::

    p99=50ms:99.9        # 99.9% of requests complete within 50 ms
    p95=25ms:99/6h       # 99% within 25 ms, budgeted over a 6 h window
    availability=99.95   # 99.95% of requests succeed

Latency objectives read good/total straight from histogram buckets
(``count_le`` — the threshold snaps to a bucket edge), availability from
the request/error counters. The port has no shared metrics segment, so a
pool worker evaluates its own requests.

**Burn rate** over a trailing window ``w`` is ``error_rate(w) /
(1 - objective)`` — 1.0 means the budget exactly lasts the SLO window,
14.4 means a 30-day budget gone in ~2 days. Alerting uses the classic
multi-window fast/slow pairs (Google SRE workbook ch. 5): a *page* needs
BOTH the 5 m and 1 h windows above 14.4 (fast response, but the long
window de-flaps it); a *ticket* needs 30 m and 6 h above 6. Windowed
rates come from a ring of (t, good, total) snapshots taken at each
evaluation — the same scrape-driven sampling model Prometheus uses.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from pio_tpu_torch.obs.metrics import MetricsRegistry, monotonic_s
from pio_tpu_torch.utils import knobs

#: ((fast_window_s, slow_window_s, burn_threshold, severity), ...)
DEFAULT_BURN_WINDOWS: Tuple[Tuple[float, float, float, str], ...] = (
    (300.0, 3600.0, 14.4, "page"),
    (1800.0, 21600.0, 6.0, "ticket"),
)

_DUR_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
              "h": 3600.0, "d": 86400.0}

_SPEC_RE = re.compile(
    r"^(?P<name>[a-zA-Z][\w.-]*)"
    r"(?:=(?P<threshold>[0-9.]+(?:us|ms|s))?)?"
    r"(?::|=)(?P<objective>[0-9.]+)"
    r"(?:/(?P<window>[0-9.]+(?:s|m|h|d)))?$"
)


def parse_duration_s(text: str) -> float:
    m = re.match(r"^([0-9.]+)(us|ms|s|m|h|d)$", text.strip())
    if not m:
        raise ValueError(f"cannot parse duration {text!r} (want e.g. 50ms)")
    return float(m.group(1)) * _DUR_UNITS[m.group(2)]


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declared objective: ``objective`` is a FRACTION (0.999 for
    three nines); ``threshold_s`` set only for latency objectives;
    ``window_s`` is the error-budget period."""

    name: str
    kind: str  # "latency" | "availability"
    objective: float
    threshold_s: Optional[float] = None
    window_s: float = 3600.0

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO objective must be in (0, 1), got {self.objective}"
            )
        if self.kind == "latency" and self.threshold_s is None:
            raise ValueError("latency SLO needs a threshold")

    @property
    def budget(self) -> float:
        """Allowed error fraction (1 - objective)."""
        return 1.0 - self.objective


def parse_slo(spec: str) -> SLObjective:
    """``p99=50ms:99.9[/6h]`` / ``availability=99.9[/6h]`` → objective.

    The left-hand name is free-form (``p99`` is a label, the math is
    "fraction of requests within the threshold"); a spec with a duration
    is a latency objective, one without is availability. The objective
    is a PERCENT (99.9 → 0.999)."""
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"cannot parse SLO spec {spec!r} "
            f"(want p99=50ms:99.9 or availability=99.9, optional /6h)"
        )
    name = m.group("name")
    pct = float(m.group("objective"))
    if not 0.0 < pct < 100.0:
        raise ValueError(f"SLO objective percent out of range: {pct}")
    window_s = (
        parse_duration_s(m.group("window")) if m.group("window") else 3600.0
    )
    if m.group("threshold"):
        return SLObjective(
            name=f"latency_{name.lower()}",
            kind="latency",
            objective=pct / 100.0,
            threshold_s=parse_duration_s(m.group("threshold")),
            window_s=window_s,
        )
    if name.lower() in ("availability", "avail", "errors", "success"):
        return SLObjective(
            name="availability",
            kind="availability",
            objective=pct / 100.0,
            window_s=window_s,
        )
    raise ValueError(
        f"SLO spec {spec!r} has no latency threshold and is not an "
        f"availability objective"
    )


class _Series:
    """One objective + its cumulative source + snapshot history."""

    __slots__ = ("slo", "good_total", "history", "cap")

    def __init__(self, slo: SLObjective,
                 good_total: Callable[[], Tuple[float, float]],
                 cap: int = 2048):
        self.slo = slo
        self.good_total = good_total
        #: (t, good, total) snapshots, chronological, bounded
        self.history: List[Tuple[float, float, float]] = []
        self.cap = cap

    def sample(self, now: float) -> Tuple[float, float]:
        good, total = self.good_total()
        self.history.append((now, float(good), float(total)))
        if len(self.history) > self.cap:
            # drop the oldest half in one slice (amortized O(1))
            del self.history[: self.cap // 2]
        return float(good), float(total)

    def window_delta(self, now: float,
                     window_s: float) -> Tuple[float, float, float]:
        """(bad, total, actual_span_s) over the trailing window — the
        newest snapshot at least ``window_s`` old anchors the delta; with
        less history, the oldest snapshot does (Prometheus ``rate`` over
        a short range behaves the same way)."""
        if not self.history:
            return 0.0, 0.0, 0.0
        cutoff = now - window_s
        anchor = self.history[0]
        for snap in reversed(self.history):
            if snap[0] <= cutoff:
                anchor = snap
                break
        head = self.history[-1]
        d_total = max(head[2] - anchor[2], 0.0)
        d_good = max(head[1] - anchor[1], 0.0)
        return max(d_total - d_good, 0.0), d_total, head[0] - anchor[0]


class SLOEngine:
    """Evaluates declared objectives against live cumulative sources.

    ``registry`` (optional) receives ``pio_tpu_slo_error_budget_remaining
    {slo}`` and ``pio_tpu_slo_burn_rate{slo,window}`` gauges, refreshed on
    every :meth:`evaluate` — so a plain ``/metrics`` scrape carries the
    SLO state even if nothing ever polls ``/slo.json``.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 burn_windows: Sequence[Tuple[float, float, float, str]] =
                 DEFAULT_BURN_WINDOWS):
        self._lock = threading.Lock()
        self._series: List[_Series] = []
        self.burn_windows = tuple(burn_windows)
        self._budget_gauge = None
        self._burn_gauge = None
        if registry is not None:
            self._budget_gauge = registry.gauge(
                "pio_tpu_slo_error_budget_remaining",
                "Fraction of the SLO error budget left over the SLO "
                "window (1 = untouched, <0 = overspent)",
                ("slo",),
            )
            self._burn_gauge = registry.gauge(
                "pio_tpu_slo_burn_rate",
                "Error-budget burn rate over a trailing window "
                "(1 = budget exactly lasts the SLO window)",
                ("slo", "window"),
            )

    def add(self, slo: SLObjective,
            good_total: Callable[[], Tuple[float, float]]) -> None:
        """Register an objective with its cumulative (good, total)
        source. Sources must be monotone non-decreasing (counters)."""
        with self._lock:
            self._series.append(_Series(slo, good_total))

    def __len__(self) -> int:
        return len(self._series)

    @property
    def objectives(self) -> List[SLObjective]:
        with self._lock:
            return [s.slo for s in self._series]

    def sample(self, now: Optional[float] = None) -> None:
        """Take one snapshot of every source (tests drive this with an
        explicit clock to build deterministic histories)."""
        t = monotonic_s() if now is None else now
        with self._lock:
            for s in self._series:
                s.sample(t)

    def _window_set(self, slo: SLObjective) -> List[float]:
        ws = {w for pair in self.burn_windows for w in pair[:2]}
        ws.add(slo.window_s)
        return sorted(ws)

    # pio: endpoint=/slo.json
    def evaluate(self, now: Optional[float] = None,
                 take_sample: bool = True) -> dict:
        """The ``GET /slo.json`` body: per objective, cumulative totals,
        remaining error budget over the SLO window, burn rate per
        trailing window, and which multi-window alerts fire."""
        t = monotonic_s() if now is None else now
        with self._lock:
            series = list(self._series)
        out = []
        for s in series:
            if take_sample:
                s.sample(t)
            slo = s.slo
            head = s.history[-1] if s.history else (t, 0.0, 0.0)
            total, good = head[2], head[1]
            burns: Dict[str, float] = {}
            burn_by_w: Dict[float, float] = {}
            for w in self._window_set(slo):
                bad_w, total_w, _span = s.window_delta(t, w)
                rate = (bad_w / total_w) if total_w > 0 else 0.0
                burn = rate / slo.budget
                burn_by_w[w] = burn
                burns[f"{int(w)}s"] = round(burn, 4)
            # budget remaining over the SLO window
            bad_slo, total_slo, _ = s.window_delta(t, slo.window_s)
            allowed = slo.budget * total_slo
            remaining = (
                1.0 - (bad_slo / allowed) if allowed > 0 else 1.0
            )
            alerts = []
            for fast, slow, threshold, severity in self.burn_windows:
                firing = (
                    burn_by_w.get(fast, 0.0) > threshold
                    and burn_by_w.get(slow, 0.0) > threshold
                )
                alerts.append({
                    "severity": severity,
                    "fastWindowS": fast,
                    "slowWindowS": slow,
                    "burnThreshold": threshold,
                    "firing": firing,
                })
            entry = {
                "name": slo.name,
                "kind": slo.kind,
                "objective": slo.objective,
                "windowSeconds": slo.window_s,
                "total": total,
                "errors": max(total - good, 0.0),
                "errorBudgetRemaining": round(remaining, 4),
                "burnRates": burns,
                "alerts": alerts,
            }
            if slo.threshold_s is not None:
                entry["thresholdMs"] = round(slo.threshold_s * 1e3, 3)
            out.append(entry)
            if self._budget_gauge is not None:
                self._budget_gauge.set(remaining, slo=slo.name)
            if self._burn_gauge is not None:
                for w, b in burn_by_w.items():
                    self._burn_gauge.set(b, slo=slo.name, window=f"{int(w)}s")
        return {"slos": out}


def engine_for_specs(
    specs: Sequence[str],
    registry: MetricsRegistry,
    availability_source: Callable[[], Tuple[float, float]],
    latency_cell_getter: Callable[[], object],
) -> SLOEngine:
    """Wire parsed specs to a serving service's sources: availability
    objectives read the request/error counters, latency objectives read
    ``count_le`` off the full-request latency histogram cell."""
    eng = SLOEngine(registry=registry)
    for spec in specs:
        slo = parse_slo(spec) if isinstance(spec, str) else spec
        if slo.kind == "availability":
            eng.add(slo, availability_source)
        else:
            threshold = slo.threshold_s

            def good_total(threshold=threshold):
                cell = latency_cell_getter()
                if cell is None:
                    return 0.0, 0.0
                return cell.count_le(threshold, pool=True)

            eng.add(slo, good_total)
    return eng


# pio: endpoint=/slo.json
def slo_payload(engine: Optional[SLOEngine]) -> dict:
    """The ``GET /slo.json`` body of a server (``configured`` false and no
    objectives without an engine)."""
    if engine is None:
        return {"slos": [], "configured": False}
    out = engine.evaluate()
    out["configured"] = True
    return out


def slow_threshold_s(engine: Optional[SLOEngine],
                     e2e_cell) -> Optional[float]:
    """A server's slow-trace capture threshold in seconds:
    ``PIO_TPU_SLOW_TRACE_MS``, else the tightest latency objective, else
    the live p99 of ``e2e_cell`` once 64 requests give it a basis; None
    before that."""
    ms = knobs.knob_float("PIO_TPU_SLOW_TRACE_MS")
    if ms > 0:
        return ms / 1e3
    if engine is not None:
        thresholds = [o.threshold_s for o in engine.objectives
                      if o.kind == "latency" and o.threshold_s]
        if thresholds:
            return min(thresholds)
    if e2e_cell.count >= 64:
        return e2e_cell.quantile(0.99, pool=False)
    return None
