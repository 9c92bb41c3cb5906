"""Per-request stage tracing: context-manager spans over the monotonic
clock, a ring buffer of recent traces, and per-stage histograms.

The port's copy of ``pio_tpu/obs/tracing.py`` (the port imports nothing
of ``pio_tpu``).

One :class:`Tracer` per instrumented path (query serving, event ingest,
training). Usage::

    tracer = Tracer("query", registry=reg, stages=("parse", "execute"))
    with tracer.trace("query") as tr:
        with tr.span("parse"):
            ...
        tr.add_span("queue", measured_elsewhere_s)   # injected timing

Every finished span feeds the ``<name>_stage_seconds{stage=...}``
histogram (attaching the trace id as an OpenMetrics exemplar, so
``/metrics`` joins back to ``/traces.json``); every finished trace lands
in a bounded ring surfaced as ``GET /traces.json`` (slowest-first), so
"where did this query's milliseconds go" has a first-class answer
instead of ad-hoc prints.

Cross-process propagation
-------------------------

A trace crosses process and daemon boundaries via the ``X-Pio-Trace``
header (:data:`TRACE_HEADER`): ``<trace_id>`` or ``<trace_id>/<parent>``
where *parent* names the span in the upstream trace that issued the
call. :func:`parse_trace_header` / :func:`format_trace_header` are the
only parser/formatter pair — servers adopt the inbound id via
``tracer.trace(..., trace_id=..., parent=...)`` so one id names the
whole multi-process waterfall, and echo the header on responses so the
caller learns the id of traces the server minted itself.

Within a process, :data:`ACTIVE_TRACE` carries the open trace handle
through call stacks that never see the server layer (the device scorer,
storage, the device watch). :func:`add_active_span` records a span on
whatever trace is active — a no-op when none is — so deep layers
instrument unconditionally without plumbing handles through every
signature.

Naming: span/stage names are dot-scoped ``stage`` or ``stage.substage``
(lowercase ``[a-z0-9_]`` atoms). Top-level stages tile the request
(their durations sum to the end-to-end time); dotted substages attribute
*within* an enclosing stage and are excluded from budget sums.

Slow-trace capture: a second bounded ring keeps complete waterfalls for
requests breaching ``slow_threshold_s`` (an SLO threshold or p99
estimate, re-evaluated per trace via ``slow_threshold_fn``) —
tail-sampling that survives high QPS where the main ring churns in
milliseconds. ``/traces.json?slow=1`` serves it.
"""

from __future__ import annotations

import contextvars
import re
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from pio_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    monotonic_s,
)
from pio_tpu_torch.obs.slog import TRACE_CONTEXT

#: the cross-process trace propagation header. Value: ``<trace_id>`` or
#: ``<trace_id>/<parent_span>``; echoed on responses.
TRACE_HEADER = "X-Pio-Trace"

#: legal trace ids on the wire — generous but bounded (a hostile header
#: must not inject log/exposition syntax or unbounded memory).
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:\-]{0,127}$")

#: the open trace handle for THIS thread/task; lets deep layers (device
#: scorer, storage) attach spans without plumbing.
ACTIVE_TRACE: contextvars.ContextVar[Optional["_TraceHandle"]] = \
    contextvars.ContextVar("pio_tpu_torch_active_trace", default=None)


def parse_trace_header(value: Optional[str]
                       ) -> Tuple[Optional[str], Optional[str]]:
    """``(trace_id, parent_span)`` from an ``X-Pio-Trace`` value; both
    ``None`` for an absent or malformed header (propagation is best
    effort — a bad header starts a fresh trace, never a 400)."""
    if not value:
        return None, None
    trace_id, sep, parent = value.strip().partition("/")
    if not _TRACE_ID_RE.match(trace_id):
        return None, None
    if sep and not _TRACE_ID_RE.match(parent):
        parent = None
    return trace_id, (parent or None)


def format_trace_header(trace_id: str, parent: Optional[str] = None) -> str:
    """The ``X-Pio-Trace`` value naming ``trace_id`` (and the calling
    span, when the caller is itself traced)."""
    return f"{trace_id}/{parent}" if parent else trace_id


def active_trace() -> Optional["_TraceHandle"]:
    """The trace handle open on this thread/task, if any."""
    return ACTIVE_TRACE.get()


def add_active_span(stage: str, dur_s: float,
                    rel_start_s: Optional[float] = None) -> None:
    """Record a span on the active trace; silently a no-op without one
    (deep layers call this unconditionally)."""
    handle = ACTIVE_TRACE.get()
    if handle is not None:
        handle.add_span(stage, dur_s, rel_start_s)


class Trace:
    """One finished (or in-flight) request: ordered spans + metadata."""

    __slots__ = ("trace_id", "kind", "wall_time", "t0", "total_s",
                 "spans", "meta", "error", "parent", "links", "worker",
                 "slow")

    def __init__(self, trace_id: str, kind: str):
        self.trace_id = trace_id
        self.kind = kind
        # display timestamp for /traces.json; durations use t0 below
        self.wall_time = time.time()  # pio: disable=wallclock-duration
        self.t0 = monotonic_s()
        self.total_s: Optional[float] = None
        self.spans: List[Tuple[str, float, float]] = []  # (stage, rel_s, dur)
        self.meta: Dict[str, object] = {}
        self.error = False
        self.parent: Optional[str] = None   # upstream span (propagated)
        self.links: List[str] = []          # related trace ids (batch members)
        self.worker: Optional[int] = None   # pool worker index
        self.slow = False                   # retained by the slow ring

    def add_span(self, stage: str, dur_s: float,
                 rel_start_s: Optional[float] = None) -> None:
        if rel_start_s is None:
            rel_start_s = monotonic_s() - self.t0 - dur_s
        self.spans.append((stage, max(rel_start_s, 0.0), dur_s))

    def note(self, **meta) -> None:
        self.meta.update(meta)

    def to_dict(self) -> dict:
        return {
            "id": self.trace_id,
            "kind": self.kind,
            "wallTime": self.wall_time,
            "totalMs": (
                round(self.total_s * 1e3, 3)
                if self.total_s is not None else None
            ),
            "error": self.error,
            "spans": [
                {
                    "stage": stage,
                    "startMs": round(rel * 1e3, 3),
                    "durMs": round(dur * 1e3, 3),
                }
                for stage, rel, dur in self.spans
            ],
            **({"parent": self.parent} if self.parent else {}),
            **({"links": list(self.links)} if self.links else {}),
            **({"worker": self.worker} if self.worker is not None else {}),
            **({"slow": True} if self.slow else {}),
            **({"meta": self.meta} if self.meta else {}),
        }


class _TraceHandle:
    """What ``tracer.trace(...)`` yields: span recording for one request."""

    __slots__ = ("_tracer", "_trace")

    def __init__(self, tracer: "Tracer", trace: Trace):
        self._tracer = tracer
        self._trace = trace

    @property
    def trace_id(self) -> str:
        return self._trace.trace_id

    @property
    def elapsed_s(self) -> float:
        """Seconds since the (possibly rebased) trace start — lets a
        caller place a span it measured with its own clock."""
        return monotonic_s() - self._trace.t0

    @contextmanager
    def span(self, stage: str):
        t0 = monotonic_s()
        # publish (trace_id, stage) so logs emitted inside the span carry
        # both — slog.JsonLogHandler reads this on every record
        token = TRACE_CONTEXT.set((self._trace.trace_id, stage))
        try:
            yield
        finally:
            TRACE_CONTEXT.reset(token)
            dur = monotonic_s() - t0
            self.add_span(stage, dur, rel_start_s=t0 - self._trace.t0)

    def add_span(self, stage: str, dur_s: float,
                 rel_start_s: Optional[float] = None) -> None:
        """Record a span measured elsewhere (e.g. queue wait computed by
        the micro-batch worker thread)."""
        self._trace.add_span(stage, dur_s, rel_start_s)
        self._tracer._observe(stage, dur_s, self._trace.trace_id)

    def rebase(self, earlier_s: float) -> None:
        """Extend the trace window ``earlier_s`` seconds backward —
        accept/admission time spent before the trace could be opened
        belongs to the request, and the waterfall should show it at
        ``startMs=0`` rather than pretend the request began at parse."""
        if earlier_s <= 0:
            return
        t = self._trace
        t.t0 -= earlier_s
        t.wall_time -= earlier_s
        t.spans = [(s, rel + earlier_s, d) for s, rel, d in t.spans]

    def extend_total(self) -> None:
        """Re-stamp ``totalMs`` after post-close spans (the response
        write happens after the handler — and the trace — finishes)."""
        t = self._trace
        t.total_s = monotonic_s() - t.t0
        self._tracer._maybe_slow(t)

    def link(self, *trace_ids: str) -> None:
        """Associate related traces (a batch span links its members)."""
        self._trace.links.extend(trace_ids)

    def note(self, **meta) -> None:
        self._trace.note(**meta)

    def mark_error(self) -> None:
        self._trace.error = True


class Tracer:
    """Stage tracer for one instrumented path."""

    def __init__(self, name: str,
                 registry: Optional[MetricsRegistry] = None,
                 stages: Sequence[str] = (),
                 extra_labels: Optional[Dict[str, str]] = None,
                 ring: int = 128,
                 slow_ring: int = 32,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self._lock = threading.Lock()
        self._ring_cap = ring
        self._ring: List[Trace] = []
        self._pos = 0
        self._n = 0
        self._id_prefix = name
        self._slow_cap = slow_ring
        self._slow: List[Trace] = []
        self._slow_pos = 0
        #: returns the current slow threshold in seconds (or None to
        #: disable) — re-evaluated per trace so a p99 estimate tracks
        #: the live distribution. Assign after construction.
        self.slow_threshold_fn: Optional[Callable[[], Optional[float]]] = None
        self._extra = dict(extra_labels or {})
        self._hist = None
        #: stage -> bound histogram cell; every span lands ~4-8 observes
        #: per request on the serving hot path, so per-observe labels()
        #: resolution (tuple build + stringify + registry lookup) costs
        #: more than the bucket update itself
        self._stage_cells: Dict[str, object] = {}
        if registry is not None:
            labelnames = tuple(self._extra) + ("stage",)
            self._hist = registry.histogram(
                f"pio_tpu_{name}_stage_seconds",
                f"Per-stage wall seconds of the {name} path",
                labelnames,
                buckets=buckets,
            )
            # pre-create the declared stage cells so pool-mode binding
            # (registration-order slot layout) sees them at init time
            for stage in stages:
                self._stage_cells[stage] = self._hist.labels(
                    *(tuple(self._extra.values()) + (stage,))
                )

    def set_worker(self, worker: int) -> None:
        """Namespace generated trace ids per pool worker
        (``query-w2-17``) — SO_REUSEPORT workers otherwise mint
        colliding ids, and the supervisor's merged view needs ids to be
        pool-unique."""
        self._worker = worker  # type: ignore[attr-defined]
        self._id_prefix = f"{self.name}-w{worker}"

    def _observe(self, stage: str, dur_s: float,
                 trace_id: Optional[str] = None) -> None:
        if self._hist is None:
            return
        cell = self._stage_cells.get(stage)
        if cell is None:
            # undeclared stage: resolve once, then serve from the cache
            # (benign race — labels() hands every caller the same cell)
            cell = self._hist.labels(
                *(tuple(self._extra.values()) + (stage,))
            )
            self._stage_cells[stage] = cell
        cell.observe(dur_s, exemplar=trace_id)

    def _maybe_slow(self, t: Trace) -> None:
        """Move ``t`` into the slow ring if it breaches the threshold
        (idempotent — ``extend_total`` re-checks after the write span)."""
        fn = self.slow_threshold_fn
        if fn is None or t.slow or t.total_s is None:
            return
        try:
            threshold = fn()
        except Exception:
            return
        if threshold is None or t.total_s < threshold:
            return
        t.slow = True
        with self._lock:
            if len(self._slow) < self._slow_cap:
                self._slow.append(t)
            else:
                self._slow[self._slow_pos] = t
                self._slow_pos = (self._slow_pos + 1) % self._slow_cap

    @contextmanager
    def trace(self, kind: Optional[str] = None,
              trace_id: Optional[str] = None,
              parent: Optional[str] = None,
              links: Optional[Sequence[str]] = None,
              **meta):
        if trace_id is None:
            with self._lock:
                self._n += 1
                trace_id = f"{self._id_prefix}-{self._n}"
        else:
            with self._lock:
                self._n += 1
        t = Trace(trace_id, kind or self.name)
        t.parent = parent
        if links:
            t.links.extend(links)
        t.worker = getattr(self, "_worker", None)
        if meta:
            t.meta.update(meta)
        handle = _TraceHandle(self, t)
        # any log line emitted while this trace is open — even outside a
        # named span — correlates to the request via /logs.json?trace_id=
        token = TRACE_CONTEXT.set((trace_id, None))
        active_token = ACTIVE_TRACE.set(handle)
        try:
            yield handle
        except BaseException:
            t.error = True
            raise
        finally:
            ACTIVE_TRACE.reset(active_token)
            TRACE_CONTEXT.reset(token)
            t.total_s = monotonic_s() - t.t0
            with self._lock:
                if len(self._ring) < self._ring_cap:
                    self._ring.append(t)
                else:
                    self._ring[self._pos] = t
                    self._pos = (self._pos + 1) % self._ring_cap
            self._maybe_slow(t)

    # -- inspection --------------------------------------------------------
    @property
    def stage_histogram(self):
        """The ``pio_tpu_<name>_stage_seconds`` histogram (None when the
        tracer was built without a registry)."""
        return self._hist

    @property
    def count(self) -> int:
        return self._n

    def stage_summary(self, stages: Sequence[str]) -> Dict[str, dict]:
        """Count, mean and bucket-interpolated p50/p95/p99 in ms of each
        of ``stages`` that has observations (the ``stages`` block of a
        server's ``/stats.json``)."""
        out: Dict[str, dict] = {}
        if self._hist is None:
            return out
        for stage in stages:
            cell = self._hist.labels(*(tuple(self._extra.values())
                                       + (stage,)))
            n = cell.count
            if n <= 0:
                continue
            q = lambda f: round(cell.quantile(f) * 1e3, 3)  # noqa: E731
            out[stage] = {"count": int(n),
                          "avgMs": round(cell.sum / n * 1e3, 3),
                          "p50Ms": q(0.5), "p95Ms": q(0.95), "p99Ms": q(0.99)}
        return out

    def recent(self, n: int = 20, slowest: bool = True) -> List[dict]:
        """The ring's traces as dicts — slowest-first by default (the
        debugging question is "what were the worst recent requests")."""
        with self._lock:
            traces = [t for t in self._ring if t.total_s is not None]
        traces.sort(
            key=(lambda t: t.total_s) if slowest
            else (lambda t: t.wall_time),
            reverse=True,
        )
        return [t.to_dict() for t in traces[:n]]

    def slow(self, n: int = 20) -> List[dict]:
        """The slow ring (threshold breaches only), slowest-first."""
        with self._lock:
            traces = [t for t in self._slow if t.total_s is not None]
        traces.sort(key=lambda t: t.total_s, reverse=True)
        return [t.to_dict() for t in traces[:n]]

    def find(self, trace_id: str) -> Optional[dict]:
        """Look up one trace by id across both rings (slow ring first —
        it retains longer under churn)."""
        with self._lock:
            candidates = list(self._slow) + list(self._ring)
        for t in candidates:
            if t.trace_id == trace_id:
                return t.to_dict()
        return None
