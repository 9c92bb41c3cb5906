"""Metrics registry — Counter / Gauge / Histogram with Prometheus text
exposition.

The port's copy of ``pio_tpu/obs/metrics.py``. In a serving pool
(``server/worker_pool.py``) every counter and histogram cell registered
before :meth:`MetricsRegistry.bind_pool_segment` mirrors its value into
the worker's stripe of the pool's shared segment (``obs/shm.py``), so a
scrape of any worker reports pool-wide totals; gauges, exemplars and cells
created after the bind stay local. The text it renders is the reference's:

- one ``# HELP``/``# TYPE`` pair per metric family, HELP text escaped
  (``\\`` and newline — label values additionally escape ``"``);
- histograms are CUMULATIVE fixed-bucket (``_bucket{le=...}`` rows
  monotone non-decreasing, closed by ``le="+Inf"``) with ``_sum`` and
  ``_count`` companions, and each bucket may carry the most recent
  exemplar (``# {trace_id="..."} value``);
- cells (one per label-value combination) are created lazily via
  ``metric.labels(...)`` and registration is idempotent — asking the
  registry for an existing family returns it.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("pio_tpu_torch.obs.metrics")

#: THE monotonic duration clock of the port (``perf_counter``: monotonic
#: per the stdlib contract, and the finest clock CPython offers)
monotonic_s = time.perf_counter

#: serving-latency histogram edges in SECONDS: 100 µs through 10 s
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_help(text: str) -> str:
    """Escape HELP text per the Prometheus text format (backslash and
    newline only — quotes are legal in HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value: str) -> str:
    """Escape a label value per the Prometheus text format."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    """Sample-value formatting: integers without the trailing ``.0``."""
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 2 ** 53 else repr(f)


def bucket_quantile(edges: Sequence[float], buckets: Sequence[int],
                    count: int, q: float) -> Optional[float]:
    """Quantile ``q`` of a histogram given as its finite bucket edges and
    per-bucket (not cumulative) counts, linear within the winning bucket."""
    if count == 0:
        return None
    rank = q * count
    cum = 0
    for k, c in enumerate(buckets):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            lo = edges[k - 1] if k > 0 else 0.0
            if k >= len(edges):  # +Inf bucket
                return edges[-1] if edges else lo
            hi = edges[k]
            frac = (rank - prev_cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return edges[-1] if edges else None


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Cell:
    """One (metric, label-values) combination: a locked local value with
    an optional mirror in the pool's shared segment."""

    __slots__ = ("_lock", "_v", "_seg", "_widx", "_slot")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0
        self._seg = None
        self._widx = None
        self._slot = None

    def _bind(self, seg, widx: int, slot: int) -> None:
        """Mirror into slot ``slot`` of worker stripe ``widx``. The stripe
        may already carry a value (a respawned worker binding its
        predecessor's stripe): adopt it, so pool totals survive a crash."""
        with self._lock:
            self._v += seg.read(widx, slot)
            self._seg, self._widx, self._slot = seg, widx, slot
            seg.set(widx, slot, self._v)

    def inc(self, v: float = 1.0) -> None:
        """Bound-cell fast path: hot code resolves ``labels()`` once and
        bumps the cell directly. Counter callers keep v >= 0 (the
        family-level ``Counter.inc`` enforces it; gauge cells may go
        down)."""
        with self._lock:
            self._v += v
            if self._seg is not None:
                self._seg.set(self._widx, self._slot, self._v)

    _add = inc

    def _set(self, v: float) -> None:
        with self._lock:
            self._v = v
            if self._seg is not None:
                self._seg.set(self._widx, self._slot, self._v)

    @property
    def value(self) -> float:
        """This process's value."""
        return self._v

    def _pool_value(self) -> float:
        """The pool-wide value: every stripe's slot summed when bound."""
        if self._seg is None:
            return self._v
        return self._seg.sum_slot(self._slot)


class _Metric:
    """Family base: name, help, label names, lazily created cells."""

    typ = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        #: label-values tuple -> cell, in creation order
        self._cells: Dict[Tuple[str, ...], object] = {}

    def _make_cell(self):
        return _Cell()

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(kv[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}"
            )
        cell = self._cells.get(values)
        if cell is None:
            with self._lock:
                cell = self._cells.setdefault(values, self._make_cell())
        return cell

    def _default_cell(self):
        """The zero-label cell (for label-less families)."""
        return self.labels()

    def samples(self, pool: bool = True) -> List[str]:
        raise NotImplementedError

    def render(self, pool: bool = True) -> List[str]:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} {self.typ}",
        ]
        lines.extend(self.samples(pool=pool))
        return lines


class _ScalarMetric(_Metric):
    def samples(self, pool: bool = True) -> List[str]:
        return [
            f"{self.name}{_label_str(self.labelnames, values)} "
            f"{_fmt(cell._pool_value() if pool else cell.value)}"
            for values, cell in list(self._cells.items())
        ]


class Counter(_ScalarMetric):
    typ = "counter"

    def inc(self, v: float = 1.0, **labels) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        (self.labels(**labels) if labels else self._default_cell()).inc(v)

    def value(self, *values) -> float:
        """The pool-wide value of one cell (the local one when unbound)."""
        return self.labels(*values)._pool_value()


class Gauge(_ScalarMetric):
    """Gauges stay local in a pool: a worker's uptime or queue depth
    summed over the stripes would mean nothing, so the registry never
    binds them."""

    typ = "gauge"

    def set(self, v: float, **labels) -> None:
        (self.labels(**labels) if labels else self._default_cell())._set(v)

    def inc(self, v: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels else self._default_cell()).inc(v)

    def value(self, *values) -> float:
        return self.labels(*values).value


class _HistogramCell:
    """Fixed cumulative buckets + sum + count, with an optional mirror in
    the pool's shared segment (the buckets, the sum and the count each
    take a slot). Each bucket remembers its most recent exemplar (an id
    and the observed value); exemplars are strings and stay local."""

    __slots__ = ("_lock", "_edges", "_buckets", "_sum", "_count",
                 "_exemplars", "_seg", "_widx", "_slot0")

    def __init__(self, edges: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._edges = edges  # finite upper bounds, sorted
        self._buckets = [0] * (len(edges) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._exemplars: Dict[int, Tuple[str, float]] = {}  # idx -> (id, v)
        self._seg = None
        self._widx = None
        self._slot0 = None

    def n_slots(self) -> int:
        return len(self._buckets) + 2  # buckets + sum + count

    def _bind(self, seg, widx: int, slot0: int) -> None:
        """Mirror into slots ``slot0..`` of stripe ``widx``, adopting what
        the stripe already holds (as :meth:`_Cell._bind`)."""
        with self._lock:
            nb = len(self._buckets)
            for k in range(nb):
                self._buckets[k] += int(seg.read(widx, slot0 + k))
            self._sum += seg.read(widx, slot0 + nb)
            self._count += int(seg.read(widx, slot0 + nb + 1))
            self._seg, self._widx, self._slot0 = seg, widx, slot0
            for k, c in enumerate(self._buckets):
                seg.set(widx, slot0 + k, float(c))
            seg.set(widx, slot0 + nb, self._sum)
            seg.set(widx, slot0 + nb + 1, float(self._count))

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        idx = bisect.bisect_left(self._edges, v)
        with self._lock:
            self._buckets[idx] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplars[idx] = (str(exemplar), v)
            if self._seg is not None:
                nb = len(self._buckets)
                self._seg.set(self._widx, self._slot0 + idx,
                              float(self._buckets[idx]))
                self._seg.set(self._widx, self._slot0 + nb, self._sum)
                self._seg.set(self._widx, self._slot0 + nb + 1,
                              float(self._count))

    def _snapshot(self, pool: bool = False) -> Tuple[List[int], float, int]:
        """Buckets, sum and count: every stripe's summed when ``pool`` and
        bound, else this process's."""
        if pool and self._seg is not None:
            nb = len(self._buckets)
            seg, s0 = self._seg, self._slot0
            return ([int(seg.sum_slot(s0 + k)) for k in range(nb)],
                    seg.sum_slot(s0 + nb), int(seg.sum_slot(s0 + nb + 1)))
        with self._lock:
            return list(self._buckets), self._sum, self._count

    def _exemplar_snapshot(self) -> Dict[int, Tuple[str, float]]:
        with self._lock:
            return dict(self._exemplars)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def count_le(self, threshold: float,
                 pool: bool = True) -> Tuple[int, int]:
        """``(observations <= threshold, total observations)``: the
        good/total pair of a latency SLO, pool-wide when bound. The
        threshold snaps down to a bucket edge (cumulative buckets cannot
        see inside a bucket)."""
        buckets, _sum, count = self._snapshot(pool)
        k = bisect.bisect_right(self._edges, threshold)
        return sum(buckets[:k]), count

    def quantile(self, q: float, pool: bool = False) -> Optional[float]:
        """Bucket-interpolated quantile (linear within the winning bucket;
        the +Inf bucket clamps to its lower edge)."""
        buckets, _sum, count = self._snapshot(pool)
        return bucket_quantile(self._edges, buckets, count, q)


class Histogram(_Metric):
    typ = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        edges = tuple(sorted(float(b) for b in buckets
                             if b != float("inf")))
        if not edges:
            raise ValueError("histogram needs at least one finite bucket")
        self.buckets = edges

    def _make_cell(self):
        return _HistogramCell(self.buckets)

    def observe(self, v: float, exemplar: Optional[str] = None,
                **labels) -> None:
        (self.labels(**labels) if labels
         else self._default_cell()).observe(v, exemplar=exemplar)

    def samples(self, pool: bool = True) -> List[str]:
        out = []
        edges = [_fmt(e) for e in self.buckets] + ["+Inf"]
        for values, cell in list(self._cells.items()):
            buckets, sum_, count = cell._snapshot(pool)
            exemplars = cell._exemplar_snapshot()
            cum = 0
            for k, (edge, c) in enumerate(zip(edges, buckets)):
                cum += c
                ls = _label_str(
                    self.labelnames + ("le",), values + (edge,)
                )
                line = f"{self.name}_bucket{ls} {cum}"
                ex = exemplars.get(k)
                if ex is not None:
                    eid, ev = ex
                    line += (
                        f' # {{trace_id="{escape_label_value(eid)}"}}'
                        f" {_fmt(ev)}"
                    )
                out.append(line)
            base = _label_str(self.labelnames, values)
            out.append(f"{self.name}_sum{base} {_fmt(sum_)}")
            out.append(f"{self.name}_count{base} {count}")
        return out


class RequestWindow:
    """Cumulative request stats plus a bounded ring of timestamped
    samples for ``?window=`` views (``/stats.json`` of the event server):
    count, errors and the sum stay exact; percentiles come from the ring."""

    def __init__(self, cap: int = 8192):
        self._lock = threading.Lock()
        self._cap = cap
        self._ring: List[Tuple[float, float, bool]] = []  # (t, ms, error)
        self._pos = 0
        self.count = 0
        self.errors = 0
        self.total_ms = 0.0

    def record(self, ms: float, error: bool = False) -> None:
        with self._lock:
            self.count += 1
            if error:
                self.errors += 1
            self.total_ms += ms
            item = (monotonic_s(), ms, error)
            if len(self._ring) < self._cap:
                self._ring.append(item)
            else:
                self._ring[self._pos] = item
                self._pos = (self._pos + 1) % self._cap

    # pio: endpoint=/stats.json
    def to_dict(self) -> dict:
        """Exact cumulative count, errors and mean; percentiles over the
        ring (the newest ``cap`` requests)."""
        with self._lock:
            xs = sorted(ms for _, ms, _ in self._ring)
            count, errors, total = self.count, self.errors, self.total_ms
        n = len(xs)
        q = lambda f: round(xs[min(int(f * n), n - 1)], 3) if n else None
        return {
            "requestCount": count,
            "errorCount": errors,
            "avgMs": round(total / count, 3) if count else None,
            "p50Ms": q(0.50),
            "p95Ms": q(0.95),
            "p99Ms": q(0.99),
        }

    # pio: endpoint=/stats.json
    def window(self, window_s: float) -> dict:
        """count, errors, mean and p50/p95/p99 over the trailing
        ``window_s`` seconds (bounded by the ring)."""
        cutoff = monotonic_s() - window_s
        with self._lock:
            xs = [(ms, err) for t, ms, err in self._ring if t >= cutoff]
        xs.sort(key=lambda p: p[0])
        n = len(xs)
        q = lambda f: xs[min(int(f * n), n - 1)][0] if n else None
        return {
            "windowSeconds": window_s,
            "requestCount": n,
            "errorCount": sum(1 for _, err in xs if err),
            "avgMs": (sum(ms for ms, _ in xs) / n) if n else None,
            "p50Ms": q(0.50),
            "p95Ms": q(0.95),
            "p99Ms": q(0.99),
        }


class MetricsRegistry:
    """Ordered family registry, with the pool segment's binding and extra
    exposition collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], List[str]]] = []
        self._segment = None
        self._worker_idx: Optional[int] = None

    def _register(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label set"
                    )
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help, labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def add_collector(self, fn: Callable[[], List[str]]) -> None:
        """Append a callable producing extra exposition lines (rendered
        after the registered families; the callable owns its HELP/TYPE),
        e.g. the failpoints' trigger counter."""
        with self._lock:
            self._collectors.append(fn)

    # -- pool mode -------------------------------------------------------
    def bind_pool_segment(self, segment, worker_idx: int) -> None:
        """Mirror every counter and histogram cell registered so far into
        stripe ``worker_idx`` of ``segment``.

        Slots go by registration order, so every worker of a pool, which
        runs the same service set-up, computes the same layout. Cells
        created after the bind stay local (the servers create their pool
        cells in ``__init__``); gauges are never bound. A layout wider
        than a stripe raises ``ValueError``."""
        with self._lock:
            self._segment = segment
            self._worker_idx = worker_idx
            slot = 0
            for m in self._metrics.values():
                if isinstance(m, Gauge):
                    continue
                for cell in m._cells.values():
                    need = (cell.n_slots()
                            if isinstance(cell, _HistogramCell) else 1)
                    if slot + need > segment.slots_per_worker:
                        raise ValueError(
                            f"pool metrics segment too small: need > "
                            f"{segment.slots_per_worker} slots")
                    cell._bind(segment, worker_idx, slot)
                    slot += need

    @property
    def pool_bound(self) -> bool:
        return self._segment is not None

    # -- exposition ------------------------------------------------------
    def render_prefixed(self, prefixes, pool: bool = True) -> List[str]:
        """Exposition lines of the families whose name starts with one of
        ``prefixes``: the bridge a server adds as a collector to show a
        slice of the process-global registry (the storage layer's group
        commit and retry families) on its own ``/metrics``."""
        pfx = tuple(prefixes)
        with self._lock:
            metrics = [m for m in self._metrics.values()
                       if m.name.startswith(pfx)]
        return [line for m in metrics for line in m.render(pool=pool)]

    def render(self, pool: bool = True) -> List[str]:
        """Exposition lines for every family, in registration order
        (pool-wide values of bound cells when ``pool``), then the
        collectors' lines."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        lines = [line for m in metrics for line in m.render(pool=pool)]
        for fn in collectors:
            try:
                lines.extend(fn())
            except Exception:  # a broken collector must not kill /metrics
                log.exception("metrics collector failed")
        return lines


#: process-wide default registry — the layers with no natural owner (the
#: training workflow and its status sidecar). HTTP services create their
#: own registry per instance so that servers in one process do not bleed
#: counters into each other.
REGISTRY = MetricsRegistry()
