"""Device telemetry plane — live device memory and compile attribution.

The port's copy of ``pio_tpu/obs/devicewatch.py``, with its surface kept:

- **Sampler** — :class:`DeviceWatch` reads the device's memory where the
  process already uses the card and falls back to a book-kept ledger
  (resident scorers and their output buffers) everywhere else. On CUDA
  the read is the caching allocator's counters
  (``torch.cuda.memory_stats``: ``bytesInUse`` is
  ``allocated_bytes.all.current``, ``peakBytes`` is
  ``allocated_bytes.all.peak``, and ``limitBytes`` the device's total
  memory). A read happens only when ``torch.cuda.is_initialized()`` and
  the watch's device is CUDA: the sampler never creates a CUDA context
  (hundreds of MB of the card and seconds of start), so a pool's CPU
  workers (``CUDA_VISIBLE_DEVICES=""``) and the CPU tests report the
  ledger, with ``source`` ``"ledger"``. Sampling runs on its own thread
  and reads counters only: it never synchronizes and never touches a
  dispatch path.
- **Compile attribution** — the port's first dispatch of each program
  shape at a site (the bucket warmup, a live dispatch into a cold bucket,
  the resident scorer, a trainer's chunk) is wrapped in
  :func:`compile_span`, so it lands in ``pio_tpu_xla_compile_total{site}``
  and a ``pio_tpu_xla_compile_seconds{site}`` histogram under the
  reference's names. Eager PyTorch compiles nothing; the span counts the
  first dispatch of a shape, which pays the one-off costs (cuBLAS
  handles, allocator growth), and steady serving must hold it flat.
- **Endpoints** — :meth:`DeviceWatch.payload` renders ``GET
  /device.json`` on the query server and the trainer status sidecar;
  ``pio top`` polls it.

The active watch is a module global under a lock (not a contextvar): the
status sidecar's HTTP thread must see the watch the training thread
activated. Library code records through the module-level hooks
(``ledger_place``/``record_compile``/…), one ``None`` check when no watch
is active.

Headroom is accounted against ``PIO_TPU_DEVICE_BUDGET_BYTES``:
``pio_tpu_device_budget_headroom_bytes = budget - max(bytes_in_use)``.
Where the live read and the ledger disagree, the gap is exported as
``pio_tpu_device_estimate_drift_bytes{device}``.

The streamed epoch feed (``parallel/stream.py``) books its in-flight
chunks under ``stream`` (:func:`stream_carry`) and its chunk dispatches
as ``stream_dispatch`` compiles. Failpoints: ``devicewatch.sample`` and
``devicewatch.payload``.

A first dispatch's compile record carries the enclosing request trace's
id as its exemplar (:func:`_active_trace_id`).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry, monotonic_s
from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.obs.devicewatch")

#: sampler interval; the thread wakes, samples, sleeps — never touches a
#: dispatch path
INTERVAL_ENV = "PIO_TPU_DEVICEWATCH_INTERVAL_S"

#: shared with parallel/partition.py (placement enforcement reads the
#: same budget this plane reports headroom against)
BUDGET_ENV = "PIO_TPU_DEVICE_BUDGET_BYTES"

#: set to ``0`` to keep the sampler thread off (payload() then samples
#: on demand — the endpoint still answers, just without a fresh series)
SAMPLER_ENV = "PIO_TPU_DEVICEWATCH"

#: documented compile-attribution sites; cells are pre-created per site
COMPILE_SITES = (
    "bucket_warmup",     # deploy-time bucket ladder sweep (query server)
    "bucket_dispatch",   # a LIVE dispatch into a cold bucket (should be 0)
    "resident_scorer",   # device-resident scorer program per batch size
    "stream_dispatch",   # streamed-feed chunk program (parallel/stream.py)
    "train_step",        # trainer chunk programs
)

#: ledger categories the fallback accounting books under
LEDGER_CATEGORIES = ("resident", "donated", "shard", "stream")

#: compile latencies span warmup-sweep milliseconds to multi-second
#: first dispatches; the request-latency buckets top out too low
COMPILE_BUCKETS = (
    0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _register_families(reg: MetricsRegistry) -> dict:
    """Create (or fetch — registration is idempotent) the device
    families on ``reg``."""
    return {
        "in_use": reg.gauge(
            "pio_tpu_device_bytes_in_use",
            "Bytes currently allocated on the device (memory_stats "
            "where supported, else the book-kept ledger)",
            ("device",),
        ),
        "peak": reg.gauge(
            "pio_tpu_device_peak_bytes",
            "High-water allocation mark per device",
            ("device",),
        ),
        "limit": reg.gauge(
            "pio_tpu_device_limit_bytes",
            "Allocatable byte limit the backend reports per device",
            ("device",),
        ),
        "headroom": reg.gauge(
            "pio_tpu_device_budget_headroom_bytes",
            "PIO_TPU_DEVICE_BUDGET_BYTES minus the busiest device's "
            "bytes_in_use (only set when a budget is configured)",
        ),
        "drift": reg.gauge(
            "pio_tpu_device_estimate_drift_bytes",
            "memory_stats bytes_in_use minus the book-kept ledger for "
            "the device (set when both sides have data and disagree)",
            ("device",),
        ),
        "compile_total": reg.counter(
            "pio_tpu_xla_compile_total",
            "Trace+compile entries attributed per in-tree jit site; "
            "steady-state serving must hold these flat",
            ("site",),
        ),
        "compile_seconds": reg.histogram(
            "pio_tpu_xla_compile_seconds",
            "Wall seconds of attributed trace+compile dispatches, with "
            "trace exemplars",
            ("site",),
            buckets=COMPILE_BUCKETS,
        ),
    }


# the process-global families exist from import on (the trainer sidecar
# renders through REGISTRY)
_register_families(REGISTRY)


def _active_trace_id() -> Optional[str]:
    """The enclosing request trace's id (None outside a trace)."""
    from pio_tpu_torch.obs.tracing import active_trace

    h = active_trace()
    return h.trace_id if h is not None else None


def shape_key(tree: Any) -> tuple:
    """Hashable per-leaf shape tuple of a nested container of tensors
    (a chunk with new leaf shapes is a new program). Leaves in
    ``jax.tree_util`` order: dict values by sorted key, lists and tuples
    in order, None holds no leaf."""
    shapes: list = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is not None:
            shapes.append(tuple(getattr(x, "shape", ())))

    walk(tree)
    return tuple(shapes)


class DeviceWatch:
    """Per-process (or per-service) device telemetry hub.

    The query server holds one on its per-instance registry; a training
    run activates one on the process-global registry for the sidecar.
    ``device`` is where the service or run keeps its tensors: only a
    CUDA device, once the process has initialized CUDA, is read live.
    All mutation is lock-guarded host bookkeeping — the only device
    interaction is the allocator's counters, read by the sampler thread
    or an inline :meth:`payload`.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        interval_s: Optional[float] = None,
        budget_bytes: Optional[int] = None,
        stats_fn: Optional[Callable[[], List[tuple]]] = None,
        device: Optional[torch.device] = None,
    ):
        reg = registry if registry is not None else REGISTRY
        self.registry = reg
        fams = _register_families(reg)
        self._g_in_use = fams["in_use"]
        self._g_peak = fams["peak"]
        self._g_limit = fams["limit"]
        self._g_headroom = fams["headroom"]
        self._g_drift = fams["drift"]
        self._compile_total = fams["compile_total"]
        self._compile_seconds = fams["compile_seconds"]
        # pre-created site cells: hot-path increments skip labels()
        self._compile_cells = {
            s: self._compile_total.labels(s) for s in COMPILE_SITES
        }
        for s in COMPILE_SITES:
            self._compile_seconds.labels(s)
        if interval_s is None:
            interval_s = knobs.knob_float(INTERVAL_ENV)
        self.interval_s = max(0.05, float(interval_s))
        if budget_bytes is None:
            budget_bytes = knobs.knob_int(BUDGET_ENV)
        self.budget_bytes = int(budget_bytes)
        self._stats_fn = stats_fn
        self.device = torch.device(device) if device is not None else None
        self._limit_bytes: Optional[int] = None
        self._lock = threading.Lock()
        #: (category, key) → placement row; the fallback accounting
        self._ledger: Dict[Tuple[str, str], dict] = {}
        #: (site, key) freshness set backing :meth:`fresh`
        self._seen: set = set()
        #: site → compile table row (count, seconds, last trace)
        self._compiles: Dict[str, dict] = {}
        self._generation: Optional[int] = None
        self._peaks: Dict[str, int] = {}
        self._rows: List[dict] = []
        self._mode = "ledger"
        self._samples = 0
        self._started_at = monotonic_s()
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- compile attribution -----------------------------------------------
    def fresh(self, site: str, key: Any) -> bool:
        """First sighting of ``(site, key)``? ``key=None`` is always
        fresh."""
        if key is None:
            return True
        k = (site, key)
        with self._lock:
            if k in self._seen:
                return False
            self._seen.add(k)
            return True

    def record_compile(
        self,
        site: str,
        seconds: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        cell = self._compile_cells.get(site)
        if cell is not None:
            cell.inc()
        else:
            self._compile_total.inc(site=site)
        with self._lock:
            row = self._compiles.setdefault(
                site,
                {"count": 0, "seconds": 0.0, "lastS": None,
                 "lastTraceId": None},
            )
            row["count"] += 1
            if seconds is not None:
                row["seconds"] = round(row["seconds"] + float(seconds), 6)
                row["lastS"] = round(float(seconds), 6)
            if trace_id:
                row["lastTraceId"] = trace_id
        if seconds is not None:
            self._compile_seconds.observe(
                float(seconds), exemplar=trace_id, site=site
            )

    @contextlib.contextmanager
    def span(self, site: str, key: Any = None):
        """Bracket a possibly-first dispatch: yields True (and records
        count + wall seconds) when ``key`` is fresh for ``site``, False
        (no record, no timing) otherwise."""
        if not self.fresh(site, key):
            yield False
            return
        t0 = monotonic_s()
        yield True
        self.record_compile(
            site, monotonic_s() - t0, trace_id=_active_trace_id()
        )

    def compile_counts(self) -> Dict[str, int]:
        with self._lock:
            return {s: r["count"] for s, r in self._compiles.items()}

    # -- ledger -------------------------------------------------------------
    def ledger_place(
        self,
        category: str,
        key: Any,
        nbytes: int,
        device: int = 0,
        name: Optional[str] = None,
    ) -> None:
        """Book ``nbytes`` resident under ``(category, key)``; replaces a
        prior placement under the same key (re-place = resize)."""
        with self._lock:
            self._ledger[(category, str(key))] = {
                "category": category,
                "key": str(key),
                "name": name or str(key),
                "bytes": int(nbytes),
                "device": int(device),
                "generation": self._generation,
            }

    def ledger_release(self, category: str, key: Any) -> None:
        with self._lock:
            self._ledger.pop((category, str(key)), None)

    def ledger_clear(self, category: Optional[str] = None) -> None:
        with self._lock:
            if category is None:
                self._ledger.clear()
                return
            for k in [k for k in self._ledger if k[0] == category]:
                del self._ledger[k]

    def stream_carry(self, delta: int, device: int = 0) -> None:
        """Streamed-feed in-flight bytes: chunks add on put, release on
        (non-retained) dispatch or feed finalize; floored at zero."""
        with self._lock:
            row = self._ledger.get(("stream", "carry"))
            if row is None:
                row = {
                    "category": "stream", "key": "carry",
                    "name": "stream carry", "bytes": 0,
                    "device": int(device), "generation": self._generation,
                }
                self._ledger[("stream", "carry")] = row
            row["bytes"] = max(0, row["bytes"] + int(delta))

    def ledger_bytes(self, device: Optional[int] = None) -> int:
        with self._lock:
            return sum(
                row["bytes"] for row in self._ledger.values()
                if device is None or row["device"] == int(device)
            )

    def set_generation(self, gen: int) -> None:
        """Stamp the serving generation (hot-swap bump). Placements
        booked before the swap installed (generation still unknown) are
        restamped with the generation they went live under."""
        with self._lock:
            self._generation = int(gen)
            for row in self._ledger.values():
                if row["generation"] is None:
                    row["generation"] = int(gen)

    # -- sampling -----------------------------------------------------------
    def _live(self) -> bool:
        """Read the card? Only where the process already uses it: a
        CUDA device and an initialized CUDA runtime (a read must never
        create a context)."""
        return (self.device is not None and self.device.type == "cuda"
                and torch.cuda.is_initialized())

    def _device_stats(self) -> List[tuple]:
        """``[(label, stats_or_None, device_index)]``: the allocator's
        counters of the watch's CUDA device, or the ledger's devices."""
        if self._stats_fn is not None:
            return self._stats_fn()
        if not self._live():
            kind = "cuda" if self.device is not None \
                and self.device.type == "cuda" else "cpu"
            with self._lock:
                idxs = sorted(
                    {row["device"] for row in self._ledger.values()}
                ) or [0]
            return [(f"{kind}:{i}", None, i) for i in idxs]
        idx = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        ms = torch.cuda.memory_stats(idx)
        if self._limit_bytes is None:
            self._limit_bytes = int(
                torch.cuda.get_device_properties(idx).total_memory)
        stats = {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": self._limit_bytes,
        }
        return [(f"cuda:{idx}", stats, idx)]

    def sample(self) -> List[dict]:
        """One telemetry pass: read (or book-keep) the device's bytes,
        update the gauges, compute headroom and estimate drift. Host
        work and allocator counters only — never a sync."""
        failpoint("devicewatch.sample")
        entries = self._device_stats()
        live = any(stats is not None for _, stats, _ in entries)
        rows: List[dict] = []
        max_in_use = 0
        for label, stats, idx in entries:
            ledger = self.ledger_bytes(device=idx)
            if stats is not None:
                in_use = int(stats.get("bytes_in_use") or 0)
                peak = int(stats.get("peak_bytes_in_use") or in_use)
                limit = stats.get("bytes_limit")
                limit = int(limit) if limit else None
                source = "memory_stats"
            else:
                in_use, peak, limit = ledger, ledger, None
                source = "ledger"
            with self._lock:
                peak = max(self._peaks.get(label, 0), peak, in_use)
                self._peaks[label] = peak
            drift = (
                in_use - ledger
                if (stats is not None and ledger > 0) else None
            )
            rows.append({
                "device": label,
                "bytesInUse": in_use,
                "peakBytes": peak,
                "limitBytes": limit,
                "ledgerBytes": ledger,
                "driftBytes": drift,
                "source": source,
            })
            max_in_use = max(max_in_use, in_use)
            self._g_in_use.set(float(in_use), device=label)
            self._g_peak.set(float(peak), device=label)
            if limit is not None:
                self._g_limit.set(float(limit), device=label)
            if drift is not None:
                self._g_drift.set(float(drift), device=label)
        if self.budget_bytes > 0:
            self._g_headroom.set(float(self.budget_bytes - max_in_use))
        with self._lock:
            self._rows = rows
            self._mode = "live" if live else "ledger"
            self._samples += 1
        return rows

    def measured_bytes(self) -> Optional[int]:
        """Measured total bytes in use from the last sample, or None when
        only the ledger is available — the honesty companion to the
        estimated ``paramBytes`` in ``/stats.json``."""
        with self._lock:
            if self._mode != "live":
                return None
            return sum(
                r["bytesInUse"] for r in self._rows
                if r["source"] == "memory_stats"
            )

    # -- payload ------------------------------------------------------------
    # pio: endpoint=/device.json
    def payload(self) -> dict:
        """The ``GET /device.json`` body (the reference's keys). Always
        samples inline: a scrape right after a placement must see it."""
        failpoint("devicewatch.payload")
        self.sample()
        with self._lock:
            rows = [dict(r) for r in self._rows]
            by_category: Dict[str, int] = {}
            placements = []
            for row in self._ledger.values():
                by_category[row["category"]] = (
                    by_category.get(row["category"], 0) + row["bytes"]
                )
                placements.append(dict(row))
            compiles = {
                s: dict(r) for s, r in sorted(self._compiles.items())
            }
            generation = self._generation
            samples = self._samples
            mode = self._mode
        placements.sort(
            key=lambda p: (
                p["generation"] if p["generation"] is not None else -1,
                p["category"], p["name"],
            )
        )
        max_in_use = max((r["bytesInUse"] for r in rows), default=0)
        return {
            "mode": mode,
            # pio: disable=wallclock-duration (asOf is a true timestamp)
            "asOf": time.time(),
            "uptimeS": round(monotonic_s() - self._started_at, 3),
            "intervalS": self.interval_s,
            "samples": samples,
            "sampler": self._thread is not None,
            "budgetBytes": self.budget_bytes or None,
            "headroomBytes": (
                self.budget_bytes - max_in_use
                if self.budget_bytes > 0 else None
            ),
            "generation": generation,
            "devices": rows,
            "ledger": {
                "totalBytes": sum(by_category.values()),
                "byCategory": by_category,
            },
            "placements": placements,
            "compiles": {
                "total": sum(r["count"] for r in compiles.values()),
                "sites": compiles,
            },
        }

    # -- sampler thread -----------------------------------------------------
    def start(self) -> "DeviceWatch":
        """Spawn the background sampler (idempotent). Daemon thread: the
        plane must never hold a process open."""
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        t = threading.Thread(
            target=self._run, name="pio-tpu-torch-devicewatch", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def _run(self) -> None:
        while True:
            try:
                self.sample()
            except Exception:
                log.exception("device sample failed")
            if self._stop_ev.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


# ---------------------------------------------------------------------------
# module-global active watch (a LOCKED global, not a contextvar — the
# sidecar HTTP thread must see the training thread's watch)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[DeviceWatch] = None
_ACTIVE_LOCK = threading.Lock()
#: last deactivated watch — a finished run's peaks stay readable
_LAST: Optional[DeviceWatch] = None


def activate(watch: DeviceWatch) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = watch


def deactivate(watch: Optional[DeviceWatch] = None) -> None:
    """Clear the active watch; with ``watch`` given, only when it is
    still the active one (a later activation wins)."""
    global _ACTIVE, _LAST
    with _ACTIVE_LOCK:
        if watch is None or _ACTIVE is watch:
            if _ACTIVE is not None:
                _LAST = _ACTIVE
            _ACTIVE = None


def active_watch() -> Optional[DeviceWatch]:
    return _ACTIVE


def last_watch() -> Optional[DeviceWatch]:
    """The active watch, else the most recently deactivated one."""
    return _ACTIVE or _LAST


@contextlib.contextmanager
def watching(watch: DeviceWatch, sample: bool = True):
    """Activate ``watch`` (and run its sampler) for a scope — the
    training run is wrapped in it so the status sidecar can serve
    ``/device.json`` while steps stream. The watch it displaced (a query
    server's, in a process that trains while it serves) is active again
    after the scope, so that the server's later placements still book
    into its own ledger; the reference leaves none active."""
    global _ACTIVE
    displaced = _ACTIVE
    activate(watch)
    if sample:
        watch.start()
    try:
        yield watch
    finally:
        if sample:
            watch.stop()
        deactivate(watch)
        with _ACTIVE_LOCK:
            if _ACTIVE is None:
                _ACTIVE = displaced


# ---------------------------------------------------------------------------
# hooks: library code calls these unconditionally; one None check when no
# watch is active
# ---------------------------------------------------------------------------

def record_compile(
    site: str,
    seconds: Optional[float] = None,
    trace_id: Optional[str] = None,
) -> None:
    w = _ACTIVE
    if w is not None:
        w.record_compile(site, seconds, trace_id=trace_id)


@contextlib.contextmanager
def compile_span(site: str, key: Any = None):
    """Module-level :meth:`DeviceWatch.span` against the active watch
    (yields False untimed when none is active or the key is stale)."""
    w = _ACTIVE
    if w is None:
        yield False
        return
    with w.span(site, key=key) as fresh:
        yield fresh


def ledger_place(
    category: str,
    key: Any,
    nbytes: int,
    device: int = 0,
    name: Optional[str] = None,
) -> None:
    w = _ACTIVE
    if w is not None:
        w.ledger_place(category, key, nbytes, device=device, name=name)


def ledger_release(category: str, key: Any) -> None:
    w = _ACTIVE
    if w is not None:
        w.ledger_release(category, key)


def ledger_clear(category: Optional[str] = None) -> None:
    w = _ACTIVE
    if w is not None:
        w.ledger_clear(category)


def stream_carry(delta: int, device: int = 0) -> None:
    w = _ACTIVE
    if w is not None:
        w.stream_carry(delta, device)


def set_generation(gen: int) -> None:
    w = _ACTIVE
    if w is not None:
        w.set_generation(gen)
