"""pio_tpu_torch.obs — the port's observability planes.

The port's copy of ``pio_tpu/obs`` limited to what it has ported:

- **Metrics registry** (:mod:`~pio_tpu_torch.obs.metrics`): Counter,
  Gauge and fixed-bucket Histogram types with labels and Prometheus text
  exposition (``GET /metrics``), and ``monotonic_s``, the port's one
  duration clock.
- **Health probes** (:mod:`~pio_tpu_torch.obs.health`): the liveness
  (``/healthz``) and readiness (``/readyz``) check registries.
- **Training telemetry** (:mod:`~pio_tpu_torch.obs.trainwatch`): the
  step stream, ``/train.json`` progress and the run ledger.
- **Device telemetry** (:mod:`~pio_tpu_torch.obs.devicewatch`): live
  device memory, compile attribution and ``/device.json``.
- **Profiler traces** (:mod:`~pio_tpu_torch.obs.profile`): the serving
  hook (``PIO_TPU_PROFILE``) and ``run_train``'s whole-run trace, on
  ``torch.profiler``.
- **Stage tracing** (:mod:`~pio_tpu_torch.obs.tracing`): context-manager
  spans, the ``X-Pio-Trace`` header, a ring of recent traces behind
  ``GET /traces.json`` and per-stage histograms; the hot-path budget
  over them (:mod:`~pio_tpu_torch.obs.hotpath`, ``/debug/hotpath.json``).
- **Structured logs** (:mod:`~pio_tpu_torch.obs.slog`): one-line JSON
  records carrying the enclosing trace's id, a ring behind
  ``GET /logs.json`` and ``pio_tpu_log_messages_total``.
- **SLO engine** (:mod:`~pio_tpu_torch.obs.slo`): declared objectives
  (``p99=50ms:99.9``) as multi-window burn rates, ``GET /slo.json`` and
  the ``pio_tpu_slo_*`` gauges.

- **Cross-worker aggregation** (:mod:`~pio_tpu_torch.obs.shm`): in a
  serving pool each worker mirrors its counters and histogram buckets
  into its stripe of one mmapped segment, so a scrape of any worker
  reports pool-wide totals (the reference's byte layout).
- **Fleet telemetry**: :mod:`~pio_tpu_torch.obs.promparse` (the text
  format's parser, merge and render) and :mod:`~pio_tpu_torch.obs.fleet`
  (the aggregator behind ``pio fleet``, the dashboard's fleet panel and
  the serving router).
"""

from __future__ import annotations

from pio_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    RequestWindow,
    escape_help,
    escape_label_value,
    monotonic_s,
)
from pio_tpu_torch.obs import devicewatch, trainwatch
from pio_tpu_torch.obs.health import Heartbeat, HealthMonitor
from pio_tpu_torch.obs.hotpath import hotpath_payload
from pio_tpu_torch.obs.slo import (
    SLOEngine,
    SLObjective,
    parse_duration_s,
    parse_slo,
)
from pio_tpu_torch.obs.tracing import (
    TRACE_HEADER,
    Trace,
    Tracer,
    active_trace,
    add_active_span,
    format_trace_header,
    parse_trace_header,
)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "HealthMonitor",
    "Heartbeat",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "RequestWindow",
    "SLOEngine",
    "SLObjective",
    "TRACE_HEADER",
    "Trace",
    "Tracer",
    "active_trace",
    "add_active_span",
    "devicewatch",
    "escape_help",
    "escape_label_value",
    "format_trace_header",
    "hotpath_payload",
    "monotonic_s",
    "parse_duration_s",
    "parse_slo",
    "parse_trace_header",
    "trainwatch",
]
