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

Not ported: the tracer, structured logs, the SLO engine, the hot-path
attribution and the pool's shared metrics segment (ROADMAP A2, A6).
"""

from __future__ import annotations

from pio_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    escape_help,
    escape_label_value,
    monotonic_s,
)
from pio_tpu_torch.obs import devicewatch, trainwatch
from pio_tpu_torch.obs.health import Heartbeat, HealthMonitor

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "HealthMonitor",
    "Heartbeat",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "devicewatch",
    "escape_help",
    "escape_label_value",
    "monotonic_s",
    "trainwatch",
]
