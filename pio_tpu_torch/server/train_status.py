"""The trainer's status sidecar: live progress of an in-flight run.

The port's copy of the reference's ``TrainStatusService`` and
``create_train_status_server`` (``pio_tpu/server/fleetd.py``). ``pio
train`` is a daemonless training process, so its live progress rides on a
small HTTP server of its own, on the port's ``server/http.py``:

- ``GET /train.json`` — the active recorder's progress payload
  (``obs/trainwatch.py``); 503 without an active run;
- ``GET /device.json`` — the active device watch's payload
  (``obs/devicewatch.py``); 503 without one;
- ``GET /metrics`` — the process-global registry: the run's
  ``pio_tpu_train_*`` and ``pio_tpu_device_*``/``pio_tpu_xla_*``
  families;
- ``GET /logs.json`` — the structured-log ring (``obs/slog.py``), whose
  records inside a traced phase carry its trace id and span;
- ``GET /healthz`` / ``GET /readyz`` — alive; ready while a run is
  recording.

It reads the process-global state rather than holding its own: the run
is driven in the same process, and the sidecar's thread must see
whatever run is live, including one that starts after the server.
"""

from __future__ import annotations

from typing import Any, Tuple

from pio_tpu_torch.obs import devicewatch, trainwatch
from pio_tpu_torch.obs.health import HealthMonitor
from pio_tpu_torch.obs.metrics import REGISTRY
from pio_tpu_torch.server.http import (
    JsonHTTPServer,
    Request,
    Router,
    logs_route,
    metrics_response,
)


class TrainStatusService:
    """Member-shaped HTTP surface for one in-flight training run."""

    def __init__(self):
        self._registry = REGISTRY
        self.health = HealthMonitor()
        self.health.add_readiness("training_run", self._check_run)
        self.router = Router()
        self.router.add("GET", "/train\\.json", self.train_json)
        self.router.add("GET", "/device\\.json", self.device_json)
        self.router.add("GET", "/logs\\.json", logs_route)
        self.router.add("GET", "/metrics", self.get_metrics)
        self.router.add("GET", "/healthz", self.healthz)
        self.router.add("GET", "/readyz", self.readyz)

    def _check_run(self):
        rec = trainwatch.active_recorder()
        if rec is None:
            return False, "no active training run"
        return True, f"run {rec.run_id}"

    def train_json(self, req: Request) -> Tuple[int, Any]:
        rec = trainwatch.active_recorder()
        if rec is None:
            return 503, {"error": "no active training run"}
        return 200, rec.payload()

    def device_json(self, req: Request) -> Tuple[int, Any]:
        """The run's device telemetry: the training thread activates a
        DeviceWatch for the run; the sidecar reads whatever watch is
        live in the process."""
        watch = devicewatch.active_watch()
        if watch is None:
            return 503, {"error": "no active device watch"}
        return 200, watch.payload()

    def get_metrics(self, req: Request) -> Tuple[int, Any]:
        return 200, metrics_response(self._registry.render())

    def healthz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.liveness()
        return (200 if ok else 503), report

    def readyz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.readiness()
        return (200 if ok else 503), report


def create_train_status_server(
    host: str = "127.0.0.1", port: int = 0,
) -> JsonHTTPServer:
    """Build the (unstarted) trainer sidecar; ``pio train --status-port``
    starts it for the run's duration (loopback and an ephemeral port by
    default — the run prints the bound port once the server starts)."""
    service = TrainStatusService()
    server = JsonHTTPServer(
        service.router, host, port, name="pio-tpu-torch-train-status"
    )
    server.service = service
    return server
