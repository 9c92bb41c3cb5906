"""Fleet telemetry daemon: the standalone home of the aggregator.

The port's copy of ``pio_tpu/server/fleetd.py``. ``pio fleet --targets
host:port,...`` builds a :class:`FleetService`: one
:class:`~pio_tpu_torch.obs.fleet.FleetAggregator` scraping the member
list on a jittered interval, served over the port's HTTP plumbing.

Routes:

- ``GET /fleet.json`` — the federated cluster status payload (what the
  serving router steers by);
- ``GET /metrics``    — the aggregator's own ``pio_tpu_fleet_*``
  families plus the union of every member's metrics, each sample
  labeled ``pio_tpu_member="host:port"``;
- ``GET /healthz`` / ``GET /readyz`` — ready once one full scrape pass
  has completed (the router must not steer by an empty snapshot);
- ``GET /`` — tiny JSON index.

This module also hosts :class:`FollowerStatusService`: a partlog
:class:`~pio_tpu_torch.storage.partlog.replication.FollowerServer` speaks
a raw socket protocol and has no HTTP surface of its own, so a read
replica wraps it in this member-shaped sidecar — ``/metrics`` with
per-partition mirrored-byte positions, ``/readyz``, and a ``role:
follower`` ``/storage.json``.

The reference's trainer sidecar, also in its ``fleetd.py``, is the port's
``server/train_status.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

from pio_tpu_torch.obs import HealthMonitor, MetricsRegistry
from pio_tpu_torch.obs import slog
from pio_tpu_torch.obs.fleet import FleetAggregator, parse_targets
from pio_tpu_torch.server.http import (
    JsonHTTPServer, Request, Router, metrics_response,
)


class FleetService:
    """Aggregator + routes; ``create_fleet_server`` wires it to a port."""

    def __init__(
        self,
        targets: List[Tuple[str, str]],
        interval_s: Optional[float] = None,
        fetch=None,
    ):
        if not targets:
            raise ValueError(
                "fleet needs at least one target "
                "(--targets host:port,... or PIO_TPU_FLEET_TARGETS)"
            )
        self.obs = MetricsRegistry()
        slog.install()
        self.obs.add_collector(slog.exposition_lines)
        self.agg = FleetAggregator(
            targets, registry=self.obs, interval_s=interval_s, fetch=fetch,
        )
        self.health = HealthMonitor()
        self.health.add_readiness("first_scrape", self._check_first_scrape)
        self.router = Router()
        self.router.add("GET", "/", self.index)
        self.router.add("GET", "/fleet\\.json", self.fleet_json)
        self.router.add("GET", "/metrics", self.get_metrics)
        self.router.add("GET", "/healthz", self.healthz)
        self.router.add("GET", "/readyz", self.readyz)

    def _check_first_scrape(self):
        if self.agg.passes < 1:
            return False, "no scrape pass completed yet"
        return True, f"{self.agg.passes} scrape passes"

    def index(self, req: Request) -> Tuple[int, Any]:
        return 200, {
            "service": "pio-tpu-fleetd",
            "members": [m.name for m in self.agg.members()],
            "endpoints": ["/fleet.json", "/metrics", "/healthz", "/readyz"],
        }

    def fleet_json(self, req: Request) -> Tuple[int, Any]:
        return 200, self.agg.fleet_payload()

    def get_metrics(self, req: Request) -> Tuple[int, Any]:
        return 200, metrics_response(self.obs.render())

    def healthz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.liveness()
        return (200 if ok else 503), report

    def readyz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.readiness()
        return (200 if ok else 503), report


def create_fleet_server(
    targets: str,
    host: str = "0.0.0.0",
    port: int = 7000,
    interval_s: Optional[float] = None,
) -> JsonHTTPServer:
    """Build (unstarted) fleet daemon; the caller starts the HTTP server
    and then :meth:`FleetAggregator.start` via ``server.service.agg``."""
    service = FleetService(parse_targets(targets), interval_s=interval_s)
    server = JsonHTTPServer(
        service.router, host, port, name="pio-tpu-fleetd"
    )
    server.service = service
    return server


# ---------------------------------------------------------------------------
# follower observability sidecar
# ---------------------------------------------------------------------------

class FollowerStatusService:
    """Member-shaped HTTP surface for one partlog follower."""

    def __init__(self, follower):
        #: duck-typed FollowerServer: .root, .host, .port, .positions(n)
        self.follower = follower
        self.obs = MetricsRegistry()
        self._position = self.obs.gauge(
            "pio_tpu_repl_follower_position_bytes",
            "Verified mirrored bytes per partition on this follower",
            ("partition",),
        )
        self.health = HealthMonitor()
        self.health.add_readiness("mirror_root", self._check_root)
        self.router = Router()
        self.router.add("GET", "/storage\\.json", self.storage_json)
        self.router.add("GET", "/metrics", self.get_metrics)
        self.router.add("GET", "/healthz", self.healthz)
        self.router.add("GET", "/readyz", self.readyz)

    def _partitions(self) -> int:
        """Partition count from the MANIFEST the leader handshake wrote
        (0 until the first leader connects)."""
        path = os.path.join(self.follower.root, "MANIFEST.json")
        try:
            with open(path) as f:
                return int(json.load(f).get("partitions", 0))
        except (OSError, ValueError):
            return 0

    def _positions(self) -> dict:
        n = self._partitions()
        return self.follower.positions(n) if n else {}

    def _check_root(self):
        if not os.path.isdir(self.follower.root):
            return False, f"mirror root missing: {self.follower.root}"
        return True, self.follower.root

    def storage_json(self, req: Request) -> Tuple[int, Any]:
        pos = self._positions()
        return 200, {
            "backend": "partlog",
            "role": "follower",
            "root": self.follower.root,
            "partitions": self._partitions(),
            "replicationPort": self.follower.port,
            "positions": {str(k): v for k, v in pos.items()},
        }

    def get_metrics(self, req: Request) -> Tuple[int, Any]:
        for k, v in self._positions().items():
            self._position.set(float(v), partition=str(k))
        return 200, metrics_response(self.obs.render())

    def healthz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.liveness()
        return (200 if ok else 503), report

    def readyz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.readiness()
        return (200 if ok else 503), report


def create_follower_status_server(
    follower, host: str = "127.0.0.1", port: int = 0,
) -> JsonHTTPServer:
    """Wrap a running FollowerServer in its observability sidecar."""
    service = FollowerStatusService(follower)
    server = JsonHTTPServer(
        service.router, host, port, name="pio-tpu-follower-status"
    )
    server.service = service
    return server
