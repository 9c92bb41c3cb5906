"""Serving-router daemon — the front tier of the serving fabric.

The port's copy of ``pio_tpu/server/routerd.py`` (the port imports nothing of
``pio_tpu``).

``pio route --targets host:port,...`` builds a :class:`RouterService`:
a :class:`~pio_tpu_torch.router.core.ServingRouter` fanning query traffic
across the member list, fed by an embedded
:class:`~pio_tpu_torch.obs.fleet.FleetAggregator` scraping the same members
(tightened staleness thresholds — a front tier must see a dead member
within two scrape intervals, not the dashboard-grade five).

Routes:

- ``POST /queries.json`` — the relay. Speaks both wires: JSON bodies
  relay as their original bytes (no re-serialize), and the packed int8
  wire (``application/x-pio-query-i8``) passes ``req.packed`` through
  untouched under the ``# pio: hotpath=zerocopy`` contract. Entity
  affinity comes from the JSON body's entity field when present; the
  packed frame carries no entity id, so those spread by load. Upstream
  status codes relay as-is; router-side refusals use the QoS
  vocabulary (503 + ``Retry-After``) and every reply carries
  ``X-Pio-Router-Member`` naming the member that answered.
- ``GET /router.json`` — ring membership, per-member health/burn/lag/
  generation and forward counters (schema in docs/observability.md);
- ``POST /deploy`` — admin (bearer key or loopback): manifest-verified
  rollout of one instance to every member (see
  :mod:`pio_tpu_torch.router.deploy`);
- ``POST /rollout`` / ``POST /rollout/abort`` / ``GET /rollout.json`` —
  progressive delivery (see :mod:`pio_tpu_torch.router.rollout`): start a
  shadow->canary->promote rollout of a candidate instance, abort it,
  or read the live stage + decision trail;
- ``GET /fleet.json`` — the embedded aggregator's federated payload;
- ``GET /metrics`` / ``/healthz`` / ``/readyz`` — ready once one full
  scrape pass has completed (never steer by an empty snapshot).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple

from pio_tpu_torch.faults import exposition_lines as fault_lines
from pio_tpu_torch.obs import HealthMonitor, MetricsRegistry, slog
from pio_tpu_torch.obs.fleet import FleetAggregator
from pio_tpu_torch.qos.gate import retry_after_header
from pio_tpu_torch.qos.policy import PRIORITY_HEADER
from pio_tpu_torch.router.core import ServingRouter, Shed
from pio_tpu_torch.router.deploy import load_manifest, push_deploy
from pio_tpu_torch.router.rollout import (
    RolloutConfig,
    RolloutController,
    RolloutMetrics,
)
from pio_tpu_torch.server.http import (
    HTTPError,
    JsonHTTPServer,
    RawResponse,
    Request,
    Router,
    keys_equal,
    metrics_response,
)

#: JSON body fields probed (in order) for the affinity entity id —
#: the reference engines key queries by user.
ENTITY_FIELDS = ("entityId", "user", "uid", "userId")

#: staleness thresholds in scrape intervals for the EMBEDDED aggregator:
#: a member whose scrape age passes 2 intervals is down to the router
#: (the fleet dashboard default of 5 is built for humans, not failover).
STALE_AFTER_INTERVALS = 1.6
DOWN_AFTER_INTERVALS = 2.0


def entity_of(body: Any) -> Optional[str]:
    """The affinity key of a JSON query body, if it names one."""
    if not isinstance(body, dict):
        return None
    for field in ENTITY_FIELDS:
        v = body.get(field)
        if isinstance(v, (str, int)):
            return str(v)
    return None


class RouterService:
    """Router core + scraper + routes; ``create_router_server`` wires
    it to a port."""

    def __init__(
        self,
        targets: List[Tuple[str, str]],
        partitions: Optional[int] = None,
        interval_s: Optional[float] = None,
        admin_key: Optional[str] = None,
        timeout_s: float = 5.0,
        fetch=None,
    ):
        if not targets:
            raise ValueError(
                "router needs at least one member target "
                "(--targets host:port,... or PIO_TPU_FLEET_TARGETS)"
            )
        self.admin_key = admin_key
        self.obs = MetricsRegistry()
        slog.install()
        self.obs.add_collector(slog.exposition_lines)
        self.obs.add_collector(fault_lines)
        self.agg = FleetAggregator(
            targets,
            registry=self.obs,
            interval_s=interval_s,
            stale_after_s=None,
            down_after_s=None,
            fetch=fetch,
        )
        # tighten the staleness machine to failover grade (the ctor
        # computed dashboard-grade defaults from the interval)
        self.agg.stale_after_s = STALE_AFTER_INTERVALS * self.agg.interval_s
        self.agg.down_after_s = DOWN_AFTER_INTERVALS * self.agg.interval_s
        self.core = ServingRouter(
            targets,
            registry=self.obs,
            partitions=partitions,
            timeout_s=timeout_s,
            forced_down_s=DOWN_AFTER_INTERVALS * self.agg.interval_s,
        )
        self._stop = threading.Event()
        self._ingest_thread: Optional[threading.Thread] = None
        self._seen_passes = 0
        self.rollout_metrics = RolloutMetrics(self.obs)
        self.rollout: Optional[RolloutController] = None
        self._rollout_count = 0
        self.health = HealthMonitor()
        self.health.add_readiness("first_scrape", self._check_first_scrape)
        self.router = Router()
        self.router.add("GET", "/", self.index)
        self.router.add("POST", "/queries\\.json", self.relay_query)
        self.router.add("GET", "/router\\.json", self.router_json)
        self.router.add("GET", "/fleet\\.json", self.fleet_json)
        self.router.add("POST", "/deploy", self.deploy)
        self.router.add("POST", "/rollout", self.start_rollout)
        self.router.add("POST", "/rollout/abort", self.abort_rollout)
        self.router.add("POST", "/rollout/approve", self.approve_rollout)
        self.router.add("GET", "/rollout\\.json", self.rollout_json)
        self.router.add("GET", "/metrics", self.get_metrics)
        self.router.add("GET", "/healthz", self.healthz)
        self.router.add("GET", "/readyz", self.readyz)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the scrape loop and the ingest pump (payload -> core
        after every completed scrape pass)."""
        self.agg.start()
        if self._ingest_thread is not None:
            return
        self._stop.clear()
        self._ingest_thread = threading.Thread(
            target=self._ingest_loop, name="router-ingest", daemon=True
        )
        self._ingest_thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._ingest_thread = self._ingest_thread, None
        if t is not None:
            t.join(timeout=2.0)
        ro = self.rollout
        if ro is not None:
            ro.stop()
        self.agg.stop()
        self.core.close()

    def _ingest_loop(self) -> None:
        poll = min(0.5, self.agg.interval_s / 4.0)
        while not self._stop.is_set():
            passes = self.agg.passes
            if passes != self._seen_passes:
                self._seen_passes = passes
                try:
                    self.core.ingest_fleet(self.agg.fleet_payload())
                except Exception:  # an ingest must never kill the pump
                    pass
            if self._stop.wait(poll):
                return

    def _check_first_scrape(self):
        if self.agg.passes < 1:
            return False, "no scrape pass completed yet"
        return True, f"{self.agg.passes} scrape passes"

    def _check_admin(self, req: Request) -> None:
        if self.admin_key is not None:
            if not keys_equal(req.bearer_key(), self.admin_key):
                raise HTTPError(401, "invalid admin accessKey")
        elif req.client_addr not in ("127.0.0.1", "::1"):
            raise HTTPError(
                403, "admin routes are loopback-only without an admin key"
            )

    # -- relay -------------------------------------------------------------
    def relay_query(self, req: Request):  # pio: hotpath=zerocopy
        """Both wires, one relay: the packed frame (or the JSON body's
        original bytes) goes member-ward untouched."""
        priority = req.headers.get(PRIORITY_HEADER.lower(), "")
        if req.packed is not None:
            out_body = req.packed   # zero-copy: bytes or memoryview
            entity = None
        else:
            out_body = req.raw_body
            entity = entity_of(req.body)
        try:
            status, reply, upstream_body, member = self.core.forward(
                "POST", "/queries.json", out_body, req.headers,
                entity_id=entity, priority=priority,
            )
        except Shed as s:
            raise HTTPError(
                s.status,
                f"router shed: {s.reason}",
                headers=retry_after_header(s.retry_after_s),
            ) from s
        ctype = reply.pop(
            "Content-Type", "application/json; charset=UTF-8"
        )
        reply["X-Pio-Router-Member"] = member
        return status, RawResponse(
            upstream_body, content_type=ctype, headers=reply
        )

    # -- admin / introspection ---------------------------------------------
    def deploy(self, req: Request) -> Tuple[int, Any]:
        """Manifest-verified rollout: push the instance's shard manifest
        to every member's ``/deploy.json``; only verified members get
        their generation flipped into rotation."""
        self._check_admin(req)
        body = req.body if isinstance(req.body, dict) else {}
        instance_id = body.get("engineInstanceId")
        if not instance_id:
            raise HTTPError(400, "engineInstanceId is required")
        from pio_tpu_torch.storage import Storage

        try:
            manifest = load_manifest(
                Storage.get_model_data_models(), instance_id
            )
        except Exception as e:
            raise HTTPError(
                502, f"cannot read shard manifest: {e}"
            ) from e
        results = []
        verified = 0
        for ms in self.core.ring_members():
            outcome, detail = push_deploy(
                ms.base_url, instance_id, manifest,
                timeout_s=max(self.core.timeout_s, 60.0),
                admin_key=self.admin_key,
            )
            self.core.note_deploy(ms.name, instance_id, outcome)
            verified += 1 if outcome == "verified" else 0
            results.append({
                "member": ms.name,
                "outcome": outcome,
                "detail": detail,
            })
        status = 200 if verified == len(results) else 502
        return status, {
            "engineInstanceId": instance_id,
            "sharded": manifest is not None,
            "verified": verified,
            "members": results,
        }

    def start_rollout(self, req: Request) -> Tuple[int, Any]:
        """Kick off a progressive rollout of one candidate instance.

        Body: ``{engineInstanceId, targets: "host:port,...", ...knobs}``
        (knob names match the ``config`` block of ``/rollout.json``).
        409 while another rollout is still live — one candidate at a
        time is the whole point of a judged rollout."""
        self._check_admin(req)
        body = req.body if isinstance(req.body, dict) else {}
        instance_id = body.get("engineInstanceId")
        if not instance_id:
            raise HTTPError(400, "engineInstanceId is required")
        ro = self.rollout
        if ro is not None and ro.active():
            raise HTTPError(
                409,
                f"rollout of {ro.cfg.candidate_instance!r} is still "
                f"{ro.stage}; abort it first (POST /rollout/abort)",
            )
        from pio_tpu_torch.obs.fleet import parse_targets

        targets = parse_targets(body.get("targets") or "")
        cfg = RolloutConfig(
            candidate_instance=str(instance_id),
            candidate_targets=targets,
            incumbent_instance=body.get("incumbentInstance"),
        )
        for key, attr, cast in (
            ("shadowRate", "shadow_rate", float),
            ("shadowMinSamples", "shadow_min_samples", int),
            ("shadowHoldSeconds", "shadow_hold_s", float),
            ("mismatchLimit", "mismatch_limit", float),
            ("scoreTolerance", "score_tolerance", float),
            ("latencyLimitX", "latency_limit_x", float),
            ("canaryFraction", "canary_fraction", float),
            ("canaryHoldSeconds", "canary_hold_s", float),
            ("canaryMinRequests", "canary_min_requests", int),
            ("judgeIntervalSeconds", "judge_interval_s", float),
            ("judgeFastSeconds", "judge_fast_s", float),
            ("judgeSlowSeconds", "judge_slow_s", float),
            ("burnLimit", "burn_limit", float),
            ("availabilityObjective", "availability_objective", float),
            ("downAfterFailures", "down_after_failures", int),
            ("auto", "auto", bool),
        ):
            if body.get(key) is not None:
                setattr(cfg, attr, cast(body[key]))
        try:
            cfg.validate()
        except ValueError as e:
            raise HTTPError(400, str(e)) from e
        self._rollout_count += 1
        controller = RolloutController(
            self.core, cfg, self.rollout_metrics,
            fetch=self._rollout_fetch,
            admin_key=self.admin_key,
            generation=self._rollout_count,
            started_by=body.get("by") or "operator",
        )
        self.rollout = controller
        controller.start()
        return 202, {"rollout": controller.payload()}

    def abort_rollout(self, req: Request) -> Tuple[int, Any]:
        self._check_admin(req)
        ro = self.rollout
        if ro is None:
            raise HTTPError(404, "no rollout has been started")
        ro.abort(by=str(req.client_addr or "operator"))
        return 200, {"rollout": ro.payload()}

    def approve_rollout(self, req: Request) -> Tuple[int, Any]:
        """Release a non-auto rollout's current hold gate."""
        self._check_admin(req)
        ro = self.rollout
        if ro is None:
            raise HTTPError(404, "no rollout has been started")
        ro.approve()
        return 200, {"rollout": ro.payload()}

    def rollout_json(self, req: Request) -> Tuple[int, Any]:
        ro = self.rollout
        if ro is None:
            return 200, {"stage": "idle", "generation": 0, "trail": []}
        return 200, ro.payload()

    @property
    def _rollout_fetch(self):
        # the aggregator's injectable fetch doubles as the controller's
        # (so socketless tests fake both planes with one callable)
        return self.agg._fetch

    def index(self, req: Request) -> Tuple[int, Any]:
        return 200, {
            "service": "pio-tpu-routerd",
            "members": [m.name for m in self.agg.members()],
            "endpoints": [
                "/queries.json", "/router.json", "/fleet.json",
                "/deploy", "/rollout", "/rollout.json", "/metrics",
                "/healthz", "/readyz",
            ],
        }

    def router_json(self, req: Request) -> Tuple[int, Any]:
        snap = self.core.snapshot()
        snap["scrape"] = {
            "intervalSeconds": self.agg.interval_s,
            "staleAfterSeconds": self.agg.stale_after_s,
            "downAfterSeconds": self.agg.down_after_s,
            "passes": self.agg.passes,
        }
        return 200, snap

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


def create_router_server(
    targets: List[Tuple[str, str]],
    host: str = "0.0.0.0",
    port: int = 8500,
    partitions: Optional[int] = None,
    interval_s: Optional[float] = None,
    admin_key: Optional[str] = None,
    timeout_s: float = 5.0,
    fetch=None,
) -> JsonHTTPServer:
    """Build (unstarted) router daemon; the caller starts the HTTP
    server and then the scrape/ingest loops via ``server.service``."""
    service = RouterService(
        targets,
        partitions=partitions,
        interval_s=interval_s,
        admin_key=admin_key,
        timeout_s=timeout_s,
        fetch=fetch,
    )
    server = JsonHTTPServer(
        service.router, host, port, name="pio-tpu-routerd"
    )
    server.service = service
    return server
