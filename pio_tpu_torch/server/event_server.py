"""Event Server — REST ingestion daemon (:7070 by default).

The port's copy of ``pio_tpu/server/event_server.py`` (the port imports
nothing of ``pio_tpu``). Routes:

    GET    /                          alive check
    POST   /events.json               ingest one event (201 + eventId)
    GET    /events.json               filtered query (reversed by default)
    GET    /events/search.json?q=...  BM25-ranked full-text search (the
                                      searchable store; 501 elsewhere)
    GET    /events/<id>.json          fetch one
    DELETE /events/<id>.json          delete one
    POST   /batch/events.json         ≤50 events, per-item statuses
    GET    /stats.json                per-app counters, request latency
                                      and stage summary (``?window=S``)
    GET    /metrics                   Prometheus text (requests, stages,
                                      group commit, retries, SLO, QoS)
    GET    /traces.json               recent ingest traces merged with the
                                      group committer's flush traces
                                      (``?slow=1``, ``?id=``, ``?commits=0``)
    GET    /debug/hotpath.json        per-stage budget of the write paths
    GET    /logs.json                 structured-log ring
    GET    /slo.json                  burn rates of the declared SLOs
    GET    /qos.json                  admission-control state
    GET    /faults.json               armed failpoints, trigger counts
    GET    /storage.json              event-store backend (and topology)
    GET    /healthz, /readyz          liveness (group commit), readiness
    POST   /webhooks/<name>.json      JSON webhook connector
    POST   /webhooks/<name>.form      form webhook connector
    GET    /plugins.json              installed plugins

Auth: ``accessKey`` query param (or ``Authorization`` header); the key maps
to an app and an optional event-name whitelist. ``channel`` selects a named
sub-stream (must exist; 400 otherwise). Every write is acknowledged only
after the transaction that carries it committed, at the storage's
durability mode (``PIO_TPU_DURABILITY``).

The write paths are traced (:data:`EVENT_STAGES`, ``X-Pio-Trace`` adopted
and echoed), admitted through a QoS gate when a policy is set (``qos=``
or ``PIO_TPU_QOS``: engine and per-key buckets, a concurrency limit, the
storage circuit breaker around every insert, 429/503 with
``Retry-After``), and pass the input blockers and sniffers of
``server/plugins.py``.
"""

from __future__ import annotations

import datetime as _dt
import logging
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

from pio_tpu_torch import faults
from pio_tpu_torch.analysis.runtime import make_lock
from pio_tpu_torch.data.event import Event, EventValidationError
from pio_tpu_torch.obs import (
    REGISTRY, HealthMonitor, MetricsRegistry, RequestWindow, TRACE_HEADER,
    Tracer, hotpath_payload, monotonic_s, parse_trace_header,
)
from pio_tpu_torch.obs import slog
from pio_tpu_torch.obs.slo import (
    engine_for_specs, slo_payload, slow_threshold_s,
)
from pio_tpu_torch.qos import (
    PRIORITY_HEADER, QoSGate, qos_payload, resolve_policy,
    retry_after_header,
)
from pio_tpu_torch.server.http import (
    HTTPError, JsonHTTPServer, Request, Router, float_param, int_param,
    json_response, logs_route, metrics_response,
)
from pio_tpu_torch.server.plugins import installed_plugins
from pio_tpu_torch.server.webhooks import (
    FORM_CONNECTORS,
    JSON_CONNECTORS,
    ConnectorError,
    parse_form,
)
from pio_tpu_torch.storage.groupcommit import COMMIT_TRACER
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.storage.retry import retrying
from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.eventserver")

#: the process-global families of the storage layer this server's
#: ``/metrics`` shows: the group committer's flushes and batch sizes, its
#: flush traces' stage histogram, the retry counter, and the partitioned
#: log's appends and follower acks (the storage layer has no server
#: instance of its own, so a failover drill watches them here)
STORAGE_METRIC_PREFIXES = (
    "pio_tpu_groupcommit_", "pio_tpu_commit_", "pio_tpu_storage_retries_",
    "pio_tpu_partlog_", "pio_tpu_repl_",
)

MAX_BATCH = 50

#: ingest-path plugin hooks (reference EventServerPlugin): callables
#: (app_id, channel_id, event_dict) -> None, may raise HTTPError to block.
INPUT_BLOCKERS: List[Callable] = []
INPUT_SNIFFERS: List[Callable] = []

#: ingest-path trace stages, in request order: socket read + body parse
#: (HTTP layer), QoS admission + auth, JSON → Event binding, whitelist +
#: input blockers, storage insert/group-commit, response write. Top-level
#: stages TILE the request (their durations sum to the end-to-end time);
#: /debug/hotpath.json budgets against exactly that.
EVENT_STAGES = ("accept", "admit", "parse", "validate", "store", "write")

#: dotted substages attribute time WITHIN the store stage: queueing
#: behind another leader's group-commit flush, and the flush that
#: carried this event (both measured submitter-side in groupcommit).
EVENT_SUBSTAGES = ("store.commit_wait", "store.flush")


class _Stats:
    """Rolling per-app counters (reference ``Stats``/``StatsActor``),
    optionally mirrored into an obs Counter so ``/metrics`` exposition
    and the JSON stats can never disagree."""

    def __init__(self, counter=None):
        self._lock = make_lock("event.stats")
        self._counter = counter
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        # (app_id, event, entity_type, status) -> count
        self.counts: Dict[Tuple[int, str, str, int], int] = {}
        #: the same key -> its counter cell, resolved once: a batch ticks
        #: every event it stores, and resolving the labels each time cost
        #: more than the increment
        self._cells: Dict[Tuple[int, str, str, int], Any] = {}

    def tick(self, app_id: int, event: str, entity_type: str, status: int):
        key = (app_id, event, entity_type, status)
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1
            cell = self._cells.get(key)
        if cell is None and self._counter is not None:
            cell = self._counter.labels(str(app_id), event, entity_type,
                                        str(status))
            with self._lock:
                self._cells[key] = cell
        if cell is not None:
            cell.inc()

    def to_dict(self) -> dict:
        with self._lock:
            by_app: Dict[int, list] = {}
            for (app_id, event, etype, status), n in sorted(self.counts.items()):
                by_app.setdefault(app_id, []).append(
                    {
                        "event": event,
                        "entityType": etype,
                        "status": status,
                        "count": n,
                    }
                )
        return {
            "startTime": self.start_time.isoformat(),
            "apps": [
                {"appId": app_id, "counts": counts}
                for app_id, counts in by_app.items()
            ],
        }


def _parse_limit(params) -> Optional[int]:
    """Shared ``limit`` query-param contract for the read routes:
    default 20 (the reference default), ``-1`` = explicit no-limit,
    anything below -1 or non-integer → 400."""
    if "limit" not in params:
        return 20
    try:
        limit = int(params["limit"])
    except ValueError:
        raise HTTPError(400, f"invalid limit {params['limit']!r}")
    if limit < -1:
        raise HTTPError(400, "limit must be >= -1")
    return None if limit == -1 else limit


class EventServerService:
    """Route handlers, separable from the HTTP loop for direct testing."""

    #: positive access-key lookups are cached this long — the per-request
    #: metadata SELECT was a measurable slice of single-event ingest cost.
    #: Bounds key-revocation latency to the TTL (misses are never cached,
    #: so a fresh key works immediately).
    AUTH_CACHE_TTL_S = 2.0

    def __init__(self, slos: Optional[List[str]] = None,
                 qos: Optional[Any] = None):
        #: per-instance registry — see query_server (test servers must
        #: not cross-pollinate scrapes through a process global)
        self.obs = MetricsRegistry()
        self._events_counter = self.obs.counter(
            "pio_tpu_events_ingested_total",
            "Events by app/event/status",
            ("app_id", "event", "entity_type", "status"),
        )
        #: full-request latency of the ingest write paths — the latency
        #: SLO source (see query_server's pio_tpu_request_seconds)
        self._request_hist = self.obs.histogram(
            "pio_tpu_request_seconds",
            "Full-request wall seconds of the event write paths",
            ("engine_id",),
        )
        self._request_cell = self._request_hist.labels("eventserver")
        #: end-to-end latency (accept→write, from the post-write hook) —
        #: the denominator of the /debug/hotpath.json attribution budget
        self._e2e_hist = self.obs.histogram(
            "pio_tpu_e2e_seconds",
            "End-to-end wall seconds of the event write paths (socket "
            "read through response write)",
            ("engine_id",),
        )
        self._e2e_cell = self._e2e_hist.labels("eventserver")
        self.tracer = Tracer(
            "event", registry=self.obs,
            stages=EVENT_STAGES + EVENT_SUBSTAGES,
        )
        # tail-based slow-trace capture (see query_server's twin)
        self.tracer.slow_threshold_fn = lambda: slow_threshold_s(
            self.slo, self._e2e_cell)
        self.req_window = RequestWindow()
        self.stats = _Stats(counter=self._events_counter)
        slog.install()
        self.obs.add_collector(slog.exposition_lines)
        self.obs.add_collector(faults.exposition_lines)
        # the storage layer meters on the process-global registry (it has
        # no server instance of its own); bridge its slice into this
        # scrape
        self.obs.add_collector(
            lambda: REGISTRY.render_prefixed(STORAGE_METRIC_PREFIXES)
        )
        # -- health probes --
        self.health = HealthMonitor()
        self.health.add_liveness("group_commit", self._check_group_commit)
        self.health.add_readiness("storage", self._check_storage_ready)
        # -- SLO engine (optional; specs from the caller or PIO_TPU_SLO) --
        if slos is None:
            env_slos = knobs.knob_str("PIO_TPU_SLO")
            slos = [s for s in env_slos.split(",") if s.strip()]
        self.slo = None
        if slos:
            self.slo = engine_for_specs(
                slos, self.obs,
                availability_source=self._availability_good_total,
                latency_cell_getter=lambda: self._request_cell,
            )
        # -- QoS: engine-wide + per-access-key token buckets on
        # the write paths, breaker around storage inserts. The event
        # server never runs in SO_REUSEPORT pool mode, so its buckets
        # are process-local by construction.
        policy = resolve_policy(qos)
        self.qos = (
            QoSGate(policy, self.obs, scope="eventserver")
            if policy is not None else None
        )
        self._storage_breaker = (
            self.qos.breaker("storage") if self.qos is not None else None
        )
        self._auth_cache: dict = {}
        self._auth_gen = 0  # bumped by invalidation; fences re-caching
        self._auth_cache_lock = make_lock("event.auth_cache")
        # a Storage.reset() within AUTH_CACHE_TTL_S must not keep serving
        # AccessKey records from the store that was just dropped
        Storage.add_reset_hook(self.invalidate_auth_cache)
        self.router = Router()
        r = self.router
        r.add("GET", "/", self.alive)
        r.add("POST", "/events\\.json", self.create_event)
        r.add("GET", "/events\\.json", self.find_events)
        r.add("GET", "/events/search\\.json", self.search_events)
        r.add("GET", "/events/([^/]+)\\.json", self.get_event)
        r.add("DELETE", "/events/([^/]+)\\.json", self.delete_event)
        r.add("POST", "/batch/events\\.json", self.batch_events)
        r.add("GET", "/stats\\.json", self.get_stats)
        r.add("GET", "/metrics", self.get_metrics)
        r.add("GET", "/traces\\.json", self.get_traces)
        r.add("GET", "/debug/hotpath\\.json", self.get_hotpath)
        r.add("GET", "/logs\\.json", logs_route)
        r.add("GET", "/slo\\.json",
              lambda req: (200, slo_payload(self.slo)))
        r.add("GET", "/qos\\.json", lambda req: (200, qos_payload(self.qos)))
        r.add("GET", "/faults\\.json", self.get_faults)
        r.add("GET", "/storage\\.json", self.get_storage)
        r.add("GET", "/healthz", self.healthz)
        r.add("GET", "/readyz", self.readyz)
        r.add("POST", "/webhooks/([^/]+)\\.json", self.webhook_json)
        r.add("POST", "/webhooks/([^/]+)\\.form", self.webhook_form)
        r.add("GET", "/plugins\\.json",
              lambda req: (200, installed_plugins()))

    # -- auth ---------------------------------------------------------------
    def invalidate_auth_cache(self) -> None:
        """Drop cached positive key lookups (called on Storage.reset and
        available to key-mutation paths; the TTL still bounds staleness
        for out-of-process mutations). The generation bump fences an
        in-flight ``_auth`` that already read from the OLD store: its
        insert is discarded rather than repopulating the cache with a
        record from a store that no longer exists."""
        with self._auth_cache_lock:
            self._auth_gen += 1
            self._auth_cache.clear()

    def _auth(self, req: Request) -> Tuple[int, Optional[int], tuple]:
        """accessKey+channel → (app_id, channel_id, event_whitelist)."""
        key = req.bearer_key()
        if not key:
            raise HTTPError(401, "missing accessKey")
        now = monotonic_s()
        with self._auth_cache_lock:
            hit = self._auth_cache.get(key)
            gen = self._auth_gen
        ak = hit[1] if hit is not None and hit[0] > now else None
        if ak is None:
            ak = Storage.get_meta_data_access_keys().get(key)
            if ak is not None:
                with self._auth_cache_lock:
                    if len(self._auth_cache) > 4096:
                        self._auth_cache.clear()  # crude bound; refills
                    if self._auth_gen == gen:  # no invalidation raced us
                        self._auth_cache[key] = (
                            now + self.AUTH_CACHE_TTL_S, ak
                        )
        if ak is None:
            raise HTTPError(401, "invalid accessKey")
        channel_id = None
        channel = req.params.get("channel")
        if channel:
            chans = Storage.get_meta_data_channels().get_by_app_id(ak.app_id)
            match = [c for c in chans if c.name == channel]
            if not match:
                raise HTTPError(400, f"invalid channel {channel!r}")
            channel_id = match[0].id
        return ak.app_id, channel_id, ak.events

    def _check_whitelist(self, event_name: str, whitelist: tuple):
        if whitelist and event_name not in whitelist:
            raise HTTPError(
                403, f"accessKey does not allow event {event_name!r}"
            )

    # -- handlers -----------------------------------------------------------
    def alive(self, req: Request):
        return 200, {"status": "alive"}

    # -- health/readiness ---------------------------------------------------
    def _check_group_commit(self):
        """Liveness via the event store's group committer, when it has
        one: the commit lock must be acquirable (a leader wedged inside
        a hung backend flush holds it forever — see
        :meth:`GroupCommitter.probe`). Backends without group commit
        pass vacuously."""
        try:
            gc = getattr(Storage.get_levents(), "_gc", None)
        except Exception as e:
            return False, f"event store unavailable: {e}"
        if gc is None:
            return True, "no group committer (backend writes directly)"
        return gc.probe(timeout=0.5)

    def _check_storage_ready(self):
        """Readiness: both stores this server writes/authenticates
        against must answer."""
        Storage.get_meta_data_access_keys()
        Storage.get_levents()
        return True, "event + metadata stores reachable"

    def _availability_good_total(self):
        w = self.req_window
        total = w.count
        errors = w.errors
        return total - errors, total

    def healthz(self, req: Request):
        ok, report = self.health.liveness()
        return (200 if ok else 503), report

    def readyz(self, req: Request):
        ok, report = self.health.readiness()
        return (200 if ok else 503), report

    def get_faults(self, req: Request):
        """Armed failpoints + trigger counts (``pio_tpu_torch.faults``)."""
        return 200, faults.snapshot()

    def get_storage(self, req: Request):
        """Event-store topology. Backends that can describe themselves
        (the partitioned log's partition table, replication positions
        and snapshot watermarks) do so via a duck-typed ``topology()``;
        everything else reports just its type."""
        try:
            lev = Storage.get_levents()
        except Exception as e:
            raise HTTPError(503, f"event store unavailable: {e}")
        topo = getattr(lev, "topology", None)
        if topo is None:
            return 200, {"backend": type(lev).__name__, "topology": None}
        return 200, topo()

    def _qos_admit(self, req: Request):
        """Admission for the write paths: engine bucket, THEN the
        caller's per-access-key bucket — one chatty key exhausts its own
        budget before it can dent everyone else's. Sheds raise 429/503
        with ``Retry-After`` (ingest has no stale-cache rescue: replaying
        an old write would be a lie, not a degradation)."""
        if self.qos is None:
            return None
        adm = self.qos.admit(
            priority=req.header(PRIORITY_HEADER), key=req.bearer_key()
        )
        if not adm.ok:
            self.qos.count_shed(adm.reason)
            status = (
                429 if adm.reason in ("rate_limit", "key_rate_limit")
                else 503
            )
            raise HTTPError(
                status, f"overloaded: {adm.reason}",
                headers=retry_after_header(adm.retry_after_s),
            )
        return adm

    def _admit_then_auth(self, req: Request):
        """Admission BEFORE auth: the rate limiter exists to shed a
        flood before it reaches the storage-backed access-key lookup, so
        it cannot sit behind that lookup (the 2s positive cache does not
        help a unique-key flood — misses are never cached). The per-key
        bucket keys on the PRESENTED bearer key — a header read, no
        storage — so an invalid key burns its own bucket, not a real
        tenant's. The admission is released if auth then rejects.

        Sheds are still recorded into the request window (they feed the
        SLO engine's error accounting); auth failures are not, matching
        the pre-QoS behavior."""
        t0 = monotonic_s()
        try:
            adm = self._qos_admit(req)
        except HTTPError:
            dur_s = monotonic_s() - t0
            self.req_window.record(dur_s * 1e3, True)
            self._request_cell.observe(dur_s)
            raise
        try:
            app_id, channel_id, whitelist = self._auth(req)
        except BaseException:
            if adm is not None:
                adm.release()
            raise
        return adm, app_id, channel_id, whitelist

    def _guarded_insert(self, fn):
        """Run a storage write through retry + circuit breaker: an open
        breaker fails fast with 503 + Retry-After instead of queueing
        more work onto a dependency that is already drowning, and INSIDE
        a breaker call transient errors (SQLITE_BUSY, a blob server
        mid-restart, injected faults) are retried with jittered backoff —
        the breaker scores the final outcome, so a request saved by a
        retry counts as a success, not ``attempts`` failures."""
        if self._storage_breaker is None:
            return retrying(fn, site="eventserver.insert")
        call = self._storage_breaker.acquire()
        if not call.allowed:
            self.qos.count_shed("breaker")
            raise HTTPError(
                503, "overloaded: storage circuit breaker open",
                headers=retry_after_header(call.retry_after_s),
            )
        try:
            out = retrying(fn, site="eventserver.insert")
            call.success()
            return out
        except Exception:
            call.failure()
            raise
        finally:
            # releases a half-open probe grant if the call was abandoned
            # (e.g. a BaseException); no-op after success()/failure()
            call.cancel()

    def _validate_one(self, d: Any, app_id: int, channel_id, whitelist,
                      tr=None):
        """JSON → validated Event (whitelist + input blockers applied)."""
        sp = tr.span if tr is not None else (lambda stage: nullcontext())
        with sp("parse"):
            if not isinstance(d, dict):
                raise EventValidationError("event must be a JSON object")
            event = Event.from_api_dict(d)
        with sp("validate"):
            self._check_whitelist(event.event, whitelist)
            for blocker in INPUT_BLOCKERS:
                try:
                    blocker(app_id, channel_id, d)
                except ValueError as e:
                    # input blockers veto with ValueError → client 400
                    raise EventValidationError(str(e))
        return event

    def _post_ingest(self, d: Any, event: Event, app_id: int, channel_id):
        for sniffer in INPUT_SNIFFERS:
            try:
                sniffer(app_id, channel_id, d)
            except Exception:
                log.exception("input sniffer failed")
        self.stats.tick(app_id, event.event, event.entity_type, 201)

    def _ingest_one(self, d: Any, app_id: int, channel_id, whitelist,
                    tr=None) -> str:
        event = self._validate_one(d, app_id, channel_id, whitelist, tr)
        rel_store = tr.elapsed_s if tr is not None else 0.0
        event_id = self._guarded_insert(
            lambda: Storage.get_levents().insert(
                event, app_id, channel_id
            )
        )
        self._post_ingest(d, event, app_id, channel_id)
        if tr is not None:
            # end-aligned through the post-ingest hooks (sniffers,
            # per-app stats) so store tiles flush against write
            tr.add_span(
                "store", tr.elapsed_s - rel_store, rel_start_s=rel_store
            )
        return event_id

    def _begin_waterfall(self, tr, req: Request, t_start: float,
                         t_admitted: float) -> None:
        """Head of every write-path waterfall: the trace opens only
        AFTER admission + auth, so rebase it to the socket read and
        record the accept/admit window it missed."""
        tr.rebase(req.read_s + (t_admitted - t_start))
        tr.add_span("accept", req.read_s, rel_start_s=0.0)
        # end-aligned to NOW, so the trace-open/rebase work just done
        # stays inside the budget instead of leaking between spans
        tr.add_span(
            "admit", tr.elapsed_s - req.read_s, rel_start_s=req.read_s
        )

    def _arm_write_span(self, tr, req: Request) -> None:
        """Tail of the waterfall: record the response write + the TRUE
        end-to-end latency once the bytes hit the socket. The span is
        anchored at HANDLER completion (arm time), not the socket write
        — the return path between them is request time the top-level
        stages must keep tiling."""
        rel_done_s = tr.elapsed_s

        def _written(write_s: float, _tr=tr, _rel=rel_done_s):
            _tr.add_span("write", _tr.elapsed_s - _rel, rel_start_s=_rel)
            _tr.extend_total()
            self._e2e_cell.observe(_tr.elapsed_s, exemplar=_tr.trace_id)

        req.on_written = _written

    def create_event(self, req: Request):
        t_start = monotonic_s()
        # cross-process propagation: a traced caller (e.g. the query
        # server's feedback loop, or a bench client) names the trace this
        # ingest joins — one id spans client, server, and commit leader
        in_tid, in_parent = parse_trace_header(req.header(TRACE_HEADER))
        adm, app_id, channel_id, whitelist = self._admit_then_auth(req)
        t0 = monotonic_s()
        error = True
        trace_id = None
        try:
            with self.tracer.trace(
                "event", trace_id=in_tid, parent=in_parent
            ) as tr:
                trace_id = tr.trace_id
                self._begin_waterfall(tr, req, t_start, t0)
                try:
                    event_id = self._ingest_one(
                        req.body, app_id, channel_id, whitelist, tr
                    )
                except EventValidationError as e:
                    tr.mark_error()
                    self.stats.tick(app_id, "<invalid>", "<invalid>", 400)
                    return 400, {"message": str(e)}
                error = False
                self._arm_write_span(tr, req)
                return 201, json_response(
                    {"eventId": event_id}, {TRACE_HEADER: tr.trace_id}
                )
        finally:
            if adm is not None:
                adm.release()
            dur_s = monotonic_s() - t0
            self.req_window.record(dur_s * 1e3, error)
            self._request_cell.observe(dur_s, exemplar=trace_id)

    def batch_events(self, req: Request):
        t_start = monotonic_s()
        in_tid, in_parent = parse_trace_header(req.header(TRACE_HEADER))
        adm, app_id, channel_id, whitelist = self._admit_then_auth(req)
        try:
            if not isinstance(req.body, list):
                return 400, {"message": "batch body must be a JSON array"}
            if len(req.body) > MAX_BATCH:
                return 400, {
                    "message":
                        f"batch size {len(req.body)} exceeds {MAX_BATCH}"
                }
            t0 = monotonic_s()
            error = True
            trace_id = None
            try:
                with self.tracer.trace(
                    "batch", trace_id=in_tid, parent=in_parent,
                    batchSize=len(req.body),
                ) as tr:
                    trace_id = tr.trace_id
                    self._begin_waterfall(tr, req, t_start, t0)
                    status, results = self._batch_events(
                        req, app_id, channel_id, whitelist, tr
                    )
                    error = False
                    self._arm_write_span(tr, req)
                    return status, json_response(
                        results, {TRACE_HEADER: tr.trace_id}
                    )
            finally:
                dur_s = monotonic_s() - t0
                self.req_window.record(dur_s * 1e3, error)
                self._request_cell.observe(dur_s, exemplar=trace_id)
        finally:
            if adm is not None:
                adm.release()

    def _batch_events(self, req, app_id, channel_id, whitelist, tr):
        # validate every item first (per-item status contract), then land
        # the valid ones in ONE bulk storage write (insert_batch — a
        # single transaction/commit on backends that support it)
        results: list = [None] * len(req.body)
        valid = []
        with tr.span("validate"):
            for k, d in enumerate(req.body):
                try:
                    event = self._validate_one(
                        d, app_id, channel_id, whitelist
                    )
                    valid.append((k, d, event))
                except (EventValidationError, HTTPError) as e:
                    status = e.status if isinstance(e, HTTPError) else 400
                    results[k] = {"status": status, "message": str(e)}
        if valid:
            with tr.span("store"):
                ids = self._guarded_insert(
                    lambda: Storage.get_levents().insert_batch(
                        [e for _, _, e in valid], app_id, channel_id
                    )
                )
            if len(ids) != len(valid):  # a broken backend override must
                # surface as per-item errors, not nulls in the response
                log.error(
                    "insert_batch returned %d ids for %d events",
                    len(ids), len(valid),
                )
                for k, _, _ in valid[len(ids):]:
                    results[k] = {
                        "status": 500,
                        "message": "storage returned no id for this event",
                    }
                valid = valid[: len(ids)]
            for (k, d, event), eid in zip(valid, ids):
                self._post_ingest(d, event, app_id, channel_id)
                results[k] = {"status": 201, "eventId": eid}
        return 200, results

    def get_event(self, req: Request):
        app_id, channel_id, _ = self._auth(req)
        event = Storage.get_levents().get(req.path_args[0], app_id, channel_id)
        if event is None:
            return 404, {"message": "event not found"}
        return 200, event.to_api_dict()

    def delete_event(self, req: Request):
        app_id, channel_id, _ = self._auth(req)
        found = Storage.get_levents().delete(req.path_args[0], app_id, channel_id)
        if not found:
            return 404, {"message": "event not found"}
        return 200, {"message": "deleted"}

    def find_events(self, req: Request):
        app_id, channel_id, _ = self._auth(req)
        p = req.params

        def parse_time(name):
            v = p.get(name)
            if v is None:
                return None
            try:
                return _dt.datetime.fromisoformat(v.replace("Z", "+00:00"))
            except ValueError:
                raise HTTPError(400, f"cannot parse {name}={v!r}")

        limit = _parse_limit(p)
        events = Storage.get_levents().find(
            app_id,
            channel_id=channel_id,
            start_time=parse_time("startTime"),
            until_time=parse_time("untilTime"),
            entity_type=p.get("entityType"),
            entity_id=p.get("entityId"),
            event_names=[p["event"]] if p.get("event") else None,
            target_entity_type=p.get("targetEntityType"),
            target_entity_id=p.get("targetEntityId"),
            limit=limit,
            reversed_order=p.get("reversed", "true").lower() != "false",
        )
        return 200, [e.to_api_dict() for e in events]

    def search_events(self, req: Request):
        """GET /events/search.json?q=<fts query> — BM25-ranked full-text
        search, available when the event store is the searchable backend
        (the Elasticsearch-analog capability, surfaced over REST)."""
        app_id, channel_id, _ = self._auth(req)
        q = req.params.get("q")
        if not q:
            raise HTTPError(400, "missing query param q")
        le = Storage.get_levents()
        if not hasattr(le, "search"):
            raise HTTPError(
                501,
                "the configured event store does not support search; "
                "set the EVENTDATA source TYPE=searchable",
            )
        limit = _parse_limit(req.params)
        from pio_tpu_torch.storage.searchable import SearchError

        try:
            events = le.search(app_id, q, channel_id=channel_id, limit=limit)
        except SearchError as e:
            raise HTTPError(400, str(e))
        return 200, [e.to_api_dict() for e in events]

    def get_stats(self, req: Request):
        """Per-app counters (reference shape) PLUS the query-server
        parity block: request count/errors and latency percentiles for
        the ingest write path; ``?window=SECONDS`` narrows to the
        trailing window (reservoir-backed, like the query server)."""
        window_s = float_param(req.params, "window", 0.0, lo=0.0)
        if window_s > 0:
            return 200, self.req_window.window(window_s)
        out = self.stats.to_dict()
        out.update(self.req_window.to_dict())
        stages = self.tracer.stage_summary(EVENT_STAGES)
        if stages:
            out["stages"] = stages
        return 200, out

    def get_metrics(self, req: Request):
        return 200, metrics_response(self.obs.render())

    def get_hotpath(self, req: Request):
        """Per-stage latency budget of the ingest write paths (count/
        avg/p50/p95 + attributed fraction of the end-to-end average)."""
        return 200, hotpath_payload(
            self.tracer, self._e2e_cell,
            stage_order=EVENT_STAGES + EVENT_SUBSTAGES, pool=False,
            slow_threshold_s=slow_threshold_s(self.slo, self._e2e_cell),
        )

    def get_traces(self, req: Request):
        """Recent ingest traces, slowest first, MERGED with the group-
        commit leader's flush traces (each links the member requests it
        carried — the cross-process join of the event path). ``?slow=1``
        serves the tail-capture ring; ``?id=`` looks up one trace across
        the request, slow, and commit rings; ``?commits=0`` restricts to
        request traces."""
        n = int_param(req.params, "n", 20, lo=0, hi=self.tracer._ring_cap)
        tid = req.params.get("id")
        if tid:
            found = self.tracer.find(tid) or COMMIT_TRACER.find(tid)
            if found is None:
                raise HTTPError(404, f"trace {tid} not in any ring")
            return 200, {"traces": [found]}
        if req.params.get("slow") in ("1", "true"):
            return 200, {"traces": self.tracer.slow(n)}
        order = req.params.get("order", "slowest")
        slowest = order != "recent"
        traces = self.tracer.recent(n, slowest=slowest)
        if req.params.get("commits", "1") != "0":
            traces += COMMIT_TRACER.recent(n, slowest=slowest)
            key = (
                (lambda t: t.get("totalMs") or 0.0) if slowest
                else (lambda t: t.get("wallTime") or 0.0)
            )
            traces = sorted(traces, key=key, reverse=True)[:n]
        return 200, {"traces": traces}

    def webhook_json(self, req: Request):
        t_start = monotonic_s()
        in_tid, in_parent = parse_trace_header(req.header(TRACE_HEADER))
        adm, app_id, channel_id, whitelist = self._admit_then_auth(req)
        try:
            connector = JSON_CONNECTORS.get(req.path_args[0])
            if connector is None:
                return 404, {
                    "message": f"no JSON connector {req.path_args[0]!r}"
                }
            if req.body is not None and not isinstance(req.body, dict):
                return 400, {
                    "message": "webhook payload must be a JSON object"
                }
            t0 = monotonic_s()
            error = True
            trace_id = None
            try:
                with self.tracer.trace(
                    "webhook", trace_id=in_tid, parent=in_parent
                ) as tr:
                    trace_id = tr.trace_id
                    self._begin_waterfall(tr, req, t_start, t0)
                    try:
                        d = connector.to_event_dict(req.body or {})
                        event_id = self._ingest_one(
                            d, app_id, channel_id, whitelist, tr
                        )
                    except (ConnectorError, EventValidationError) as e:
                        tr.mark_error()
                        return 400, {"message": str(e)}
                    error = False
                    self._arm_write_span(tr, req)
                    return 201, json_response(
                        {"eventId": event_id}, {TRACE_HEADER: tr.trace_id}
                    )
            finally:
                dur_s = monotonic_s() - t0
                self.req_window.record(dur_s * 1e3, error)
                self._request_cell.observe(dur_s, exemplar=trace_id)
        finally:
            if adm is not None:
                adm.release()

    def webhook_form(self, req: Request):
        t_start = monotonic_s()
        in_tid, in_parent = parse_trace_header(req.header(TRACE_HEADER))
        adm, app_id, channel_id, whitelist = self._admit_then_auth(req)
        try:
            connector = FORM_CONNECTORS.get(req.path_args[0])
            if connector is None:
                return 404, {
                    "message": f"no form connector {req.path_args[0]!r}"
                }
            form = parse_form(
                req.raw_body.decode("utf-8", errors="replace")
                if req.raw_body
                else ""
            )
            t0 = monotonic_s()
            error = True
            trace_id = None
            try:
                with self.tracer.trace(
                    "webhook", trace_id=in_tid, parent=in_parent
                ) as tr:
                    trace_id = tr.trace_id
                    self._begin_waterfall(tr, req, t_start, t0)
                    try:
                        d = connector.to_event_dict(form)
                        event_id = self._ingest_one(
                            d, app_id, channel_id, whitelist, tr
                        )
                    except (ConnectorError, EventValidationError) as e:
                        tr.mark_error()
                        return 400, {"message": str(e)}
                    error = False
                    self._arm_write_span(tr, req)
                    return 201, json_response(
                        {"eventId": event_id}, {TRACE_HEADER: tr.trace_id}
                    )
            finally:
                dur_s = monotonic_s() - t0
                self.req_window.record(dur_s * 1e3, error)
                self._request_cell.observe(dur_s, exemplar=trace_id)
        finally:
            if adm is not None:
                adm.release()


def create_event_server(
    host: str = "0.0.0.0", port: int = 7070,
    slos: Optional[List[str]] = None,
    qos: Optional[Any] = None,
) -> JsonHTTPServer:
    """Build (unstarted) server — reference ``EventServer.createEventServer``.
    ``slos`` (specs, else ``PIO_TPU_SLO``) and ``qos`` (a spec or policy,
    else ``PIO_TPU_QOS``) configure the SLO engine and the QoS gate; the
    plugin modules of ``PIO_TPU_PLUGINS`` load first."""
    from pio_tpu_torch.server.plugins import load_plugins_from_env

    load_plugins_from_env()
    service = EventServerService(slos=slos, qos=qos)
    server = JsonHTTPServer(
        service.router, host, port, name="pio-tpu-torch-eventserver"
    )
    server.service = service  # reachable for embedding/tests
    return server
