"""Event Server — REST ingestion daemon (:7070 by default).

The port's copy of ``pio_tpu/server/event_server.py`` (the port imports
nothing of ``pio_tpu``), cut to the ingest and read routes:

    GET    /                          alive check
    POST   /events.json               ingest one event (201 + eventId)
    GET    /events.json               filtered query (reversed by default)
    GET    /events/search.json?q=...  BM25-ranked full-text search (the
                                      searchable store; 501 elsewhere)
    GET    /events/<id>.json          fetch one
    DELETE /events/<id>.json          delete one
    POST   /batch/events.json         ≤50 events, per-item statuses
    GET    /faults.json               armed failpoints, trigger counts

Auth: ``accessKey`` query param (or ``Authorization`` header); the key maps
to an app and an optional event-name whitelist. ``channel`` selects a named
sub-stream (must exist; 400 otherwise). Every write is acknowledged only
after the transaction that carries it committed, at the storage's
durability mode (``PIO_TPU_DURABILITY``).

Not ported yet: stats, metrics, traces, hotpath, logs, slo, qos,
storage, healthz/readyz, webhooks and plugins, the QoS gate with
its storage breaker, and the tracer (ROADMAP A).
"""

from __future__ import annotations

import datetime as _dt
import threading
import time
from typing import Any, Optional, Tuple

from pio_tpu_torch import faults
from pio_tpu_torch.data.event import Event, EventValidationError
from pio_tpu_torch.server.http import HTTPError, JsonHTTPServer, Request, Router
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.storage.retry import retrying

MAX_BATCH = 50


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
    #: metadata SELECT is a measurable slice of single-event ingest cost.
    #: Bounds key-revocation latency to the TTL (misses are never cached,
    #: so a fresh key works immediately).
    AUTH_CACHE_TTL_S = 2.0

    def __init__(self):
        self._auth_cache: dict = {}
        self._auth_gen = 0  # bumped by invalidation; fences re-caching
        self._auth_cache_lock = threading.Lock()
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
        r.add("GET", "/faults\\.json", lambda req: (200, faults.snapshot()))

    # -- auth ---------------------------------------------------------------
    def invalidate_auth_cache(self) -> None:
        """Drop cached positive key lookups (called on Storage.reset; the
        TTL still bounds staleness for out-of-process mutations). The
        generation bump fences an in-flight ``_auth`` that already read
        from the OLD store: its insert is discarded rather than
        repopulating the cache with a record from a store that no longer
        exists."""
        with self._auth_cache_lock:
            self._auth_gen += 1
            self._auth_cache.clear()

    def _auth(self, req: Request) -> Tuple[int, Optional[int], tuple]:
        """accessKey+channel → (app_id, channel_id, event_whitelist)."""
        key = req.bearer_key()
        if not key:
            raise HTTPError(401, "missing accessKey")
        now = time.monotonic()
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

    @staticmethod
    def _check_whitelist(event_name: str, whitelist: tuple):
        if whitelist and event_name not in whitelist:
            raise HTTPError(
                403, f"accessKey does not allow event {event_name!r}"
            )

    # -- handlers -----------------------------------------------------------
    def alive(self, req: Request):
        return 200, {"status": "alive"}

    def _validate_one(self, d: Any, whitelist) -> Event:
        """JSON → validated Event (whitelist applied)."""
        if not isinstance(d, dict):
            raise EventValidationError("event must be a JSON object")
        event = Event.from_api_dict(d)
        self._check_whitelist(event.event, whitelist)
        return event

    def create_event(self, req: Request):
        app_id, channel_id, whitelist = self._auth(req)
        try:
            event = self._validate_one(req.body, whitelist)
        except EventValidationError as e:
            return 400, {"message": str(e)}
        event_id = retrying(
            lambda: Storage.get_levents().insert(event, app_id, channel_id)
        )
        return 201, {"eventId": event_id}

    def batch_events(self, req: Request):
        app_id, channel_id, whitelist = self._auth(req)
        if not isinstance(req.body, list):
            return 400, {"message": "batch body must be a JSON array"}
        if len(req.body) > MAX_BATCH:
            return 400, {
                "message": f"batch size {len(req.body)} exceeds {MAX_BATCH}"
            }
        # validate every item first (per-item status contract), then land
        # the valid ones in ONE bulk storage write (insert_batch — a
        # single transaction and commit)
        results: list = [None] * len(req.body)
        valid = []
        for k, d in enumerate(req.body):
            try:
                valid.append((k, self._validate_one(d, whitelist)))
            except (EventValidationError, HTTPError) as e:
                status = e.status if isinstance(e, HTTPError) else 400
                results[k] = {"status": status, "message": str(e)}
        if valid:
            ids = retrying(
                lambda: Storage.get_levents().insert_batch(
                    [e for _, e in valid], app_id, channel_id
                )
            )
            for (k, _), eid in zip(valid, ids):
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
        (the Elasticsearch analog's capability, over REST)."""
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


def create_event_server(host: str = "0.0.0.0", port: int = 7070) -> JsonHTTPServer:
    """Build (unstarted) server — reference ``EventServer.createEventServer``."""
    service = EventServerService()
    server = JsonHTTPServer(
        service.router, host, port, name="pio-tpu-torch-eventserver"
    )
    server.service = service  # reachable for embedding/tests
    return server
