"""Query server — ``POST /queries.json`` over the deployed models.

Counterpart of the query path of ``pio_tpu/server/query_server.py``: parse
the JSON body into the algorithms' query dataclass (400 on bad JSON or
unknown fields), run each algorithm's ``predict`` against its model, combine
with the engine's serving, and answer the result as JSON. ``GET /`` reports
status, ``GET /stats.json`` the ``residency`` block of the reference's
(the other blocks come with the query-server slice).

Where residency is enabled (:func:`~pio_tpu_torch.server.residency.
enabled`), the service places each algorithm's resident scorer on the
serving device when it is built (the reference's ``_place_resident``),
attaches it to its model as ``_resident``, binds its counters and
preallocates bucket 1; :meth:`QueryService.close` retires the scorers.
A placement that fails raises: the reference logs it and serves from the
host mirror, which would hide the device.

Built on the standard library's ``ThreadingHTTPServer``; models are
handed over in memory. Loading from storage, QoS, micro-batching, the
bucket ladder, ``/reload``, tracing and the other routes come with later
slices.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Sequence

import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.params import ParamsError, params_from_dict
from pio_tpu_torch.server import residency

log = logging.getLogger("pio_tpu_torch.query_server")

#: query bodies are parsed in RAM; the JAX server caps JSON bodies at 64 MiB
MAX_JSON_BODY_BYTES = 64 * 2 ** 20


class HTTPError(Exception):
    """Handler-raised error, answered as ``{"message": ...}``."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _to_jsonable(obj: Any) -> Any:
    """Prediction object → JSON-able structure (to_dict > dataclass > raw)."""
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


class QueryService:
    """The deployed engine: (algorithm, model) pairs plus serving.

    ``device`` is the serving device of the resident scorers (CUDA unless
    told otherwise); it is resolved only where residency is enabled."""

    def __init__(self, engine: Engine, engine_params: EngineParams,
                 models: Sequence[Any], device: DeviceLike = None):
        self.pairs = engine.algorithms_with_models(engine_params, models)
        self.serving = engine.make_serving(engine_params)
        classes = {a.query_class for a, _ in self.pairs} - {None}
        if len(classes) > 1:
            raise ValueError(
                "algorithms declare conflicting query classes: "
                + ", ".join(sorted(c.__name__ for c in classes))
            )
        self.query_class = next(iter(classes), None)
        self.start_time = dt.datetime.now(dt.timezone.utc)
        self._lock = threading.Lock()
        self.request_count = 0
        #: totals of every resident dispatch (the scorers' bound counters)
        self.resident_counts = {"h2dBytes": 0, "hit": 0, "miss": 0}
        self.device: Optional[torch.device] = None
        self._resident: list = []
        if residency.enabled(device):
            self.device = resolve_device(device)
            self._resident = self._place_resident(self.device)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.resident_counts[key] += n

    def _place_resident(self, device: torch.device) -> list:
        """Build, place and attach each pair's resident scorer; a failure
        retires what was placed and raises."""
        placed = []
        try:
            for algo, m in self.pairs:
                sc = algo.resident_scorer(m, device)
                if sc is None:
                    continue
                sc.bind(on_h2d=lambda n: self._count("h2dBytes", n),
                        on_dispatch=self._count)
                sc.prealloc((1,))
                m._resident = sc
                placed.append((m, sc))
                log.info("resident scorer %r placed: %d param bytes, "
                         "wire=%s", sc.name, sc.placed_bytes, sc.wire)
        except BaseException:
            self._retire(placed)
            raise
        return placed

    @staticmethod
    def _retire(placed) -> None:
        for m, sc in placed:
            sc.retire()
            if m.__dict__.get("_resident") is sc:
                del m._resident

    def close(self) -> None:
        """Retire the resident scorers and detach them from their models."""
        placed, self._resident = self._resident, []
        self._retire(placed)

    def stats(self) -> dict:
        """``GET /stats.json``: the residency block (the reference's
        keys, plus the service's dispatch totals). ``measuredBytes`` is
        ``torch.cuda.memory_allocated`` on the card, null elsewhere."""
        scorers = [sc for _, sc in self._resident]
        on_card = self.device is not None and self.device.type == "cuda"
        with self._lock:
            totals = dict(self.resident_counts)
        return {"residency": {
            "enabled": bool(scorers),
            "paramBytes": sum(sc.placed_bytes for sc in scorers),
            "measuredBytes": (torch.cuda.memory_allocated(self.device)
                              if on_card else None),
            "scorers": [sc.to_dict() for sc in scorers],
            "totals": totals,
        }}

    def status(self) -> dict:
        return {
            "status": "deployed",
            "algorithms": [type(a).__name__ for a, _ in self.pairs],
            "startTime": self.start_time.isoformat(),
            "requestCount": self.request_count,
        }

    def _parse_query(self, body: Any):
        if not isinstance(body, dict):
            raise HTTPError(400, "query body must be a JSON object")
        if self.query_class is None:
            return body  # raw dict queries
        try:
            return params_from_dict(self.query_class, body)
        except ParamsError as e:
            raise HTTPError(400, str(e))

    def _predict_one(self, query):
        predictions = [algo.predict(m, query) for algo, m in self.pairs]
        return self.serving.serve(query, predictions)

    def query(self, raw: bytes) -> Any:
        if not raw:
            raise HTTPError(400, "query body required")
        try:
            body = json.loads(raw)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HTTPError(400, f"invalid JSON: {e}")
        query = self._parse_query(body)
        try:
            prediction = self._predict_one(query)
        except ValueError as e:
            # a query the model cannot take, e.g. the wrong number of
            # attributes: the client's error
            raise HTTPError(400, str(e))
        result = _to_jsonable(prediction)
        with self._lock:
            self.request_count += 1
        return result


def _handler_for(service: QueryService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body go out in two writes: with Nagle on, the body
        # waits for the client's delayed ACK (~40 ms) on a keep-alive
        # connection, every request after the first
        disable_nagle_algorithm = True

        def _respond(self, status: int, payload: Any) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json; charset=UTF-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _guarded(self, fn) -> None:
            try:
                self._respond(200, fn())
            except HTTPError as e:
                self._respond(e.status, {"message": e.message})
            except Exception:  # boundary: the server keeps answering
                log.exception("query failed")
                self._respond(500, {"message": "internal server error"})

        def do_GET(self):
            route = {"/": service.status, "/stats.json": service.stats}.get(
                self.path.split("?", 1)[0])
            if route is None:
                self._respond(404, {"message": f"no route for GET {self.path}"})
                return
            self._guarded(route)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = -1
            if length < 0 or length > MAX_JSON_BODY_BYTES:
                # the body cannot be framed (or is not read into RAM): answer
                # and close rather than leave unread bytes on the connection
                self.close_connection = True
                if length < 0:
                    self._respond(400, {"message": "bad Content-Length"})
                else:
                    self._respond(413, {"message": "body too large"})
                return
            raw = self.rfile.read(length)
            if self.path.split("?", 1)[0] != "/queries.json":
                self._respond(404, {"message": f"no route for POST {self.path}"})
                return
            self._guarded(lambda: service.query(raw))

        def log_message(self, fmt, *args):
            log.debug("%s - " + fmt, self.address_string(), *args)

    return Handler


class QueryServer:
    """A running query server: :attr:`port`, :meth:`start`, :meth:`close`."""

    def __init__(self, service: QueryService, host: str, port: int):
        self.service = service
        self.httpd = ThreadingHTTPServer((host, port), _handler_for(service))
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "QueryServer":
        """Serve in a background thread."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="pio-query-server",
            daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=10)
            self._thread = None
        self.httpd.server_close()
        self.service.close()

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def create_query_server(
    engine: Engine,
    engine_params: EngineParams,
    models: Sequence[Any],
    host: str = "127.0.0.1",
    port: int = 8000,
    device: DeviceLike = None,
) -> QueryServer:
    """A query server (not yet started) over in-memory ``models``; port 0
    picks a free port (read it back from :attr:`QueryServer.port`).
    ``device`` is the resident scorers' serving device."""
    return QueryServer(QueryService(engine, engine_params, models, device),
                       host, port)
