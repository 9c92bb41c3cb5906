"""Query server — ``POST /queries.json`` over the deployed models.

Counterpart of the query path of ``pio_tpu/server/query_server.py``: parse
the JSON body into the algorithms' query dataclass (400 on bad JSON or
unknown fields), run each algorithm's ``predict`` against its model, combine
with the engine's serving, and answer the result as JSON. ``GET /`` reports
status, ``GET /stats.json`` the ``residency`` block of the reference's
(the other blocks come with the query-server slice), and ``POST
/undeploy`` stops the server once its answer is written (loopback-only
unless the service holds an admin key, as in the reference).

Where residency is enabled (:func:`~pio_tpu_torch.server.residency.
enabled`), the service places each algorithm's resident scorer on the
serving device when it is built (the reference's ``_place_resident``),
attaches it to its model as ``_resident``, binds its counters and
preallocates bucket 1; :meth:`QueryService.close` retires the scorers.
A placement that fails raises: the reference logs it and serves from the
host mirror, which would hide the device.

Two factories: :func:`create_query_server` over models handed over in
memory, and :func:`deploy_query_server`, which loads a stored engine
instance the way ``pio deploy`` does. QoS, micro-batching, the bucket
ladder, ``/reload``, tracing and the other routes come with later slices.
"""

from __future__ import annotations

import datetime as dt
import json
import logging
import threading
from typing import Any, Optional, Sequence

import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.params import ParamsError, params_from_dict
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server import residency
from pio_tpu_torch.server.http import (
    HTTPError,
    JsonHTTPServer,
    Request,
    Router,
    keys_equal,
)
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from pio_tpu_torch.workflow.deploy_common import (
    resolve_instance_id,
    resolve_query_class,
    to_jsonable,
)
from pio_tpu_torch.workflow.engine_json import EngineVariant, build_engine

log = logging.getLogger("pio_tpu_torch.query_server")


class QueryService:
    """The deployed engine: (algorithm, model) pairs plus serving.

    ``device`` is the serving device of the resident scorers (CUDA unless
    told otherwise); it is resolved only where residency is enabled.
    ``instance_id`` names the stored engine instance the models came from
    (None for models handed over in memory); ``admin_key``, when set, is
    the key ``POST /undeploy`` needs, which is otherwise loopback-only."""

    def __init__(self, engine: Engine, engine_params: EngineParams,
                 models: Sequence[Any], device: DeviceLike = None,
                 instance_id: Optional[str] = None,
                 admin_key: Optional[str] = None):
        self.pairs = engine.algorithms_with_models(engine_params, models)
        self.serving = engine.make_serving(engine_params)
        self.query_class = resolve_query_class(self.pairs)
        self.instance_id = instance_id
        self.admin_key = admin_key
        self.server: Optional[JsonHTTPServer] = None
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
            "engineInstanceId": self.instance_id,
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
        result = to_jsonable(prediction)
        with self._lock:
            self.request_count += 1
        return result


    # -- routes ---------------------------------------------------------------
    def router(self) -> Router:
        r = Router()
        r.add("GET", "/", lambda req: (200, self.status()))
        r.add("GET", "/stats\\.json", lambda req: (200, self.stats()))
        r.add("POST", "/queries\\.json",
              lambda req: (200, self.query(req.raw_body)))
        r.add("POST", "/undeploy", self.undeploy)
        return r

    def undeploy(self, req: Request):
        """Stop the attached server once this answer is written (reference
        parity: ``pio undeploy`` ends the serving process)."""
        if self.admin_key is not None:
            if not keys_equal(req.bearer_key(), self.admin_key):
                raise HTTPError(401, "invalid admin accessKey")
        elif req.client_addr not in ("127.0.0.1", "::1"):
            raise HTTPError(
                403, "admin routes are loopback-only without an admin key"
            )
        server = self.server
        if server is not None:
            # stop() blocks until the accept loop exits, which this
            # handler's thread must not wait for
            req.after_response = lambda: threading.Thread(
                target=server.stop, daemon=True).start()
        return 200, {"message": "undeployed"}


class QueryServer(JsonHTTPServer):
    """A running query server: :attr:`port`, :meth:`start`,
    :meth:`serve_forever`, :meth:`close` (which also retires the
    service's resident scorers)."""

    def __init__(self, service: QueryService, host: str, port: int):
        super().__init__(service.router(), host, port,
                         name="pio-tpu-torch-queryserver")
        self.service = service
        service.server = self

    def close(self) -> None:
        self.stop()
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


def deploy_query_server(
    variant: EngineVariant,
    host: str = "0.0.0.0",
    port: int = 8000,
    instance_id: Optional[str] = None,
    device: DeviceLike = None,
    admin_key: Optional[str] = None,
) -> QueryServer:
    """A query server (not yet started) over a stored engine instance, the
    way ``pio deploy`` builds it (the reference's ``create_query_server(
    variant, ...)``): ``build_engine``, then ``resolve_instance_id`` (the
    named instance, or the variant's latest COMPLETED one), then
    ``load_models_for_instance`` onto ``device`` (CUDA unless told
    otherwise), which falls back to the last known good instance of the
    variant when the blob fails verification."""
    engine, engine_params = build_engine(variant)
    instance_id = resolve_instance_id(variant, instance_id)
    ctx = ComputeContext.create(device=device)
    models = load_models_for_instance(
        instance_id, engine, engine_params, ctx, variant=variant
    )
    service = QueryService(
        engine, engine_params, models, device=ctx.device,
        instance_id=instance_id,
        admin_key=admin_key,
    )
    return QueryServer(service, host, port)
