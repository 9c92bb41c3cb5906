"""Query server — ``POST /queries.json`` over the deployed models.

Counterpart of ``pio_tpu/server/query_server.py``. Routes:

    GET  /               status (engine instance, start time, requests)
    POST /queries.json   typed query (JSON, or a packed int8 frame sent
                         as ``application/x-pio-query-i8``) → serving
    GET  /stats.json     residency, micro-batch, bucket, lane and pool
                         blocks, and the process's kernel launches
    GET  /device.json    device memory, ledger and compile attribution
    GET  /metrics        Prometheus text: requests, stages, SLO, QoS and
                         the device plane's families
    GET  /traces.json    recent request and micro-batch traces (``?slow=1``
                         the slow ring, ``?id=`` one trace, ``?n=``)
    GET  /logs.json      structured-log ring (``?level=&trace_id=&n=``)
    GET  /slo.json       burn rates of the declared SLOs
    GET  /qos.json       admission-control state
    GET  /debug/hotpath.json   per-stage latency budget of the query path
    GET  /plugins.json   installed plugins
    GET  /faults.json    armed failpoints and their trigger counts
    GET  /debug/profile.json   the profile hook's status
    POST /debug/profile.json   ``?restart=1&n=N``: capture the next N
                         device executions into ``capture-NNNN``
    GET  /healthz        liveness (accept loop, batcher, lane, heartbeat)
    GET  /readyz         readiness (engine loaded, instance in storage)
    POST /reload         hot swap to the newest COMPLETED instance
    GET  /deploy.json    served instance, manifest sha256s, swap generation
    POST /deploy.json    verified swap to ``engineInstanceId`` (router)
    POST /undeploy       stop serving (the whole pool in pool mode)

The body parses into the algorithms' query dataclass (400 on bad JSON or
unknown fields); each algorithm's ``predict`` runs against its model and
the engine's serving combines the answers.

**Generations.** A deployed generation is the (algorithm, model) pairs,
the serving, the query class and the resident scorers, built together by
``_install`` and swapped in at once under ``_swap_lock``. Every dispatch
reads its generation through :meth:`QueryService._reading`, which counts
it as a reader; a ``/reload`` retires the outgoing generation's scorers
only once its last reader has finished. So a query in flight across a
swap finishes on live parameters, a retired scorer is never reached, and
one that were would raise rather than answer from the host mirror.

**Micro-batching** (``PIO_TPU_SERVE_MICROBATCH_US``, the window in
microseconds): concurrent request threads enqueue their parsed queries
and one worker thread serves them as one ``batch_predict`` a bucket of
the ladder (``server/bucketcache.py``), which it warms at every load.
``PIO_TPU_SERVE_MICROBATCH_ADAPTIVE`` (default on) probes whether
batching wins under the live load and bypasses it where it does not.

**Pool mode** (``server/worker_pool.py``): :meth:`QueryService.
enable_pool` wires the shared reload generation and shutdown event, and
:meth:`QueryService.enable_batch_lane` the cross-worker batch lane,
whose drainer runs on the worker that owns the device.

Where residency is enabled (:func:`~pio_tpu_torch.server.residency.
enabled`), each generation places its algorithms' resident scorers on
the serving device, attached to their models as ``_resident`` with the
ladder's output tensors preallocated; a placement that fails raises (the
reference logs it and serves from the host mirror, which would hide the
device). Two factories: :func:`create_query_server` over models handed
over in memory (``/reload`` answers 400 there: there is no stored
instance to reload), and :func:`deploy_query_server`, which loads a
stored engine instance the way ``pio deploy`` does.

**The device ops plane.** Each service holds a
:class:`~pio_tpu_torch.obs.devicewatch.DeviceWatch` on its own metrics
registry, active in the process so that the resident scorers book their
placements into it, its sampler started unless ``PIO_TPU_DEVICEWATCH=0``;
it counts the ladder's warmup dispatches (``bucket_warmup``) and a live
dispatch into a cold bucket (``bucket_dispatch``), and stamps each
generation. A :class:`~pio_tpu_torch.obs.profile.DeviceProfileHook`
(``PIO_TPU_PROFILE``) wraps every device execution: a per-query predict,
and each bucketed batch dispatch (the micro-batcher's, the lane
drainer's, the warmup's).

**Mesh serving** (``PIO_TPU_MESH_SERVE=1``): each generation's shardable
models (the recommendation ``ALSModel``) serve from a scorer sharded over
the devices the process owns (``ops/topn.py``); ``/stats.json`` carries
the ``sharding`` block (``{"enabled": false}`` when the gate is off),
``/metrics`` ``pio_tpu_shard_bytes_placed_total`` and
``pio_tpu_shard_gather_fallback_total``, and ``/device.json``'s ledger
the shards under ``shard``. A placement that fails raises at deploy. The
mesh attaches to every loaded model before ``prepare_for_serving``, so
the classification template's resident scorer row-shards its weights
over it too (``server/residency.py``).

**Failpoints** (``faults/``): ``shard.place`` before each mesh
placement, ``scorer.dispatch.solo`` / ``.batch`` / ``.packed`` at the
three dispatch paths; ``GET /faults.json`` answers the registry's
snapshot and ``/metrics`` carries ``pio_tpu_fault_triggered_total``.

**The request plane.** Every query is a trace of :data:`QUERY_STAGES`
(accept, admit, parse, queue, execute, serialize, write: they tile the
request, so ``/debug/hotpath.json`` attributes its milliseconds), with
``execute.device`` around the models' predictions, which end with their
answers on the host. A caller's ``X-Pio-Trace`` id (and parent span) is
adopted and every answer echoes the id. The micro-batcher's worker opens
one ``microbatch`` trace a batch, linking its members' ids, and the
batch's ``execute.device`` lands there. With a QoS policy (``qos=``,
``PIO_TPU_QOS`` or the variant's ``qos`` block), a query passes the
engine bucket and the concurrency limit (``X-Pio-Priority``), carries
its ``X-Pio-Deadline-Ms`` into the batcher, which sheds it before the
dispatch once it is spent, and calls the scorer through a circuit
breaker; a shed query answers 429 (rate) or 503 with ``Retry-After``,
or 200 from the stale cache under ``X-Pio-Degraded: stale-cache``, and
launches nothing. ``slos=`` (or ``PIO_TPU_SLO``) declares objectives
read by ``/slo.json``. The plugins' output blockers and sniffers see
each answer, and with ``feedback`` each answer carries a ``prId`` and is
written to the feedback app as a ``predict`` event of entity type
``pio_pr``.

**The pool plane and the router.** In a pool (``enable_pool`` with the
supervisor's segment) ``/metrics`` reports pool-wide totals and carries
``pio_tpu_pool_stripe_generation``, ``/stats.json`` a ``pool`` block, and
readiness needs the stripe. ``GET /deploy.json`` reports the served
instance, its manifest's sha256s and the swap generation; ``POST
/deploy.json`` is the router's verified swap (``router/deploy.py``).

**The fronts.** ``PIO_TPU_HTTP_FRONT`` picks the HTTP front when a server
is built: ``threaded`` (the default, a thread a connection, TLS from
``PIO_TPU_SSL_CERTFILE``) or ``evloop`` (one selectors loop,
``server/evfront.py``). Another value warns and serves threaded, and so
does ``evloop`` where TLS is configured (the loop has no TLS path). On
the evloop front the handlers run in the loop, so the micro-batcher is
bypassed (its ``submit`` parks the calling thread for the batch window,
and that thread is the loop); a pool's batch lane still applies, its wait
bounded by ``PIO_TPU_LANE_TIMEOUT_S``.
"""

from __future__ import annotations

import collections
import contextlib
import datetime as dt
import json
import logging
import os
import threading
from typing import Any, List, Optional, Sequence

import uuid

import torch

from pio_tpu_torch import DeviceLike, faults, resolve_device
from pio_tpu_torch.analysis.runtime import make_condition, make_lock
from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.params import ParamsError, params_from_dict
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs import devicewatch, slog
from pio_tpu_torch.obs.health import Heartbeat, HealthMonitor
from pio_tpu_torch.obs.hotpath import hotpath_payload
from pio_tpu_torch.obs.metrics import MetricsRegistry, monotonic_s
from pio_tpu_torch.obs.profile import DeviceProfileHook
from pio_tpu_torch.obs.shm import PoolMetricsSegment
from pio_tpu_torch.obs.slo import (
    engine_for_specs,
    slo_payload,
    slow_threshold_s,
)
from pio_tpu_torch.obs.tracing import (
    TRACE_HEADER,
    Tracer,
    add_active_span,
    parse_trace_header,
)
from pio_tpu_torch.ops.embedding import launch_counts
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server import residency
from pio_tpu_torch.server.batchlane import (
    BatchLaneSegment,
    LaneClient,
    LaneDrainer,
    LaneFallback,
    PackedQuery,
    pack_query_i8,
    packed_frame_ok,
    unpack_query_i8,
)
from pio_tpu_torch.server.bucketcache import (
    BucketExecutionCache,
    dispatch_bucketed,
)
from pio_tpu_torch.qos import (
    DEADLINE_HEADER,
    DEGRADED_HEADER,
    DEGRADED_VALUE,
    PRIORITY_HEADER,
    Deadline,
    DeadlineExceeded,
    QoSGate,
    cache_key,
    qos_payload,
    resolve_policy,
    retry_after_header,
)
from pio_tpu_torch.server.http import (
    HTTPError,
    JsonHTTPServer,
    RawResponse,
    Request,
    Router,
    int_param,
    ssl_context_from_env,
    json_response,
    keys_equal,
    logs_route,
    metrics_response,
)
from pio_tpu_torch.server.plugins import installed_plugins
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.utils import knobs
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from pio_tpu_torch.workflow.deploy_common import (
    resolve_instance_id,
    resolve_query_class,
    to_jsonable,
)
from pio_tpu_torch.workflow.engine_json import EngineVariant, build_engine

log = logging.getLogger("pio_tpu_torch.query_server")

#: query-path plugin hooks (``server/plugins.py``): output blockers veto
#: an answer with ValueError (a 400), sniffers observe it
QUERY_BLOCKERS: List = []
QUERY_SNIFFERS: List = []

#: query-path trace stages, in request order: socket read (the HTTP
#: layer), QoS admission, JSON binding + serving.supplement, the wait
#: before the dispatch (the micro-batch queue), the models' execution, the
#: answer's serialization (to_jsonable, hooks, feedback), the write. They
#: TILE the request: their durations sum to the end-to-end latency, which
#: /debug/hotpath.json budgets against.
QUERY_STAGES = (
    "accept", "admit", "parse", "queue", "execute", "serialize", "write",
)

#: dotted substages attribute time WITHIN a top-level stage (left out of
#: the budget sums): the admission queue's wait and the device dispatch
QUERY_SUBSTAGES = ("admit.queue", "execute.device")

#: sentinel: the micro-batch dispatch failed; the waiting request thread
#: runs the per-query fallback itself (see _MicroBatcher.submit)
_BATCH_FAILED = object()

#: why a lane submission was served by the local predict instead
LANE_FALLBACK_REASONS = ("full", "timeout", "oversize", "remote_error",
                         "unserializable", "undecodable_response")


class _MicroBatcher:
    """Coalesces concurrent ``/queries.json`` requests into one
    ``batch_predict`` dispatch, when that wins.

    Request threads enqueue their parsed query and block; the worker
    thread drains the queue after a short collection window and serves
    the whole batch through the bucket ladder (one launch of each
    algorithm's device program per bucket), then answers each query. It
    is the only thread that launches on the card in batched mode; solo
    and fallback predicts run in the request threads.

    **Adaptive bypass.** The first ``PROBE_QUERIES`` requests run
    coalesced, the next ``PROBE_QUERIES`` per request in the caller's
    thread, and whichever regime had the lower median latency under the
    same live load wins (the second half of each window is compared, so
    one-off first dispatches do not decide). An "off" verdict is a lease
    of ``PIO_TPU_MB_REPROBE_S`` seconds, after which the probe runs
    again. ``PIO_TPU_SERVE_MICROBATCH_ADAPTIVE=0`` pins batching on.

    If a batch dispatch fails, every member falls back to the per-query
    path in its own thread, so one poisoned query cannot fail its
    batch-mates. A member's deadline bounds the collection window, and a
    member whose deadline is spent by the drain is shed before the
    dispatch (``DeadlineExceeded`` in its own thread): nothing launches
    for it.
    """

    MAX_BATCH = 512
    #: dispatch this far BEFORE the tightest queued deadline: waking at
    #: the exact expiry would shed the member the bound exists to protect
    DEADLINE_SLACK_S = 0.05
    #: probe sample size per regime before the mode decision
    PROBE_QUERIES = 96

    def __init__(self, service: "QueryService", window_s: float,
                 adaptive: bool = True):
        self._service = service
        self._window_s = window_s
        self._cv = make_condition("query.microbatch")
        self._queue: List[list] = []
        self._stopped = False
        self.batches = 0
        self.batched_queries = 0
        self.max_batch = 0
        #: probe_batch → probe_solo → on | off
        self._mode = "probe_batch" if adaptive else "on"
        #: set when the probe decides "off": query() then skips the
        #: batcher and serves inline
        self.bypassed = False
        self._reprobe_s = knobs.knob_float("PIO_TPU_MB_REPROBE_S")
        self._decided_at = 0.0
        self.reprobes = 0
        self._probe_lock = make_lock("query.microbatch.probe")
        self._probe: dict = {"batch": [], "solo": []}
        #: per-bucket batched per-member latency samples (bounded ring,
        #: fresh-bucket dispatches excluded), behind ``modeByBucket``
        self._bucket_samples: dict = {}
        self._thread = threading.Thread(
            target=self._run, name="pio-tpu-torch-microbatch", daemon=True
        )
        self._thread.start()

    @property
    def thread(self) -> threading.Thread:
        return self._thread

    def active(self) -> bool:
        """Should queries flow through the batcher? Also the re-probe
        trigger: an "off" verdict older than the re-probe interval
        resets the probe windows."""
        if not self.bypassed:
            return True
        if self._reprobe_s <= 0 \
                or monotonic_s() - self._decided_at < self._reprobe_s:
            return False
        with self._probe_lock:
            if not self.bypassed:  # another thread re-armed first
                return True
            self._probe = {"batch": [], "solo": []}
            self._mode = "probe_batch"
            self.bypassed = False
            self.reprobes += 1
        log.info("micro-batch re-probe after %.0fs in bypass",
                 self._reprobe_s)
        return True

    def submit(self, query, gen=None, span_sink=None, deadline=None):
        """Serve one query through the current regime on ``gen``, the
        generation the caller parsed it with and holds as a reader;
        blocks until done. If the batch dispatch failed, the per-query
        predict runs here, in the request's own thread.

        ``span_sink`` (the request's trace handle) receives the queue and
        execute spans, measured where they happen: the worker thread
        computes each member's queue wait at the drain and the shared
        dispatch's duration. ``deadline`` (a :class:`~pio_tpu_torch.qos.
        Deadline`) rides along: the worker sheds a member whose budget
        elapsed in the queue (raised here as ``DeadlineExceeded``) and
        never holds the window past the tightest queued deadline."""
        mode = self._mode
        if mode == "off" or mode == "probe_solo":
            t0 = monotonic_s()
            out = self._service._predict_one(query, gen)
            dt_s = monotonic_s() - t0
            if span_sink is not None:
                span_sink.add_span("queue", 0.0)
                span_sink.add_span("execute", dt_s)
            if mode == "probe_solo":
                self._note_probe("solo", dt_s)
            return out
        t0 = monotonic_s()
        # query, result, error, done, enqueue time, worker-filled notes,
        # generation, deadline, member trace id (the batch trace links
        # its members)
        pend = [query, None, None, threading.Event(), t0, {}, gen, deadline,
                span_sink.trace_id if span_sink is not None else None]
        with self._cv:
            if self._stopped:
                raise HTTPError(503, "undeployed")
            self._queue.append(pend)
            self._cv.notify()
        pend[3].wait()
        if mode == "probe_batch" and not pend[5].get("fresh_bucket"):
            # a dispatch into a cold bucket is a one-off transient, not
            # the steady state the probe compares
            self._note_probe("batch", monotonic_s() - t0)
        if span_sink is not None and "queue_s" in pend[5]:
            span_sink.add_span("queue", pend[5]["queue_s"])
        if span_sink is not None and "batch_id" in pend[5]:
            # back-link: the member's waterfall names the batch trace
            # whose execute span it shared
            span_sink.note(microbatch=pend[5]["batch_id"])
        if pend[2] is _BATCH_FAILED:
            t1 = monotonic_s()
            out = self._service._predict_one(pend[0], gen)
            if span_sink is not None:
                span_sink.add_span("execute", monotonic_s() - t1)
            return out
        if span_sink is not None and "execute_s" in pend[5]:
            span_sink.add_span("execute", pend[5]["execute_s"])
        if pend[2] is not None:
            raise pend[2]
        return pend[1]

    def _note_probe(self, kind: str, dt_s: float) -> None:
        with self._probe_lock:
            samples = self._probe[kind]
            samples.append(dt_s)
            if len(samples) < self.PROBE_QUERIES:
                return
            if kind == "batch" and self._mode == "probe_batch":
                self._mode = "probe_solo"
            elif kind == "solo" and self._mode == "probe_solo":
                # steady state: drop each window's first half
                med = lambda xs: sorted(xs[len(xs) // 2:])[len(xs) // 4]
                batch_med = med(self._probe["batch"])
                solo_med = med(self._probe["solo"])
                self._mode = "on" if batch_med <= solo_med else "off"
                log.info(
                    "micro-batch probe: batched p50 %.3f ms vs per-query "
                    "p50 %.3f ms under live load -> %s",
                    batch_med * 1e3, solo_med * 1e3, self._mode,
                )
                if self._mode == "off":
                    self.bypassed = True
                    self._decided_at = monotonic_s()

    @property
    def mode(self) -> str:
        return self._mode

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()

    def to_dict(self) -> dict:
        with self._probe_lock:
            med = lambda xs: (
                round(sorted(xs)[len(xs) // 2] * 1e3, 3) if xs else None
            )
            probe = {
                "batchedP50Ms": med(self._probe["batch"]),
                "perQueryP50Ms": med(self._probe["solo"]),
            }
            solo = sorted(self._probe["solo"])
            solo_med = solo[len(solo) // 2] if solo else None
        # each bucket's batched per-member p50 against the probe's
        # per-query p50: which batch sizes coalescing wins at
        mode_by_bucket = {}
        for b in sorted(self._bucket_samples):
            xs = sorted(self._bucket_samples[b])
            if not xs:
                continue
            p50 = xs[len(xs) // 2]
            mode_by_bucket[str(b)] = {
                "mode": (
                    "on" if solo_med is None or p50 <= solo_med else "off"
                ),
                "p50Ms": round(p50 * 1e3, 3),
                "samples": len(xs),
            }
        return {
            "mode": self._mode,
            "modeByBucket": mode_by_bucket,
            "probe": probe,
            "batches": self.batches,
            "batchedQueries": self.batched_queries,
            "maxBatch": self.max_batch,
            "windowUs": round(self._window_s * 1e6),
            "reprobeSeconds": self._reprobe_s,
            "reprobes": self.reprobes,
            "bypassed": self.bypassed,
        }

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._queue:
                    return
            # collection window: let concurrent request threads pile on,
            # but don't idle when a full batch is already waiting, and
            # never wait past the tightest queued deadline (every enqueue
            # notifies, so a tighter newcomer re-shortens the wait)
            if self._window_s > 0:
                window_end = monotonic_s() + self._window_s
                with self._cv:
                    while not self._stopped \
                            and len(self._queue) < self.MAX_BATCH:
                        wait_s = window_end - monotonic_s()
                        tightest = min(
                            (p[7].remaining_s() for p in self._queue
                             if p[7] is not None),
                            default=None,
                        )
                        if tightest is not None:
                            wait_s = min(
                                wait_s, tightest - self.DEADLINE_SLACK_S
                            )
                        if wait_s <= 0:
                            break
                        self._cv.wait(wait_s)
            with self._cv:
                batch = self._queue[: self.MAX_BATCH]
                del self._queue[: len(batch)]
            if not batch:
                continue
            # stage attribution: everything before the drain is each
            # member's queue wait, the shared dispatch its execute time
            t_drain = monotonic_s()
            for p in batch:
                p[5]["queue_s"] = max(t_drain - p[4], 0.0)
            # deadline shedding: a member whose budget elapsed in the
            # queue fails here, before the models run
            live = []
            for p in batch:
                if p[7] is not None and p[7].expired():
                    p[2] = DeadlineExceeded("deadline elapsed in queue")
                    p[3].set()
                else:
                    live.append(p)
            batch = live
            if not batch:
                continue
            self.batches += 1
            self.batched_queries += len(batch)
            self.max_batch = max(self.max_batch, len(batch))
            try:
                queries = [p[0] for p in batch]
                # freshness from the warmed-set snapshot: _predict_batch
                # is the seam tests wrap, so the batcher goes through it
                cache = self._service._buckets
                pre_warmed = cache.warmed
                fresh = any(
                    cache.bucket_for(n) not in pre_warmed
                    for n in cache.chunks(len(queries))
                )
                # one dispatch per generation among the members (one,
                # except across a swap): a query is predicted by the
                # generation that parsed it
                by_gen: dict = {}
                for i, p in enumerate(batch):
                    by_gen.setdefault(id(p[6]), (p[6], []))[1].append(i)
                results = [None] * len(batch)
                # ONE trace a batch, linking every member's trace: "which
                # requests shared this dispatch" is answerable from
                # /traces.json; the device time lands on it as
                # execute.device through the active-trace contextvar
                with self._service.tracer.trace(
                    "microbatch", links=[p[8] for p in batch if p[8]],
                    batch=len(batch),
                ) as btr:
                    for gen, idx in by_gen.values():
                        got = self._service._predict_batch(
                            [queries[i] for i in idx], gen)
                        for i, r in zip(idx, got):
                            results[i] = r
                exec_s = monotonic_s() - t_drain
                bucket = cache.bucket_for(len(batch))
                samples = self._bucket_samples.get(bucket)
                if samples is None:
                    samples = self._bucket_samples[bucket] = (
                        collections.deque(maxlen=64)
                    )
                for p, r in zip(batch, results):
                    p[1] = r
                    p[5]["execute_s"] = exec_s
                    p[5]["batch_id"] = btr.trace_id
                    if fresh:
                        p[5]["fresh_bucket"] = True
                    else:
                        samples.append(p[5]["queue_s"] + exec_s)
            except Exception:
                log.exception(
                    "micro-batch dispatch failed; per-query fallback "
                    "(runs in each request's own thread)"
                )
                for p in batch:
                    p[2] = _BATCH_FAILED
            for p in batch:
                p[3].set()


def stripe_generation_lines(seg: PoolMetricsSegment) -> List[str]:
    """``pio_tpu_pool_stripe_generation`` of every worker stripe, read from
    the shared segment at each scrape."""
    lines = [
        "# HELP pio_tpu_pool_stripe_generation Pool metrics stripe "
        "ownership generation per worker slot (bumped at every respawn; "
        "negative = retired, totals frozen)",
        "# TYPE pio_tpu_pool_stripe_generation gauge",
    ]
    for w, g in enumerate(seg.generations()):
        lines.append(f'pio_tpu_pool_stripe_generation{{worker="{w}"}} {g}')
    return lines


class _Generation:
    """One deployed generation and its reader count (under the service's
    ``_swap_lock``). ``resident`` is its (model, scorer) placements."""

    __slots__ = ("instance_id", "pairs", "serving", "query_class",
                 "resident", "readers", "swapped")

    def __init__(self, instance_id, pairs, serving, query_class, resident):
        self.instance_id = instance_id
        self.pairs = pairs
        self.serving = serving
        self.query_class = query_class
        self.resident = resident
        self.readers = 0
        self.swapped = False

    def scorers(self) -> list:
        return [sc for _, sc in self.resident]

    def packed_scorer(self):
        """The scorer that serves packed int8 frames: exactly one
        resident scorer on the int8 wire, with both of its template's
        factories (the drainer mints queries, a local frame maps its
        class code straight to the result)."""
        if len(self.resident) != 1:
            return None
        sc = self.resident[0][1]
        if (sc.wire != residency.WIRE_INT8 or sc.query_factory is None
                or sc.result_factory is None):
            return None
        return sc


class QueryService:
    """The deployed engine: its current generation, the micro-batcher and
    bucket ladder, and the pool wiring.

    ``device`` is the serving device of the resident scorers (CUDA unless
    told otherwise); it is resolved only where residency is enabled.
    ``instance_id`` names the stored engine instance the models came from
    (None for models handed over in memory); ``variant`` and ``ctx``,
    given for a stored instance, let ``/reload`` load the newest one.
    ``admin_key``, when set, is the key ``/reload`` and ``/undeploy``
    need; they are otherwise loopback-only. ``feedback`` with
    ``feedback_app_id`` writes every answer back as a ``predict`` event;
    ``slos`` (specs, else ``PIO_TPU_SLO``) and ``qos`` (a spec or policy,
    else ``PIO_TPU_QOS``, else the variant's ``qos`` block) configure the
    SLO engine and the QoS gate."""

    def __init__(self, engine: Engine, engine_params: EngineParams,
                 models: Sequence[Any], device: DeviceLike = None,
                 instance_id: Optional[str] = None,
                 admin_key: Optional[str] = None,
                 variant: Optional[EngineVariant] = None,
                 ctx: Optional[ComputeContext] = None,
                 mesh_devices: Optional[Sequence[DeviceLike]] = None,
                 feedback: bool = False,
                 feedback_app_id: Optional[int] = None,
                 slos: Optional[List[str]] = None,
                 qos: Any = None):
        self.variant = variant
        self.feedback = feedback
        self.feedback_app_id = feedback_app_id
        self._mesh_devices = (None if mesh_devices is None
                              else tuple(mesh_devices))
        #: the current generation's sharding block (None: not sharded)
        self._sharding_info: Optional[dict] = None
        self.ctx = ctx
        self.admin_key = admin_key
        self.server: Optional["QueryServer"] = None
        #: set by mark_evloop_front() when the evloop front serves: the
        #: micro-batcher is bypassed there
        self._evloop_front = False
        self.start_time = dt.datetime.now(dt.timezone.utc)
        self._lock = threading.Lock()
        self.request_count = 0
        #: totals of every resident dispatch (the scorers' bound counters)
        self.resident_counts = {"h2dBytes": 0, "hit": 0, "miss": 0}
        self.device: Optional[torch.device] = None
        if residency.enabled(device):
            self.device = resolve_device(device)
        self._buckets = BucketExecutionCache()
        #: batched dispatches by bucket (padded batch size)
        self.bucket_dispatches = {b: 0 for b in self._buckets.buckets}
        self._swap_lock = make_lock("query.model_swap")
        #: serializes loads (a /reload, a pool sync); re-entrant: a pool
        #: sync holds it across the load it runs
        self._load_lock = threading.RLock()
        self._gen: Optional[_Generation] = None
        #: swaps installed so far (``GET /deploy.json``): a rollout reads
        #: it to see that a member's generation flipped
        self._swap_generation = 0
        self._deployed = True
        self._batcher: Optional[_MicroBatcher] = None
        # pool mode (server/worker_pool.py), wired by enable_pool()
        self._pool_idx: Optional[int] = None
        self._pool_size: Optional[int] = None
        self._pool_gen = None
        self._pool_shutdown = None
        self._seen_gen = 0
        # the cross-worker batch lane, wired by enable_batch_lane()
        self._lane_seg: Optional[BatchLaneSegment] = None
        self._lane_client: Optional[LaneClient] = None
        self._lane_drainer: Optional[LaneDrainer] = None
        #: this worker's lane submissions, as a client
        self.lane_counts = {"enqueued": 0, "fallbacks": dict.fromkeys(
            LANE_FALLBACK_REASONS, 0)}
        self.heartbeat = Heartbeat(
            max_age_s=knobs.knob_float("PIO_TPU_HEARTBEAT_MAX_AGE_S"))
        self.health = HealthMonitor()
        self.health.add_liveness("http_loop", self._http_loop_alive)
        self.health.add_critical_thread(
            "microbatch_worker",
            lambda: self._batcher.thread if self._batcher else None)
        self.health.add_readiness("engine", self._check_engine_ready)
        self.health.add_readiness("storage", self._check_storage_ready)
        # the device ops plane: a per-service watch on this service's
        # registry, active before the first generation so that its
        # resident scorers book into it; the sampler reads the
        # allocator's counters off the dispatch path
        self.obs = MetricsRegistry()
        eng = variant.engine_id if variant is not None else ""
        self._engine_label = eng
        self._init_request_plane(slos, qos)
        self.obs.add_collector(faults.exposition_lines)
        watch_device = self.device if self.device is not None else (
            ctx.device if ctx is not None else None)
        self.devwatch = devicewatch.DeviceWatch(registry=self.obs,
                                                device=watch_device)
        devicewatch.activate(self.devwatch)
        if knobs.knob_str(devicewatch.SAMPLER_ENV) != "0":
            self.devwatch.start()
        self.profile_hook = DeviceProfileHook.from_env(
            cuda=watch_device is not None and watch_device.type == "cuda")
        # mesh-sharded serving (PIO_TPU_MESH_SERVE): the families exist
        # before the first placement
        self._shard_bytes_placed_total = self.obs.counter(
            "pio_tpu_shard_bytes_placed_total",
            "Model parameter bytes placed sharded across the serving "
            "mesh (summed over devices, once per deploy generation)",
            ("engine_id",),
        )
        self._shard_gather_fallback_total = self.obs.counter(
            "pio_tpu_shard_gather_fallback_total",
            "Mesh placements whose scorer chose an unsharded path (a "
            "one-device mesh or host-forced scoring); a failed placement "
            "raises instead",
            ("engine_id",),
        )
        self._shard_bytes_placed_total.labels(eng)
        self._shard_gather_fallback_total.labels(eng)
        self._install(engine, engine_params, models, instance_id)
        window_us = knobs.knob_float("PIO_TPU_SERVE_MICROBATCH_US")
        adaptive = knobs.knob_str("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE") != "0"
        if window_us > 0:
            self._batcher = _MicroBatcher(self, window_us / 1e6,
                                          adaptive=adaptive)

    def _init_request_plane(self, slos, qos) -> None:
        """The request and stage families, the tracer, the log ring, the
        SLO engine and the QoS gate with its scorer breaker."""
        eng = self._engine_label
        self._queries_total = self.obs.counter(
            "pio_tpu_queries_total", "Queries served", ("engine_id",))
        self._query_errors_total = self.obs.counter(
            "pio_tpu_query_errors_total", "Queries that errored",
            ("engine_id",))
        #: full-request latency: the latency SLO's source
        self._request_cell = self.obs.histogram(
            "pio_tpu_request_seconds",
            "Full-request wall seconds of /queries.json", ("engine_id",),
        ).labels(eng)
        #: accept to write, stamped after the write: what the client saw,
        #: and the denominator of the /debug/hotpath.json budget
        self._e2e_cell = self.obs.histogram(
            "pio_tpu_e2e_seconds",
            "End-to-end wall seconds of /queries.json (socket read "
            "through response write)", ("engine_id",),
        ).labels(eng)
        # bound once: every request bumps them
        self._queries_cell = self._queries_total.labels(eng)
        self._errors_cell = self._query_errors_total.labels(eng)
        self.tracer = Tracer(
            "query", registry=self.obs,
            stages=QUERY_STAGES + QUERY_SUBSTAGES,
            extra_labels={"engine_id": eng},
        )
        # tail capture: PIO_TPU_SLOW_TRACE_MS, the tightest latency SLO,
        # or the live p99 once there is enough signal
        self.tracer.slow_threshold_fn = lambda: slow_threshold_s(
            self.slo, self._e2e_cell)
        slog.install()
        self.obs.add_collector(slog.exposition_lines)
        if slos is None:
            slos = [x for x in knobs.knob_str("PIO_TPU_SLO").split(",")
                    if x.strip()]
        self.slo = None
        if slos:
            self.slo = engine_for_specs(
                slos, self.obs,
                availability_source=self._availability_good_total,
                latency_cell_getter=lambda: self._request_cell,
            )
        policy = resolve_policy(
            qos, self.variant.variant if self.variant is not None else None)
        self.qos = (QoSGate(policy, self.obs, scope="queryserver")
                    if policy is not None else None)
        self._scorer_breaker = (self.qos.breaker("scorer")
                                if self.qos is not None else None)

    # -- generations ---------------------------------------------------------
    @property
    def instance_id(self) -> Optional[str]:
        return self._gen.instance_id

    @property
    def pairs(self) -> list:
        return self._gen.pairs

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.resident_counts[key] += n

    def _place_resident(self, pairs) -> list:
        """Build, place and attach each pair's resident scorer on the
        serving device, the ladder's output tensors preallocated; a
        failure retires what was placed and raises."""
        placed = []
        try:
            for algo, m in pairs:
                sc = algo.resident_scorer(m, self.device)
                if sc is None:
                    continue
                sc.bind(on_h2d=lambda n: self._count("h2dBytes", n),
                        on_dispatch=self._count)
                sc.prealloc(self._buckets.buckets)
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
        """Retire scorers and take them off their models."""
        for m, sc in placed:
            sc.retire()
            if m.__dict__.get("_resident") is sc:
                del m._resident

    def _install(self, engine: Engine, engine_params: EngineParams,
                 models: Sequence[Any], instance_id: Optional[str]) -> None:
        """Build a generation on ``models`` (pairs, serving, query class,
        resident scorers, the warmed ladder) while the current one keeps
        serving, swap it in under ``_swap_lock``, and retire the outgoing
        generation once its readers have finished."""
        # the mesh attaches to every model before prepare_for_serving
        # (inside algorithms_with_models), where the templates build their
        # scorers (reference l.832-842)
        mesh = self._serving_mesh()
        if mesh is not None:
            for m in models:
                try:
                    m.__dict__["_serve_mesh"] = mesh
                except AttributeError:  # __slots__ model: no mesh channel
                    pass
        pairs = engine.algorithms_with_models(engine_params, models)
        serving = engine.make_serving(engine_params)
        # a conflicting query-class config fails the load, not a query
        query_class = resolve_query_class(pairs)
        sharding = self._place_mesh(pairs, mesh)
        incoming = (self._place_resident(pairs)
                    if self.device is not None else [])
        warmed = self._warm_buckets(pairs, serving)
        gen = _Generation(instance_id, pairs, serving, query_class, incoming)
        with self._swap_lock:
            self._sharding_info = sharding
            outgoing, self._gen = self._gen, gen
            self._swap_generation += 1
            self._buckets.install(warmed)
            if outgoing is not None:
                outgoing.swapped = True
            retire_now = outgoing is not None and outgoing.readers == 0
        # the generation the new placements went live under
        self.devwatch.set_generation(self._buckets.generation)
        if retire_now:
            self._retire_generation(outgoing)
        log.info("serving engine instance %s (generation %d, %d resident)",
                 instance_id, self._buckets.generation, len(incoming))

    def _serving_mesh(self) -> Optional[tuple]:
        """The devices to shard serving tables over, or None (reference
        l.889-902). Gate: ``PIO_TPU_MESH_SERVE=1``; unset or ``0`` keeps
        the single-device placement. The mesh is the devices this process
        owns: the ``mesh_devices`` the service was given, else every local
        CUDA device (the CPU alone on a CPU context). A mesh of one device
        is no mesh."""
        flag = knobs.knob_str("PIO_TPU_MESH_SERVE").strip().lower()
        if flag not in ("1", "on", "true"):
            return None
        devices = self._mesh_devices
        if devices is None:
            dev = self.ctx.device if self.ctx is not None else self.device
            if dev is not None and dev.type == "cuda":
                devices = tuple(torch.device("cuda", i)
                                for i in range(torch.cuda.device_count()))
            else:
                devices = (torch.device("cpu"),)
        if len(devices) <= 1:
            return None
        return tuple(devices)

    def _place_mesh(self, pairs, mesh) -> Optional[dict]:
        """Shard each shardable model's serving tables over the serving
        mesh (the scorer places them; ``ops/topn.py``), on the incoming
        pairs before the swap, so placement cost lands at deploy (reference
        l.904-975). A placement that fails raises, as the resident
        scorer's does: the reference serves single-device instead, which
        would hide the mesh. A scorer that chose an unsharded path is
        counted by ``pio_tpu_shard_gather_fallback_total``. Each shard is
        booked on the device ledger's ``shard`` category, on its own
        device."""
        # the incoming generation's sharded footprint replaces the old one
        self.devwatch.ledger_clear("shard")
        if mesh is None:
            return None
        eng = self._engine_label
        placed = []
        for _, m in pairs:
            if ("_serve_mesh" not in getattr(m, "__dict__", {})
                    or not hasattr(m, "scorer")):
                continue
            failpoint("shard.place")
            # prepare_for_serving built it over the mesh attached above
            sc = m.scorer(warmup=True)
            info = sc.sharding_info()
            if info is None:
                self._shard_gather_fallback_total.inc(engine_id=eng)
                continue
            info = dict(info, model=type(m).__name__)
            placed.append(info)
            for s, (dev, nbytes) in enumerate(sc.shard_bytes()):
                self.devwatch.ledger_place(
                    "shard", f"{type(m).__name__}/{s}", nbytes,
                    device=dev.index or 0,
                    name=f"sharded {type(m).__name__} shard {s}")
            self._shard_bytes_placed_total.inc(
                sum(b for _, b in sc.shard_bytes()), engine_id=eng)
            log.info("sharded placement: %s over %d device(s), %d B/device",
                     type(m).__name__, info["nDevices"],
                     info["bytesPerDevice"])
        return {"enabled": True, "meshDevices": len(mesh), "models": placed}

    @staticmethod
    def _retire_generation(gen: _Generation) -> None:
        """Retire a swapped-out generation's scorers. They stay attached
        to their models: no reader is left, and a late one would raise
        on the retired scorer rather than answer from the host mirror."""
        for _, sc in gen.resident:
            sc.retire()

    @contextlib.contextmanager
    def _reading(self):
        """The current generation, held as a reader for the duration of
        a dispatch: a swap does not retire it until the last reader is
        done."""
        with self._swap_lock:
            gen = self._gen
            gen.readers += 1
        try:
            yield gen
        finally:
            with self._swap_lock:
                gen.readers -= 1
                last = gen.swapped and gen.readers == 0
            if last:
                self._retire_generation(gen)

    def _load(self, instance_id: Optional[str]) -> None:
        """Load a stored instance (``None``: the variant's newest
        COMPLETED one) and swap it in."""
        if self.variant is None:
            raise HTTPError(
                400, "no stored engine instance to reload: this server "
                     "serves models handed over in memory")
        with self._load_lock:
            engine, engine_params = build_engine(self.variant)
            instance_id = resolve_instance_id(self.variant, instance_id)
            # loads serialize under _load_lock on purpose (one load at a
            # time); the blocking call the linter sees is a failpoint,
            # which sleeps only when a test arms a latency rule
            # pio: disable=lock-blocking-call
            models = load_models_for_instance(
                instance_id, engine, engine_params, self.ctx,
                variant=self.variant,
            )
            # pio: disable=lock-blocking-call
            self._install(engine, engine_params, models, instance_id)

    def close(self) -> None:
        """Stop the batcher and the lane drainer, and retire the current
        generation's scorers, taking them off their models."""
        if self._batcher is not None:
            self._batcher.stop()
        if self._lane_drainer is not None:
            self._lane_drainer.stop()
            self._lane_drainer = None
        if self._lane_seg is not None:
            self._lane_seg.close()
            self._lane_seg = None
        with self._swap_lock:
            gen = self._gen
            placed, gen.resident = gen.resident, []
        self._retire(placed)
        self.devwatch.stop()
        devicewatch.deactivate(self.devwatch)

    # -- bucket ladder -------------------------------------------------------
    def _bucket_warm_enabled(self) -> bool:
        """Warm the ladder only where batched dispatches happen: a
        micro-batching server or a batch-lane device worker.
        ``PIO_TPU_BUCKET_WARMUP=0`` forbids, ``=1`` forces."""
        flag = knobs.knob_str("PIO_TPU_BUCKET_WARMUP")
        if flag == "0":
            return False
        if flag == "1":
            return True
        if knobs.knob_float("PIO_TPU_SERVE_MICROBATCH_US") > 0:
            return True
        return self._lane_drainer is not None

    def _warm_buckets(self, pairs, serving) -> list:
        """Dispatch each bucket once with a representative query
        (``algo.warmup_query``), paying its one-off costs before the
        generation serves. Returns the warmed buckets: empty when warmup
        is off or no algorithm mints a warmup query (the ladder then
        warms on first live dispatch, counted as retraces)."""
        if not self._bucket_warm_enabled() or not pairs:
            return []
        wq = None
        for algo, m in pairs:
            try:
                wq = algo.warmup_query(m)
            except Exception:
                log.exception("warmup_query failed for %s",
                              type(algo).__name__)
            if wq is not None:
                break
        if wq is None:
            log.info("no algorithm provided a warmup query; buckets warm "
                     "on first dispatch")
            return []
        t0 = monotonic_s()
        warmed = []
        for b in self._buckets.buckets:
            try:
                # compile attribution: each bucket's first sweep on this
                # service's watch; each sweep is an execution of the
                # profile hook, as the reference's _run_batch captures its
                # warmup sweeps
                with self.devwatch.span("bucket_warmup", key=("bucket", b)), \
                        self.profile_hook.capture():
                    self._run_batch(pairs, serving, [wq] * b)
                warmed.append(b)
            except Exception:
                log.exception("bucket %d warmup dispatch failed", b)
                break
        log.info("bucket warmup: buckets %s in %.0f ms", warmed,
                 (monotonic_s() - t0) * 1e3)
        return warmed

    # -- dispatch ------------------------------------------------------------
    @staticmethod
    def _predict_with(gen: _Generation, query):
        predictions = [algo.predict(m, query) for algo, m in gen.pairs]
        return gen.serving.serve(query, predictions)

    def _predict_one(self, query, gen: Optional[_Generation] = None):
        """Per-query predict and serve on ``gen`` (None: the current
        generation, held for the call)."""
        if gen is None:
            with self._reading() as held:
                return self._predict_one(query, held)
        failpoint("scorer.dispatch.solo")
        t_dev = monotonic_s()
        with self.profile_hook.capture():
            out = self._predict_with(gen, query)
        # on whatever trace is active here: the request's (solo and
        # fallback paths); a no-op untraced. The predictions end with
        # their answers on the host, so the span closes after the card
        add_active_span("execute.device", monotonic_s() - t_dev)
        return out

    @staticmethod
    def _run_batch(pairs, serving, queries: list) -> list:
        """One ``batch_predict`` per algorithm over the whole (bucket-
        shaped) batch, then the per-query serving combine."""
        per_algo = []
        for algo, m in pairs:
            got = dict(algo.batch_predict(m, list(enumerate(queries))))
            per_algo.append([got[i] for i in range(len(queries))])
        return [
            serving.serve(q, [pa[i] for pa in per_algo])
            for i, q in enumerate(queries)
        ]

    def _predict_batch(self, queries: list,
                       gen: Optional[_Generation] = None) -> list:
        """Micro-batch dispatch (bucketed) on ``gen``; results only."""
        return self._predict_batch_bucketed(queries, gen)[0]

    def _predict_batch_bucketed(self, queries: list,
                                gen: Optional[_Generation] = None):
        """Serve a batch through the bucket ladder on one generation:
        chunk to the max bucket, pad each chunk to its bucket by
        replicating the last query, dispatch, slice the padding off.
        Returns ``(results, fresh)``, ``fresh`` when a chunk hit a cold
        bucket."""
        if gen is None:
            with self._reading() as held:
                return self._predict_batch_bucketed(queries, held)
        failpoint("scorer.dispatch.batch")

        def on_dispatch(n: int, bucket: int, fresh: bool) -> None:
            with self._lock:
                self.bucket_dispatches[bucket] = (
                    self.bucket_dispatches.get(bucket, 0) + 1)
            if fresh:
                # a live dispatch into a cold bucket: the first dispatch
                # of a shape the warmup should have paid (count only)
                self.devwatch.record_compile("bucket_dispatch")

        def run(qs):
            t_dev = monotonic_s()
            with self.profile_hook.capture():
                out = self._run_batch(gen.pairs, gen.serving, qs)
            # one observation a dispatch, on the active trace: the
            # micro-batch trace, or the lane drainer's untraced call
            add_active_span("execute.device", monotonic_s() - t_dev)
            return out

        return dispatch_bucketed(self._buckets, queries, run,
                                 on_dispatch=on_dispatch)

    # -- the query path ------------------------------------------------------
    @staticmethod
    def _parse_query(body: Any, qc):
        if body is None:
            raise HTTPError(400, "query body required")
        if not isinstance(body, dict):
            raise HTTPError(400, "query body must be a JSON object")
        if qc is None:
            return body  # raw dict queries
        try:
            return params_from_dict(qc, body)
        except ParamsError as e:
            raise HTTPError(400, str(e))

    @staticmethod
    def _decode(raw: bytes) -> Any:
        if not raw:
            raise HTTPError(400, "query body required")
        try:
            return json.loads(raw)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HTTPError(400, f"invalid JSON: {e}")

    def query(self, raw: bytes) -> Any:
        """Answer one JSON query body in process (the route's path, with
        no socket): the answer, or the route's ``HTTPError``."""
        return self._answer(Request("POST", "/queries.json", {}, None,
                                    raw_body=raw))[1]

    def _shed(self, body, reason: str, retry_after_s: float):
        """A shed decision as an answer: the stale cache's answer to
        ``body`` (200 under ``X-Pio-Degraded``) where degradation is on
        and it has one, else 429 (rate reasons) or 503 with
        ``Retry-After``. ``pio_tpu_qos_shed_total`` counts only the
        refusals; degraded answers have their own counter."""
        if self.qos.stale is not None and body is not None:
            cached = self.qos.stale.get(cache_key(body))
            if cached is not None:
                self.qos.count_degraded()
                return 200, cached, {DEGRADED_HEADER: DEGRADED_VALUE}
        self.qos.count_shed(reason)
        status = 429 if reason in ("rate_limit", "key_rate_limit") else 503
        raise HTTPError(status, f"overloaded: {reason}",
                        headers=retry_after_header(retry_after_s))

    def _admit(self, req: Request, body):
        """QoS admission of one request: ``(admission, breaker call,
        deadline, shed answer or None)``. The deadline counts from
        receipt; a malformed one is the client's error."""
        try:
            deadline = Deadline.from_header(
                req.header(DEADLINE_HEADER),
                default_ms=self.qos.policy.deadline_ms)
        except ValueError as e:
            raise HTTPError(400, str(e))
        timeout_s = (max(deadline.remaining_s(), 0.0)
                     if deadline is not None else None)
        adm = self.qos.admit(priority=req.header(PRIORITY_HEADER),
                             timeout_s=timeout_s)
        if not adm.ok:
            return adm, None, deadline, self._shed(
                body, adm.reason, adm.retry_after_s)
        bcall = None
        if self._scorer_breaker is not None:
            bcall = self._scorer_breaker.acquire()
            if not bcall.allowed:
                # the admission's slot goes back before the shed raises
                # (release is once only: the caller's is then a no-op)
                adm.release()
                return adm, bcall, deadline, self._shed(
                    body, "breaker", bcall.retry_after_s)
        return adm, bcall, deadline, None

    def _open_trace(self, tr, req: Request, pre_s: float, adm) -> float:
        """Head of a query's waterfall: the trace opens after admission,
        so rebase it to the socket read and record accept and admit (and
        the admission queue's wait, the tail of admit). Returns the
        admit stage's end."""
        tr.rebase(pre_s)
        tr.add_span("accept", req.read_s, rel_start_s=0.0)
        if adm is not None and adm.queue_wait_s > 0:
            tr.add_span("admit.queue", adm.queue_wait_s,
                        rel_start_s=max(pre_s - adm.queue_wait_s, 0.0))
        # end-aligned to now: the trace-open and rebase work stays inside
        # the budget instead of falling between spans
        rel_admit_end = tr.elapsed_s
        tr.add_span("admit", rel_admit_end - req.read_s,
                    rel_start_s=req.read_s)
        return rel_admit_end

    def _close_trace(self, tr, req: Request, rel_ser: float) -> None:
        """Tail of a query's waterfall: serialize, end-aligned to now,
        and the write, stamped once the answer is flushed (with the
        end-to-end latency, one clock read for both)."""
        rel_done_s = tr.elapsed_s
        tr.add_span("serialize", rel_done_s - rel_ser, rel_start_s=rel_ser)

        def written(write_s: float, _tr=tr, _rel=rel_done_s):
            done_s = _tr.elapsed_s
            _tr.add_span("write", done_s - _rel, rel_start_s=_rel)
            _tr.extend_total()
            self._e2e_cell.observe(done_s, exemplar=_tr.trace_id)

        req.on_written = written

    def _account(self, t0: float, trace_id, error: bool) -> None:
        self._request_cell.observe(monotonic_s() - t0, exemplar=trace_id)
        self._queries_cell.inc()
        if error:
            self._errors_cell.inc()

    def _answer(self, req: Request):
        """The JSON query path, admitted, traced and dispatched through
        the batch lane in a pool sibling, through the micro-batcher where
        it is on, else inline: ``(status, answer, headers)``. A shed
        answers from the stale cache or raises its 429/503."""
        if not self._deployed:
            raise HTTPError(503, "undeployed")
        self._pool_sync()
        t0 = monotonic_s()
        error = True
        adm = bcall = deadline = trace_id = None
        # adopt the caller's trace id and span, so one id names the
        # whole waterfall
        in_tid, in_parent = parse_trace_header(req.header(TRACE_HEADER))
        try:
            if self.qos is not None:
                body = req.body
                if body is None and req.raw_body:
                    try:
                        body = json.loads(req.raw_body)
                    except (UnicodeDecodeError, json.JSONDecodeError):
                        body = None  # parse answers the 400 below
                adm, bcall, deadline, shed = self._admit(req, body)
                if shed is not None:
                    error = False
                    return shed
            t_admitted = monotonic_s()
            with self.tracer.trace("query", trace_id=in_tid,
                                   parent=in_parent) as tr:
                trace_id = tr.trace_id
                rel_admit_end = self._open_trace(
                    tr, req, req.read_s + (t_admitted - t0), adm)
                body = self._decode(req.raw_body)
                # one generation parses, supplements and predicts it
                with self._reading() as gen:
                    query = gen.serving.supplement(
                        self._parse_query(body, gen.query_class))
                    rel_parse_end = tr.elapsed_s
                    tr.add_span("parse", rel_parse_end - rel_admit_end,
                                rel_start_s=rel_admit_end)
                    try:
                        if deadline is not None and deadline.expired():
                            # spent before the dispatch: nothing launches
                            raise DeadlineExceeded("deadline elapsed")
                        result, rel_ser = self._dispatch(
                            tr, rel_parse_end, body, query, gen, deadline)
                    except DeadlineExceeded:
                        error = False
                        return self._shed(body, "deadline", 0.0)
                    except HTTPError:
                        raise
                    except ValueError as e:
                        # a query the model cannot take, e.g. the wrong
                        # number of attributes: the client's error
                        raise HTTPError(400, str(e))
                    except Exception:
                        if bcall is not None:
                            bcall.failure()
                        raise
                if bcall is not None:
                    bcall.success()
                out = self._finish(body, to_jsonable(result))
                error = False
                with self._lock:
                    self.request_count += 1
                # inside the trace: the record carries its id, joining
                # /logs.json?trace_id= to /traces.json
                log.info("served query engine=%s ms=%.3f",
                         self._engine_label, (monotonic_s() - t0) * 1e3)
                self._close_trace(tr, req, rel_ser)
                # echo the id: an untraced caller learns which trace its
                # request minted, a traced one sees it adopted
                return 200, out, {TRACE_HEADER: tr.trace_id}
        finally:
            if bcall is not None:
                # exits that never reached the scorer release a half-open
                # probe grant; a no-op after success() or failure()
                bcall.cancel()
            if adm is not None:
                adm.release()
            self._account(t0, trace_id, error)

    def _dispatch(self, tr, rel_parse_end: float, body, query,
                  gen: _Generation, deadline):
        """Serve a parsed query on ``gen``, recording queue and execute
        (the micro-batcher records them from its worker; the lane and the
        inline predict here): ``(result, the execute stage's end)``, where
        serialize begins."""
        if self._lane_client is None and self._batcher is not None \
                and self._batcher.active() and not self._evloop_front:
            # (bypassed on the evloop front: submit parks the calling
            # thread for the batch window, and that thread is the loop)
            result = self._batcher.submit(query, gen, span_sink=tr,
                                          deadline=deadline)
            return result, tr.elapsed_s
        # no batcher: "queue" is the bookkeeping between parse and the
        # dispatch, end-aligned so the stages tile
        rel_exec = tr.elapsed_s
        tr.add_span("queue", rel_exec - rel_parse_end,
                    rel_start_s=rel_parse_end)
        if self._lane_client is not None:
            timeout_s = None
            if deadline is not None:
                timeout_s = max(0.005, min(self._lane_client.timeout_s,
                                           deadline.remaining_s() - 0.01))
            result = self._lane_submit(body, query, gen, timeout_s)
        else:
            result = self._predict_one(query, gen)
        rel_end = tr.elapsed_s
        tr.add_span("execute", rel_end - rel_exec, rel_start_s=rel_exec)
        return result, rel_end

    def _finish(self, body, out):
        """An answer's serialization tail: the output blockers (a
        ValueError vetoes it with a 400), feedback with its ``prId``, the
        sniffers, and the stale cache's feed."""
        for blocker in QUERY_BLOCKERS:
            try:
                blocker(body, out)
            except ValueError as e:
                raise HTTPError(400, str(e))
        if self.feedback:
            pr_id = uuid.uuid4().hex
            if isinstance(out, dict):
                out = {**out, "prId": pr_id}
            self._log_feedback(body, out, pr_id)
        for sniffer in QUERY_SNIFFERS:
            try:
                sniffer(body, out)
            except Exception:
                log.exception("query sniffer failed")
        if self.qos is not None and self.qos.stale is not None:
            self.qos.stale.put(cache_key(body), out)
        return out

    def _log_feedback(self, query_body, result, pr_id: str) -> None:
        """The reference's feedback loop: the answer back into the event
        store as a ``predict`` event on entity ``pio_pr``/``prId``."""
        if self.feedback_app_id is None:
            return
        try:
            Storage.get_levents().insert(
                Event(
                    event="predict",
                    entity_type="pio_pr",
                    entity_id=pr_id,
                    properties={"query": query_body, "prediction": result},
                    pr_id=pr_id,
                ),
                self.feedback_app_id,
            )
        except Exception:
            log.exception("feedback logging failed")

    def _lane_submit(self, body, query, gen: _Generation,
                     timeout_s: Optional[float] = None):
        """Ship a query to the device worker over the lane; any lane
        trouble serves it locally on ``gen``, counted by reason."""
        try:
            result = self._lane_client.submit(
                body, timeout_s=timeout_s,
                packed=self._lane_pack(query, gen))
        except LaneFallback as lf:
            self._note_lane_fallback(lf.reason)
            return self._predict_one(query, gen)
        with self._lock:
            self.lane_counts["enqueued"] += 1
        return result

    def _note_lane_fallback(self, reason: str) -> None:
        with self._lock:
            fb = self.lane_counts["fallbacks"]
            fb[reason] = fb.get(reason, 0) + 1

    def _lane_pack(self, query, gen: _Generation) -> Optional[bytes]:
        """``query`` as a packed int8 lane frame, or None to ship JSON:
        only where one resident scorer serves the int8 wire (the drainer
        dequantizes with the same training scales) and the query carries
        a dense feature vector."""
        vec = getattr(query, "vector", None)
        sc = gen.packed_scorer()
        if vec is None or sc is None:
            return None
        try:
            return pack_query_i8(sc.quantize(vec(sc.in_dim))[0])
        except ValueError:
            return None  # e.g. the wrong arity: the JSON path says so

    def _query_packed(self, req: Request):
        """The packed int8 wire: the body is a lane frame, validated
        structurally and shipped to the device worker as it is, or served
        locally; admitted and traced as a JSON query, with "parse" only
        the frame check (a shed has no stale-cache key: 429/503). Answers
        the JSON bytes of the result."""
        if not self._deployed:
            raise HTTPError(503, "undeployed")
        self._pool_sync()
        t0 = monotonic_s()
        error = True
        adm = bcall = deadline = trace_id = None
        in_tid, in_parent = parse_trace_header(req.header(TRACE_HEADER))
        frame = req.packed
        try:
            if not packed_frame_ok(frame):
                raise HTTPError(400, "malformed packed query frame")
            if self.qos is not None:
                # no stale-cache key for a binary body: a shed raises
                adm, bcall, deadline, _ = self._admit(req, None)
            t_admitted = monotonic_s()
            with self.tracer.trace("query", trace_id=in_tid,
                                   parent=in_parent) as tr:
                trace_id = tr.trace_id
                rel_admit_end = self._open_trace(
                    tr, req, req.read_s + (t_admitted - t0), adm)
                rel_parse_end = tr.elapsed_s
                tr.add_span("parse", rel_parse_end - rel_admit_end,
                            rel_start_s=rel_admit_end)
                try:
                    if deadline is not None and deadline.expired():
                        raise DeadlineExceeded("deadline elapsed")
                    rel_exec = tr.elapsed_s
                    tr.add_span("queue", rel_exec - rel_parse_end,
                                rel_start_s=rel_parse_end)
                    resp = None
                    if self._lane_client is not None:
                        timeout_s = None
                        if deadline is not None:
                            timeout_s = max(0.005, min(
                                self._lane_client.timeout_s,
                                deadline.remaining_s() - 0.01))
                        try:
                            resp = self._lane_client.submit_packed(
                                frame, timeout_s=timeout_s)
                            with self._lock:
                                self.lane_counts["enqueued"] += 1
                        except LaneFallback as lf:
                            self._note_lane_fallback(lf.reason)
                    if resp is None:
                        resp = self._query_packed_local(frame)
                    rel_ser = tr.elapsed_s
                    tr.add_span("execute", rel_ser - rel_exec,
                                rel_start_s=rel_exec)
                except DeadlineExceeded:
                    error = False
                    return self._shed(None, "deadline", 0.0)
                except HTTPError:
                    raise
                except Exception:
                    if bcall is not None:
                        bcall.failure()
                    raise
                if bcall is not None:
                    bcall.success()
                error = False
                with self._lock:
                    self.request_count += 1
                log.info("served packed query engine=%s ms=%.3f",
                         self._engine_label, (monotonic_s() - t0) * 1e3)
                self._close_trace(tr, req, rel_ser)
                return 200, RawResponse(
                    resp, content_type="application/json; charset=UTF-8",
                    headers={TRACE_HEADER: tr.trace_id})
        finally:
            if bcall is not None:
                bcall.cancel()
            if adm is not None:
                adm.release()
            self._account(t0, trace_id, error)

    def _query_packed_local(self, frame: bytes) -> bytes:
        """Serve a packed frame here: its codes ARE the int8 scorer's
        wire, so they dispatch straight to it and the class code maps to
        the result through the template's ``result_factory`` (whose
        serving passes results through unchanged)."""
        pq = unpack_query_i8(frame)
        with self._reading() as gen:
            sc = gen.packed_scorer()
            if sc is None:
                raise HTTPError(
                    400, "packed queries need exactly one int8 resident "
                         "scorer with its template's factories")
            failpoint("scorer.dispatch.packed")
            try:
                code = sc.score_wire(pq.codes.reshape(1, -1))[0]
                result = sc.result_factory(int(code))
            except ValueError as e:
                raise HTTPError(400, str(e))
        return json.dumps(to_jsonable(result)).encode("utf-8")

    def pack_query_body(self, body) -> Optional[bytes]:
        """A JSON query body as the packed int8 frame, or None where the
        deployment serves no packed queries. A test and benchmark helper:
        a real producer packs features with the published scales."""
        with self._reading() as gen:
            return self._lane_pack(gen.serving.supplement(
                self._parse_query(body, gen.query_class)), gen)

    # -- pool mode and the batch lane ---------------------------------------
    def enable_pool(self, idx: int, size: int, gen, shutdown_evt,
                    metrics_path: Optional[str] = None) -> None:
        """Wire this worker into a serving pool: ``gen`` is the shared
        generation counter (a ``/reload`` on any worker bumps it; the
        others reload before their next request), ``shutdown_evt`` the
        shared event ``/undeploy`` sets to bring the pool down.

        ``metrics_path`` is the supervisor's shared metrics segment
        (``obs/shm.py``): binding this worker's stripe makes its
        ``/metrics`` report pool-wide totals and its rate budget the
        pool's. Readiness needs the stripe (``pool_stripe``): a worker
        without it would under-report every pool-wide scrape. A segment
        that cannot be opened raises."""
        self._pool_idx = idx
        self._pool_size = size
        self._pool_gen = gen
        self._pool_shutdown = shutdown_evt
        self._seen_gen = gen.value
        self.health.add_liveness("event_loop", self.heartbeat.check)
        self.health.add_readiness("pool_stripe", self._check_pool_stripe)
        # pool-unique trace ids (query-w<i>-<n>) and worker-stamped logs
        self.tracer.set_worker(idx)
        slog.set_worker(idx)
        if metrics_path:
            seg = PoolMetricsSegment.open(metrics_path)
            self.obs.bind_pool_segment(seg, idx)
            # read at every scrape: the supervisor, another process,
            # bumps a stripe's generation at a respawn and negates it at
            # retirement
            self.obs.add_collector(lambda: stripe_generation_lines(seg))
            if self.qos is not None:
                # the admitted cells are live in the stripes now: history
                # from before the bind must not drain the bucket
                self.qos.on_pool_bound()

    def _check_pool_stripe(self):
        if self.obs.pool_bound:
            return True, f"stripe {self._pool_idx} bound"
        return False, "shared metrics segment not bound"

    def enable_batch_lane(self, path: str, doorbell, resp_events,
                          device: bool) -> None:
        """Wire this pool worker into the cross-worker batch lane: the
        device worker runs the drainer (every stripe into one bucketed
        dispatch), every other worker ships its queries over. A segment
        that cannot be opened raises: serving locally would hide the
        device worker."""
        seg = BatchLaneSegment.open(path)
        self._lane_seg = seg
        if not device:
            self._lane_client = LaneClient(
                seg, self._pool_idx, doorbell, resp_events[self._pool_idx])
            log.info("batch lane client up (worker %s)", self._pool_idx)
            return
        self._lane_drainer = LaneDrainer(
            seg, self._lane_dispatch, doorbell, resp_events).start()
        self.health.add_critical_thread(
            "batch_lane",
            lambda: self._lane_drainer.thread if self._lane_drainer
            else None)
        # the device worker now has batched dispatches to absorb: warm
        # the ladder if the deploy came before the lane
        if not self._buckets.warmed:
            with self._reading() as gen:
                warmed = self._warm_buckets(gen.pairs, gen.serving)
            if warmed:
                self._buckets.install(warmed)
        log.info("batch lane drainer up (device worker)")

    def _lane_dispatch(self, bodies: list) -> list:
        """Drainer side: parse each shipped body with this worker's
        generation and serve the drain cycle as one bucketed batch. A
        packed body dequantizes with the resident scorer's training
        scales, the submitter's too, so its codes re-quantize exactly."""
        self._pool_sync()
        with self._reading() as gen:
            sc = gen.packed_scorer()

            def to_query(b):
                if isinstance(b, PackedQuery):
                    if sc is None:
                        raise ValueError(
                            "packed lane query but no resident int8 "
                            "scorer on the device worker")
                    return sc.query_factory(sc.dequantize(b.codes))
                return self._parse_query(b, gen.query_class)

            queries = [gen.serving.supplement(to_query(b)) for b in bodies]
            results, _ = self._predict_batch_bucketed(queries, gen)
        return [to_jsonable(r) for r in results]

    def _pool_sync(self) -> None:
        """In a pool, reload once the shared generation moved; the
        generation counts as seen only after the load succeeded."""
        gen = self._pool_gen
        if gen is None or gen.value == self._seen_gen:
            return
        with self._load_lock:
            target = gen.value
            if target == self._seen_gen:
                return
            # the load lock is held across the load on purpose (see _load)
            self._load(None)  # pio: disable=lock-blocking-call
            self._seen_gen = target

    def mark_evloop_front(self) -> None:
        """The evloop front runs handlers inline in its loop: bypass the
        micro-batcher, whose ``submit`` parks the calling thread for the
        batch window. The pool's lane still applies; its wait is bounded
        by the lane timeout."""
        self._evloop_front = True

    # -- health --------------------------------------------------------------
    def _http_loop_alive(self):
        t = getattr(self.server, "_thread", None)
        if t is None:
            return True, "accept loop not thread-managed"
        return t.is_alive(), "accept loop thread " + (
            "alive" if t.is_alive() else "dead")

    def _check_engine_ready(self):
        with self._swap_lock:
            ok = self._deployed and bool(self._gen.pairs)
            iid = self._gen.instance_id
        if not self._deployed:
            return False, "undeployed"
        return ok, f"instance {iid}" if ok else "no algorithms loaded"

    def _check_storage_ready(self):
        """The deployed instance must still be in the metadata store (a
        vanished record means ``/reload`` can never succeed); models
        handed over in memory have none to check."""
        iid = self.instance_id
        if self.variant is None or iid is None:
            return True, "models handed over in memory"
        rec = Storage.get_meta_data_engine_instances().get(iid)
        if rec is None:
            return False, f"instance {iid} not in metadata store"
        return True, "metadata store reachable"

    # -- read-only routes ----------------------------------------------------
    # pio: endpoint=/stats.json
    def stats(self) -> dict:
        """``GET /stats.json``: the residency block (the reference's
        keys, plus the service's dispatch totals; ``measuredBytes`` is the
        device watch's measured bytes in use, sampled here: the
        allocator's on the card, null where only the ledger is kept), the
        ``buckets`` block with its dispatches per bucket, and where they
        apply ``microbatch``, ``batchLane``, ``worker`` and
        ``poolSize``."""
        with self._swap_lock:
            scorers = self._gen.scorers()
        self.devwatch.sample()
        with self._lock:
            totals = dict(self.resident_counts)
            dispatches = {str(b): n
                          for b, n in sorted(self.bucket_dispatches.items())}
            lane = {**self.lane_counts,
                    "fallbacks": dict(self.lane_counts["fallbacks"])}
            count = self.request_count
        out = {
            "requestCount": count,
            "residency": {
                "enabled": bool(scorers),
                "paramBytes": sum(sc.placed_bytes for sc in scorers),
                "measuredBytes": self.devwatch.measured_bytes(),
                "scorers": [sc.to_dict() for sc in scorers],
                "totals": totals,
            },
            "buckets": {**self._buckets.to_dict(), "dispatches": dispatches},
        }
        with self._swap_lock:
            sharding = self._sharding_info
        out["sharding"] = dict(sharding) if sharding else {"enabled": False}
        if sharding:
            out["sharding"]["measuredBytes"] = \
                out["residency"]["measuredBytes"]
        if self._batcher is not None:
            out["microbatch"] = self._batcher.to_dict()
        if self._lane_drainer is not None:
            out["batchLane"] = {
                "role": "drainer",
                "cycles": self._lane_drainer.cycles,
                "drained": self._lane_drainer.drained,
                "pendingDepth": self._lane_seg.pending_depth(),
            }
        elif self._lane_client is not None:
            out["batchLane"] = {
                "role": "client",
                "worker": self._pool_idx,
                "timeoutS": self._lane_client.timeout_s,
                "enqueued": lane["enqueued"],
                "fallbacks": lane["fallbacks"],
            }
        if self._pool_idx is not None:
            out["worker"] = self._pool_idx
            out["poolSize"] = self._pool_size
            if self.obs.pool_bound:
                # pool-wide totals (this block's other numbers are the
                # worker's own)
                out["pool"] = {
                    "requestCount": int(self._queries_cell._pool_value()),
                    "errorCount": int(self._errors_cell._pool_value()),
                }
        stages = self.tracer.stage_summary(QUERY_STAGES)
        if stages:
            out["stages"] = stages
        # the process's hand-written kernel launches: what a caller outside
        # the process (a pool's device worker) reads to see its path ran
        # through them
        out["kernelLaunches"] = launch_counts()
        return out

    def _availability_good_total(self):
        """Good and total queries, pool-wide in a pool (the SLO's view)."""
        total = self._queries_cell._pool_value()
        return total - self._errors_cell._pool_value(), total

    def status(self) -> dict:
        self._pool_sync()
        out = {
            "status": "deployed" if self._deployed else "undeployed",
            "algorithms": [type(a).__name__ for a, _ in self.pairs],
            "engineInstanceId": self.instance_id,
            "startTime": self.start_time.isoformat(),
            "requestCount": self.request_count,
        }
        if self._pool_idx is not None:
            out["worker"] = self._pool_idx
            out["pid"] = os.getpid()
        return out

    # -- routes ---------------------------------------------------------------
    def router(self) -> Router:
        r = Router()
        r.add("GET", "/", lambda req: (200, self.status()))
        r.add("GET", "/stats\\.json", lambda req: (200, self.stats()))
        r.add("GET", "/device\\.json",
              lambda req: (200, self.devwatch.payload()))
        r.add("GET", "/metrics",
              lambda req: (200, metrics_response(self.obs.render())))
        r.add("GET", "/traces\\.json", self.get_traces)
        r.add("GET", "/logs\\.json", logs_route)
        r.add("GET", "/slo\\.json",
              lambda req: (200, slo_payload(self.slo)))
        r.add("GET", "/qos\\.json", lambda req: (200, qos_payload(self.qos)))
        r.add("GET", "/debug/hotpath\\.json", self.get_hotpath)
        r.add("GET", "/plugins\\.json",
              lambda req: (200, installed_plugins()))
        r.add("GET", "/faults\\.json", lambda req: (200, faults.snapshot()))
        r.add("GET", "/debug/profile\\.json",
              lambda req: (200, self.profile_hook.to_dict()))
        r.add("POST", "/debug/profile\\.json", self.post_profile)
        r.add("POST", "/queries\\.json", self._route_query)
        r.add("GET", "/healthz", self.healthz)
        r.add("GET", "/readyz", self.readyz)
        r.add("POST", "/reload", self.reload)
        r.add("POST", "/deploy\\.json", self.deploy_verified)
        r.add("GET", "/deploy\\.json", self.deploy_report)
        r.add("POST", "/undeploy", self.undeploy)
        return r

    def _route_query(self, req: Request):
        if req.packed is not None:
            return self._query_packed(req)
        status, out, headers = self._answer(req)
        return status, json_response(out, headers)

    def get_traces(self, req: Request):
        """Recent traces, slowest first (``?order=recent`` newest first);
        ``?slow=1`` the slow ring; ``?id=`` one trace (404 when in no
        ring); ``?n=`` how many."""
        n = int_param(req.params, "n", 20, lo=0, hi=self.tracer._ring_cap)
        tid = req.params.get("id")
        if tid:
            found = self.tracer.find(tid)
            if found is None:
                raise HTTPError(404, f"trace {tid} not in any ring")
            return 200, {"traces": [found]}
        if req.params.get("slow") in ("1", "true"):
            return 200, {"traces": self.tracer.slow(n)}
        slowest = req.params.get("order", "slowest") != "recent"
        return 200, {"traces": self.tracer.recent(n, slowest=slowest)}

    def get_hotpath(self, req: Request):
        """Per-stage latency budget (count, mean, p50/p95 and the
        fraction of the end-to-end mean the stages attribute)."""
        return 200, hotpath_payload(
            self.tracer, self._e2e_cell,
            stage_order=QUERY_STAGES + QUERY_SUBSTAGES, pool=False,
            slow_threshold_s=slow_threshold_s(self.slo, self._e2e_cell))

    def healthz(self, req: Request):
        ok, report = self.health.liveness()
        return (200 if ok else 503), report

    def readyz(self, req: Request):
        ok, report = self.health.readiness()
        return (200 if ok else 503), report

    def post_profile(self, req: Request):
        """``?restart=1`` re-arms the profile hook for the next ``n``
        (default: the configured N) device executions, into the next
        ``capture-NNNN`` (admin-gated: profiling taxes the hot path and
        writes server-side files)."""
        self._check_admin(req)
        if req.params.get("restart") in ("1", "true"):
            n = int_param(req.params, "n", 0, lo=0)
            return 200, self.profile_hook.restart(n)
        return 200, self.profile_hook.to_dict()

    def _check_admin(self, req: Request) -> None:
        if self.admin_key is not None:
            if not keys_equal(req.bearer_key(), self.admin_key):
                raise HTTPError(401, "invalid admin accessKey")
        elif req.client_addr not in ("127.0.0.1", "::1"):
            raise HTTPError(
                403, "admin routes are loopback-only without an admin key"
            )

    def reload(self, req: Request):
        """Hot swap to the newest COMPLETED instance (reference
        ``/reload``); in a pool, bump the shared generation so every
        sibling reloads before its next request."""
        self._check_admin(req)
        self._load(None)
        self._bump_pool_generation()
        return 200, {"engineInstanceId": self.instance_id}

    def _bump_pool_generation(self) -> None:
        """In a pool, every sibling reloads before its next request."""
        if self._pool_gen is not None:
            with self._pool_gen.get_lock():
                self._pool_gen.value += 1
                self._seen_gen = self._pool_gen.value

    def deploy_verified(self, req: Request):
        """``POST /deploy.json``: the router's verified swap. The body is
        ``{engineInstanceId, manifest}``; every shard record the manifest
        names is hashed again from this member's store (sha256 and size)
        before the swap, and a mismatch answers 409 while the current
        generation keeps serving. Then the instance swaps in as by
        ``/reload`` (pool siblings follow through the shared generation,
        which loads the newest COMPLETED instance)."""
        from pio_tpu_torch.router.deploy import (
            DeployVerifyError,
            verify_instance,
        )

        self._check_admin(req)
        body = req.body if isinstance(req.body, dict) else {}
        instance_id = body.get("engineInstanceId")
        if not instance_id:
            raise HTTPError(400, "engineInstanceId is required")
        try:
            report = verify_instance(Storage.get_model_data_models(),
                                     instance_id,
                                     expected=body.get("manifest"))
        except DeployVerifyError as e:
            raise HTTPError(409, f"deploy verification failed: {e}") from e
        self._load(instance_id)
        self._bump_pool_generation()
        report["engineInstanceId"] = self.instance_id
        report["verified"] = True
        return 200, report

    def deploy_report(self, req: Request):
        """``GET /deploy.json``: the instance this member serves, its
        manifest's sha256 set (empty for an unsharded blob) and the swap
        generation: a rollout's incumbent discovery, and the witness that
        a rollback left the shas where the rollout found them."""
        from pio_tpu_torch.router.deploy import (
            load_manifest,
            manifest_digests,
        )

        shas = []
        try:
            manifest = load_manifest(Storage.get_model_data_models(),
                                     self.instance_id)
            if manifest is not None:
                shas = sorted(sha for sha, _size
                              in manifest_digests(manifest).values())
        except Exception:
            log.exception("no manifest digests for instance %s",
                          self.instance_id)
        with self._swap_lock:
            generation = self._swap_generation
        return 200, {
            "engineInstanceId": self.instance_id,
            "engineId": self._engine_label,
            "manifestSha256": shas,
            "generation": generation,
        }

    def undeploy(self, req: Request):
        """Stop serving once this answer is written (reference parity:
        ``pio undeploy`` ends the serving process; in a pool, the shared
        event brings every worker down)."""
        self._check_admin(req)
        self._deployed = False
        if self._batcher is not None:
            self._batcher.stop()
        if self._lane_drainer is not None:
            # answer in-flight lane slots before the workers go
            self._lane_drainer.stop()
            self._lane_drainer = None
        server, shutdown_evt = self.server, self._pool_shutdown

        def after():
            if shutdown_evt is not None:
                shutdown_evt.set()
            if server is not None:
                # stop() blocks until the accept loop exits, which this
                # handler's thread must not wait for
                threading.Thread(target=server.stop, daemon=True).start()

        if server is not None or shutdown_evt is not None:
            req.after_response = after
        return 200, {"message": "undeployed"}


def _choose_front() -> str:
    """``PIO_TPU_HTTP_FRONT`` as the reference reads it: ``threaded`` or
    ``evloop``; another value warns and serves threaded, and so does
    ``evloop`` where TLS is configured (only the threaded front
    terminates it)."""
    front = knobs.knob_str("PIO_TPU_HTTP_FRONT").lower() or "threaded"
    if front not in ("threaded", "evloop"):
        log.warning("PIO_TPU_HTTP_FRONT=%r is not threaded|evloop; using "
                    "threaded", front)
        front = "threaded"
    if front == "evloop" and ssl_context_from_env() is not None:
        log.warning("PIO_TPU_HTTP_FRONT=evloop ignored: TLS is configured "
                    "and only the threaded front terminates it")
        front = "threaded"
    return front


class QueryServer:
    """A running query server on the front ``PIO_TPU_HTTP_FRONT`` picks
    (:attr:`front`, ``"threaded"`` or ``"evloop"``; :attr:`http` the front
    itself): :attr:`port`, :attr:`tls`, :meth:`start`,
    :meth:`serve_forever`, :meth:`stop`, and :meth:`close`, which also
    stops the batcher and retires the service's resident scorers."""

    def __init__(self, service: QueryService, host: str, port: int,
                 reuse_port: bool = False):
        self.front = _choose_front()
        if self.front == "evloop":
            from pio_tpu_torch.server.evfront import EvLoopHTTPServer

            self.http = EvLoopHTTPServer(
                service.router(), host, port,
                name="pio-tpu-torch-queryserver", ssl_context=None,
                reuse_port=reuse_port, registry=service.obs)
            service.mark_evloop_front()
        else:
            self.http = JsonHTTPServer(
                service.router(), host, port,
                name="pio-tpu-torch-queryserver", reuse_port=reuse_port)
        self.tls = self.http.tls
        self.service = service
        service.server = self

    @property
    def port(self) -> int:
        return self.http.port

    @property
    def _thread(self):
        """The front's serving thread (the liveness probe reads it)."""
        return self.http._thread

    def start(self) -> "QueryServer":
        """Serve in a background thread."""
        self.http.start()
        return self

    def serve_forever(self) -> None:
        """Serve in this thread until :meth:`stop` (from another)."""
        self.http.serve_forever()

    def stop(self) -> None:
        """Stop serving; idempotent."""
        self.http.stop()

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
    mesh_devices: Optional[Sequence[DeviceLike]] = None,
    feedback: bool = False,
    feedback_app_id: Optional[int] = None,
    slos: Optional[List[str]] = None,
    qos: Any = None,
) -> QueryServer:
    """A query server (not yet started) over in-memory ``models``; port 0
    picks a free port (read it back from :attr:`QueryServer.port`).
    ``device`` is the resident scorers' serving device; ``mesh_devices``
    the serving mesh of ``PIO_TPU_MESH_SERVE=1`` (default: every local
    CUDA device); ``feedback``, ``feedback_app_id``, ``slos`` and ``qos``
    as :class:`QueryService` takes them. The plugin modules of
    ``PIO_TPU_PLUGINS`` load first. ``/reload`` answers 400: there is no
    stored instance to reload."""
    from pio_tpu_torch.server.plugins import load_plugins_from_env

    load_plugins_from_env()
    return QueryServer(QueryService(
        engine, engine_params, models, device, mesh_devices=mesh_devices,
        feedback=feedback, feedback_app_id=feedback_app_id, slos=slos,
        qos=qos), host, port)


def deploy_query_server(
    variant: EngineVariant,
    host: str = "0.0.0.0",
    port: int = 8000,
    instance_id: Optional[str] = None,
    device: DeviceLike = None,
    admin_key: Optional[str] = None,
    reuse_port: bool = False,
    mesh_devices: Optional[Sequence[DeviceLike]] = None,
    feedback: bool = False,
    feedback_app_id: Optional[int] = None,
    slos: Optional[List[str]] = None,
    qos: Any = None,
) -> QueryServer:
    """A query server (not yet started) over a stored engine instance, the
    way ``pio deploy`` builds it (the reference's ``create_query_server(
    variant, ...)``): ``build_engine``, then ``resolve_instance_id`` (the
    named instance, or the variant's latest COMPLETED one), then
    ``load_models_for_instance`` onto ``device`` (CUDA unless told
    otherwise), which falls back to the last known good instance of the
    variant when the blob fails verification. ``/reload`` loads the
    variant's newest instance the same way; ``reuse_port`` lets the
    processes of a serving pool share ``port``. ``mesh_devices`` is the
    serving mesh of ``PIO_TPU_MESH_SERVE=1`` (default: every local CUDA
    device); ``feedback``, ``feedback_app_id``, ``slos`` and ``qos`` as
    :class:`QueryService` takes them, the plugins of ``PIO_TPU_PLUGINS``
    loaded first. A server is one process: it joins no process group."""
    from pio_tpu_torch.server.plugins import load_plugins_from_env

    load_plugins_from_env()
    engine, engine_params = build_engine(variant)
    instance_id = resolve_instance_id(variant, instance_id)
    ctx = ComputeContext.local(device=device)
    models = load_models_for_instance(
        instance_id, engine, engine_params, ctx, variant=variant
    )
    service = QueryService(
        engine, engine_params, models, device=ctx.device,
        instance_id=instance_id, admin_key=admin_key, variant=variant,
        ctx=ctx, mesh_devices=mesh_devices, feedback=feedback,
        feedback_app_id=feedback_app_id, slos=slos, qos=qos,
    )
    return QueryServer(service, host, port, reuse_port=reuse_port)
