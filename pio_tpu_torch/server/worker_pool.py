"""SO_REUSEPORT serving pool — N query-server processes on one port.

The port's copy of ``pio_tpu/server/worker_pool.py``. CPython's GIL
serializes most per-request work in one process, so the pool runs N
worker processes that each bind the same TCP port with ``SO_REUSEPORT``;
the kernel balances incoming connections across them.

**Device ownership.** One process holds the card. With
``device_worker=True`` worker 0 serves on ``device`` (CUDA unless told
otherwise; it raises without a card) and every other worker hides the
card (``CUDA_VISIBLE_DEVICES=""``, set in :func:`_worker_main` before
anything can initialise CUDA) and serves on the CPU. Without a device
worker every worker serves on the CPU, which the caller must ask for
with ``device="cpu"``. CUDA does not survive ``fork``,
so workers start from the ``spawn`` context, and importing this module
initialises nothing on the card.

**The batch lane.** With a device worker and siblings, the supervisor
creates the shared-memory lane (``server/batchlane.py``): siblings ship
their queries to worker 0, whose drainer serves every stripe as one
bucketed dispatch, so batches grow with the pool instead of splitting
across it. A lane that cannot be created or opened raises (the
reference logs it and serves locally, which would hide the device
worker). A submission that finds its stripe full or times out is served
by the sibling's local predict, counted by reason in its ``/stats.json``.

Pool semantics (shared ``multiprocessing`` primitives):

- **/reload** on any worker bumps a shared generation counter after
  reloading itself; every sibling reloads before its next request.
- **/undeploy** on any worker sets a shared shutdown event; the
  supervisor stops every worker.
- **/stats.json** reports one worker's numbers, with ``worker`` and
  ``poolSize`` (the kernel picks the worker of a connection), and the
  pool-wide ``pool`` totals.
- **/metrics** on any worker reports pool-wide totals: the supervisor
  creates one shared metrics segment (``obs/shm.py``), every worker
  mirrors its counter and histogram cells into its own stripe, and a
  scrape sums the stripes. A respawned worker adopts its predecessor's
  stripe (the supervisor bumps its generation, exported as
  ``pio_tpu_pool_stripe_generation``), and a worker out of respawn budget
  leaves its stripe retired (a negative generation), its totals kept.
- Each worker also serves its routes on a loopback sidecar port; the
  supervisor polls its ``/healthz``, kills a worker after
  ``_HEALTH_FAILS_TO_KILL`` failures in a row, and respawns dead workers
  with exponential backoff within a budget per kill reason.

Start one with ``python -m pio_tpu_torch deploy --workers N
[--device-worker]`` or programmatically::

    pool = ServingPool(variant, port=8000, n_workers=4, device_worker=True)
    pool.start()
    pool.wait_ready()
    pool.wait()          # supervise until /undeploy or pool.stop()

``mesh_worker=True`` is the multi-device variant of the same ownership
(reference l.93-98): worker 0 serves with ``PIO_TPU_MESH_SERVE=1``, its
recommendation tables sharded over every local CUDA device (or the
``mesh_devices`` given), and the other workers stay off the card as with
``device_worker``. ``deploy --workers N --mesh-worker`` starts one.

Failpoint ``worker.serve`` fires on every turn of a worker's serve loop
(``worker.serve=crash:once`` kills one to exercise the respawn). A
``--faults`` spec reaches the workers through ``PIO_TPU_FAULTS``, which
they inherit and arm at import.

Each worker serves with the pool's SLOs, QoS policy and feedback app
(``slos``, ``qos``, ``feedback_app_id``), its trace ids namespaced
``query-w<i>-<n>``. ``inflight``, ``queue``, ``deadline``, ``cache`` and
the breaker are a worker's own, as in the reference. The ``rps=`` budget
is the pool's: each worker's bucket refills at the whole rate, mirrors its
admissions into its stripe and deducts its peers' (``qos/limiter.py``).
An ``rps=`` budget without the segment raises ``ValueError`` (N workers
would admit N times the rate); otherwise a segment that cannot be made is
logged and every worker reports itself not ready (``pool_stripe``), as in
the reference.

**The front.** ``http_front`` (``threaded`` or ``evloop``) is set as
``PIO_TPU_HTTP_FRONT`` in every worker before its server is built; None
leaves each worker the variable it inherits. It must be one front for the
whole pool: the evloop front registers metric families, and the shared
stripe's slots need one registration order in every worker. With
``evloop`` each worker runs one loop on the shared ``SO_REUSEPORT`` port.
The loopback sidecar stays threaded and plain HTTP whatever the front and
``PIO_TPU_SSL_*`` say: the supervisor's ``/healthz`` probe must get an
answer while the main front's loop is busy, and it speaks plain HTTP
(the reference's sidecar takes TLS from the environment, which would
fail that probe).
"""

from __future__ import annotations

import json
import logging
import multiprocessing as mp
import os
import socket
import tempfile
import time
import urllib.error
import urllib.request
from typing import Optional

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.obs.shm import PoolMetricsSegment
from pio_tpu_torch.qos import resolve_policy
from pio_tpu_torch.server.batchlane import BatchLaneSegment
from pio_tpu_torch.utils import knobs
from pio_tpu_torch.workflow.engine_json import EngineVariant

log = logging.getLogger("pio_tpu_torch.workerpool")

#: respawn budget per worker and kill reason: a worker that keeps dying
#: signals a real fault; a wedge the health sweep shot is usually load and
#: has its own budget
_MAX_RESPAWNS = 3
_MAX_RESPAWNS_BY_REASON = {"crash": _MAX_RESPAWNS, "unhealthy": 6}

#: respawn backoff: death N waits base * 2^(N-1), capped
_RESPAWN_BACKOFF_BASE_S = 0.5
_RESPAWN_BACKOFF_CAP_S = 30.0

#: a worker that served this long before dying was not crash-looping
_RESPAWN_RESET_AFTER_S = 60.0

#: consecutive /healthz failures before the supervisor kills a worker
_HEALTH_FAILS_TO_KILL = 3


def _worker_main(spec: dict, idx: int, gen, shutdown_evt,
                 health_ports=None, lane_doorbell=None,
                 lane_resp_events=None) -> None:
    """Entry point of one pool worker (spawned process)."""
    owns_device = (spec["device_worker"] or spec["mesh_worker"]) and idx == 0
    if owns_device:
        device = spec["device"]
        if spec["mesh_worker"]:
            # the mesh owner serves sharded over every device it owns
            os.environ["PIO_TPU_MESH_SERVE"] = "1"
    else:
        # a sibling never holds the card: hide it before anything can
        # initialise CUDA, and serve on the CPU
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        device = "cpu"

    from pio_tpu_torch.server.http import JsonHTTPServer
    from pio_tpu_torch.server.query_server import deploy_query_server

    if spec.get("http_front"):
        # one front for the whole pool (ServingPool's docstring)
        os.environ["PIO_TPU_HTTP_FRONT"] = spec["http_front"]
    variant = EngineVariant(**spec["variant"])
    # a respawn after a pool-wide /reload joins its siblings on the
    # newest COMPLETED instance, not the originally pinned one
    instance_id = spec.get("instance_id") if gen.value == 0 else None
    server = deploy_query_server(
        variant, host=spec["host"], port=spec["port"],
        instance_id=instance_id, device=device,
        admin_key=spec.get("admin_key"), reuse_port=True,
        mesh_devices=spec.get("mesh_devices") if owns_device else None,
        feedback=spec.get("feedback_app_id") is not None,
        feedback_app_id=spec.get("feedback_app_id"),
        slos=spec.get("slos"), qos=spec.get("qos"),
    )
    service = server.service
    service.enable_pool(idx, spec["n_workers"], gen, shutdown_evt,
                        metrics_path=spec.get("metrics_path"))
    if spec.get("lane_path") and lane_doorbell is not None:
        service.enable_batch_lane(spec["lane_path"], lane_doorbell,
                                  lane_resp_events, device=owns_device)
    server.start()
    # the pool shares ONE port, so the supervisor cannot address a given
    # worker through it: each worker also serves its routes on a
    # loopback port, published through the shared array. It stays on the
    # threaded front, in plain HTTP, whatever the main front is
    sidecar = JsonHTTPServer(service.router(), "127.0.0.1", 0,
                             name=f"pio-tpu-torch-health-{idx}",
                             ssl_context=None)
    sidecar.start()
    if health_ports is not None:
        health_ports[idx] = sidecar.port
    log.info("pool worker %d serving on :%d (device %s)", idx, server.port,
             device or "cuda")
    try:
        # poll the event, never park in Event.wait(): a worker killed
        # while registered as a sleeper corrupts the shared event. Each
        # turn beats the heartbeat that /healthz checks
        while not shutdown_evt.is_set():
            # `worker.serve=crash:once` kills this worker mid-serve to
            # exercise the supervisor's respawn
            failpoint("worker.serve")
            service.heartbeat.beat()
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    sidecar.stop()
    server.close()


class ServingPool:
    """Supervisor for a fixed-size SO_REUSEPORT query-server pool.

    ``device`` is the device worker's serving device (CUDA unless told
    otherwise); it is resolved in worker 0, never in the supervisor. A
    pool without a device (or mesh) worker serves on the CPU, so it needs
    ``device="cpu"`` and raises ``ValueError`` otherwise. ``mesh_worker``
    makes worker 0 the device worker serving sharded over ``mesh_devices``
    (default: every local CUDA device). ``slos``, ``qos`` and
    ``feedback_app_id`` reach every worker; a ``qos`` (or ``PIO_TPU_QOS``,
    or the variant's ``qos`` block) with a rate budget is one budget for
    the pool, kept in the shared metrics segment; where the segment
    cannot be made such a pool raises ``ValueError``. ``http_front``
    (``threaded``, ``evloop`` or None) is every worker's front (the
    module's docstring)."""

    def __init__(
        self,
        variant: EngineVariant,
        host: str = "0.0.0.0",
        port: int = 8000,
        n_workers: int = 2,
        instance_id: Optional[str] = None,
        admin_key: Optional[str] = None,
        device_worker: bool = False,
        device: Optional[str] = None,
        mesh_worker: bool = False,
        mesh_devices=None,
        slos=None,
        qos: Optional[str] = None,
        feedback_app_id: Optional[int] = None,
        http_front: Optional[str] = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        policy = resolve_policy(qos, variant.variant)
        # per-key buckets are a process's own in the reference too: only
        # the engine bucket needs the shared segment
        rate_budget = policy is not None and bool(policy.rps)
        device_worker = device_worker or mesh_worker
        if not device_worker and str(device) != "cpu":
            # every worker of a pool without a device worker serves on
            # the CPU: refuse rather than leave the card idle quietly
            raise ValueError("a pool serves on the card only through "
                             "device_worker=True; pass device='cpu' for a "
                             "pool on the CPU")
        self._ctx = mp.get_context("spawn")
        self._gen = self._ctx.Value("L", 0)
        self._shutdown = self._ctx.Event()
        self._host = host
        # port 0 → reserve an ephemeral port ALL workers can share: bind a
        # SO_REUSEPORT socket here and keep it open (bound but never
        # listening, so the kernel excludes it from connection balancing)
        self._anchor: Optional[socket.socket] = None
        if port == 0:
            self._anchor = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._anchor.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT,
                                    1)
            self._anchor.bind((host, 0))
            port = self._anchor.getsockname()[1]
        self.port = port
        self.device_worker = device_worker
        self._spec = {
            "variant": {
                "engine_id": variant.engine_id,
                "engine_version": variant.engine_version,
                "engine_factory": variant.engine_factory,
                "variant": variant.variant,
                "path": variant.path,
            },
            "host": host,
            "port": port,
            "n_workers": n_workers,
            "instance_id": instance_id,
            "admin_key": admin_key,
            "device_worker": device_worker,
            "mesh_worker": mesh_worker,
            "mesh_devices": (None if mesh_devices is None
                             else [str(d) for d in mesh_devices]),
            "device": None if device is None else str(device),
            "slos": None if slos is None else list(slos),
            "qos": qos,
            "feedback_app_id": feedback_app_id,
            "http_front": http_front,
        }
        self.n_workers = n_workers
        self._procs: list = []
        #: per-reason respawn counts of each worker
        self._respawns = [
            {r: 0 for r in _MAX_RESPAWNS_BY_REASON} for _ in range(n_workers)
        ]
        #: worker i spent its budget for a kill reason: never respawned
        self._retired = [False] * n_workers
        #: monotonic time before which worker i must not respawn (0: none
        #: scheduled)
        self._respawn_due = [0.0] * n_workers
        self._spawned_at = [0.0] * n_workers
        #: why the supervisor last killed worker i (None: died on its own)
        self._kill_reason: list = [None] * n_workers
        #: each worker's loopback sidecar port (0: not yet up)
        self._health_ports = self._ctx.Array("i", [0] * n_workers)
        self._health_fails = [0] * n_workers
        # the shared metrics segment: every worker mirrors its counters
        # into its own stripe, so a scrape of any worker sums the pool,
        # and the rps= budget is the pool's (qos/limiter.py)
        self._metrics_seg: Optional[PoolMetricsSegment] = None
        try:
            fd, seg_path = tempfile.mkstemp(prefix="pio-tpu-pool-metrics-",
                                            suffix=".shm")
            os.close(fd)
            try:
                self._metrics_seg = PoolMetricsSegment.create(seg_path,
                                                              n_workers)
            except BaseException:
                os.unlink(seg_path)
                raise
            self._spec["metrics_path"] = seg_path
        except (OSError, ValueError) as e:
            if rate_budget and n_workers > 1:
                raise ValueError(
                    f"the pool's shared metrics segment cannot be made "
                    f"({e}): without it each of the {n_workers} workers "
                    f"would admit the whole rps= budget") from e
            log.exception("pool metrics segment creation failed; workers "
                          "expose per-worker metrics and are not ready")
        # the cross-worker batch lane: only where ONE worker owns the card
        # and there are siblings to aggregate (PIO_TPU_BATCH_LANE=0 turns
        # it off); a lane that cannot be created raises
        self._lane_seg: Optional[BatchLaneSegment] = None
        self._lane_doorbell = None
        self._lane_resp_events = None
        if device_worker and n_workers > 1 \
                and knobs.knob_str("PIO_TPU_BATCH_LANE") != "0":
            fd, lane_path = tempfile.mkstemp(prefix="pio-tpu-batch-lane-",
                                             suffix=".shm")
            os.close(fd)
            try:
                self._lane_seg = BatchLaneSegment.create(lane_path,
                                                         n_workers)
            except BaseException:
                os.unlink(lane_path)
                raise
            self._spec["lane_path"] = lane_path
            self._lane_doorbell = self._ctx.Event()
            self._lane_resp_events = [self._ctx.Event()
                                      for _ in range(n_workers)]

    def _spawn(self, idx: int):
        self._health_ports[idx] = 0  # a stale port from a previous life
        self._health_fails[idx] = 0
        self._spawned_at[idx] = monotonic_s()
        if self._metrics_seg is not None:
            # the first spawn takes the stripe at generation 1, each
            # respawn bumps it: a scraper tells adoption from traffic
            self._metrics_seg.bump_generation(idx)
        p = self._ctx.Process(
            target=_worker_main,
            args=(self._spec, idx, self._gen, self._shutdown,
                  self._health_ports, self._lane_doorbell,
                  self._lane_resp_events),
            name=f"pio-tpu-torch-serve-{idx}",
            daemon=True,
        )
        p.start()
        return p

    def start(self) -> "ServingPool":
        self._procs = [self._spawn(i) for i in range(self.n_workers)]
        return self

    def _probe_host(self) -> str:
        return ("127.0.0.1" if self._host in ("", "0.0.0.0", "::")
                else self._host)

    def _ready(self, port: int) -> bool:
        """Does ``GET /readyz`` on ``port`` answer 200?"""
        try:
            with urllib.request.urlopen(
                f"http://{self._probe_host()}:{port}/readyz", timeout=2.0
            ) as r:
                return r.status == 200
        except (urllib.error.HTTPError, OSError):
            return False

    def wait_ready(self, timeout: float = 60.0) -> None:
        """Block until the pool answers ``GET /readyz`` 200 (a worker
        accepts connections before its engine has loaded) and, with a
        device worker, until worker 0 itself is ready: its death during
        startup raises, since the pool would otherwise serve without the
        card."""
        deadline = monotonic_s() + timeout
        while monotonic_s() < deadline:
            if self._shutdown.is_set():
                raise RuntimeError("pool shut down during startup")
            if all(not p.is_alive() for p in self._procs):
                raise RuntimeError("every pool worker exited during startup")
            if self.device_worker and not self._procs[0].is_alive():
                raise RuntimeError(
                    f"the device worker exited during startup (exit code "
                    f"{self._procs[0].exitcode})")
            dev_port = self._health_ports[0]
            if self._ready(self.port) and (
                    not self.device_worker
                    or (dev_port > 0 and self._ready(dev_port))):
                return
            time.sleep(0.1)
        raise TimeoutError(f"no pool worker ready on :{self.port}")

    def worker_stats(self, idx: int) -> dict:
        """``GET /stats.json`` of worker ``idx`` through its sidecar."""
        port = self._health_ports[idx]
        if port <= 0:
            raise RuntimeError(f"worker {idx} has no sidecar port yet")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats.json", timeout=5.0) as r:
            return json.loads(r.read())

    def _poll_worker_health(self, idx: int) -> Optional[bool]:
        """One /healthz probe of worker ``idx``'s sidecar; None while it
        has published no port."""
        port = self._health_ports[idx]
        if port <= 0:
            return None
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=1.0) as r:
                return r.status == 200
        except Exception:
            # a 503 raises HTTPError, a wedged worker times out: both are
            # failures for the consecutive count
            return False

    def _health_sweep(self) -> None:
        """Poll every live worker's sidecar; kill one after
        ``_HEALTH_FAILS_TO_KILL`` failures in a row, so the crash path
        replaces it (kill, not terminate: a wedged process may ignore
        SIGTERM)."""
        for i, p in enumerate(self._procs):
            if not p.is_alive():
                continue
            res = self._poll_worker_health(i)
            if res is None:
                continue
            if res:
                self._health_fails[i] = 0
                continue
            self._health_fails[i] += 1
            log.warning("worker %d failed /healthz (%d/%d consecutive)", i,
                        self._health_fails[i], _HEALTH_FAILS_TO_KILL)
            if self._health_fails[i] >= _HEALTH_FAILS_TO_KILL:
                log.error("worker %d unhealthy %d polls in a row; killing "
                          "for respawn", i, self._health_fails[i])
                self._kill_reason[i] = "unhealthy"
                p.kill()
                p.join(timeout=2.0)

    def _account_death(self, i: int, exitcode, now: float) -> None:
        """Count one observed death against its reason's budget and
        schedule the backed-off respawn, or retire the worker."""
        if self._retired[i]:
            return
        if self._spawned_at[i] > 0.0 \
                and now - self._spawned_at[i] >= _RESPAWN_RESET_AFTER_S:
            for r in self._respawns[i]:  # long-lived: not a crash loop
                self._respawns[i][r] = 0
        reason = self._kill_reason[i] or "crash"
        self._kill_reason[i] = None
        budget = _MAX_RESPAWNS_BY_REASON.get(reason, _MAX_RESPAWNS)
        if self._respawns[i].get(reason, 0) >= budget:
            log.error("worker %d died %d times (reason %s); not respawning",
                      i, self._respawns[i][reason], reason)
            self._retired[i] = True
            if self._metrics_seg is not None:
                # frozen, still summed: retirement keeps the pool totals
                self._metrics_seg.retire_stripe(i)
            return
        self._respawns[i][reason] = self._respawns[i].get(reason, 0) + 1
        delay = min(_RESPAWN_BACKOFF_CAP_S, _RESPAWN_BACKOFF_BASE_S
                    * 2 ** (self._respawns[i][reason] - 1))
        self._respawn_due[i] = now + delay
        log.warning("worker %d exited (code %s, reason %s); respawning in "
                    "%.1fs (%d/%d)", i, exitcode, reason, delay,
                    self._respawns[i][reason], budget)

    def wait(self, poll_s: float = 0.5, health_poll_s: float = 2.0) -> None:
        """Supervise until /undeploy (or :meth:`stop`): respawn dead
        workers within budget, kill and respawn workers that fail
        /healthz, then stop everything once the event fires."""
        next_health = monotonic_s() + health_poll_s
        while not self._shutdown.is_set():
            if monotonic_s() >= next_health:
                next_health = monotonic_s() + health_poll_s
                self._health_sweep()
            now = monotonic_s()
            for i, p in enumerate(self._procs):
                if p.is_alive() or self._shutdown.is_set():
                    continue
                if self._respawn_due[i] > 0.0:
                    # a respawn is scheduled: spawn once the backoff ran
                    if now >= self._respawn_due[i]:
                        self._respawn_due[i] = 0.0
                        self._procs[i] = self._spawn(i)
                    continue
                self._account_death(i, p.exitcode, now)
            if all(not p.is_alive() for p in self._procs) \
                    and all(self._retired) \
                    and not any(d > 0.0 for d in self._respawn_due):
                log.error("all workers dead and out of respawn budget")
                break
            # a plain sleep: nobody registers as a sleeper on the shared
            # event, so a killed process cannot corrupt it
            time.sleep(poll_s)
        self.stop()

    def stop(self, join_timeout: float = 5.0) -> None:
        self._shutdown.set()
        for p in self._procs:
            p.join(timeout=join_timeout)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        if self._anchor is not None:
            self._anchor.close()
            self._anchor = None
        if self._metrics_seg is not None:
            self._metrics_seg.unlink()
            self._metrics_seg = None
        if self._lane_seg is not None:
            self._lane_seg.unlink()
            self._lane_seg = None
