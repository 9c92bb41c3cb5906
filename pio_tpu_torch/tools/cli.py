"""`pio`-equivalent CLI of the port (reference ``tools/.../console/
Console.scala``, UNVERIFIED path; see SURVEY.md).

The port's copy of ``pio_tpu/tools/cli.py`` (the port imports nothing of
``pio_tpu``), with the quickstart's verbs: app, accesskey, train, eval,
eventserver, deploy, undeploy, batchpredict, import, export, status,
version; the ops plane's: runs, top, shell; and the stores': app compact,
upgrade (``--rebuild-search-index``) and blobserver. Arguments, output
lines and exit codes are the reference's.
``train``, ``deploy``, ``batchpredict`` and ``eval`` take ``--device
{cuda,cpu}`` (default ``cuda``): without a card the default exits non-zero
with :func:`~pio_tpu_torch.resolve_device`'s message, never carrying on
on the CPU. ``deploy`` serves from one process, or with ``--workers N``
from a pool of N processes on one port (``server/worker_pool.py``), of
which ``--device-worker`` lets worker 0 serve on ``--device`` while the
others serve on the CPU and send their queries to it over the batch
lane, and ``--mesh-worker`` lets worker 0 serve the recommendation
tables sharded over every local CUDA device (``PIO_TPU_MESH_SERVE``).
``train`` joins a process group when the env contract names one
(``PIO_TPU_COORDINATOR``, ``PIO_TPU_NUM_PROCESSES``, ``PIO_TPU_PROCESS_ID``;
one process a device, ``parallel/distributed.py``), rank 0 writing the
run: ALS (recommendation, similar-product, e-commerce), the text MLP,
logreg, two-tower and the sequence model split their work over the
ranks; naive Bayes trains a whole copy on every rank, as the reference's
has no multi-device path. ``train --profile-dir
D`` writes a ``torch.profiler`` trace of the run into D, and ``train`` serves the run's ``/train.json``,
``/device.json`` and ``/metrics`` on a loopback sidecar (``--status-port``,
else ``PIO_TPU_TRAIN_STATUS_PORT``: 0 an ephemeral port, printed at
start; negative none). ``status --device cpu`` names the CUDA devices
without opening one; under the env contract ``status`` joins the group
and prints the rank and the world.

``train``, ``deploy`` and ``eventserver`` take ``--faults SPEC`` (the
failpoint grammar of ``pio_tpu_torch/faults``): the spec is parsed before
anything starts, so a bad one exits 1, then exported as
``PIO_TPU_FAULTS`` (pool workers arm from it) and installed.

``deploy`` and ``eventserver`` take ``--slo SPEC`` (repeatable:
``p99=50ms:99.9``, ``availability=99.9``, an optional ``/6h`` window) and
``--qos SPEC`` (``rps=500,queue=64,deadline=100ms``; keys rps, burst,
key_rps, key_burst, inflight, queue, deadline, cache, fail_rate,
fail_window, probes, cooldown): each is parsed before anything starts, so
a bad one exits 1, then exported as ``PIO_TPU_SLO`` / ``PIO_TPU_QOS`` for
pool workers while the verb runs. Under ``deploy --workers N`` an
``rps=`` budget is the pool's (the shared metrics segment). ``deploy
--feedback-app NAME`` writes every answer back into that app as a
``predict`` event. ``PIO_TPU_PLUGINS`` names plugin modules the servers
load at start.

The pool plane and the router: ``fleet --targets H:P,...`` (the
aggregator: ``/fleet.json``, the federated ``/metrics``), ``dashboard``
(``/serving.html`` over ``--query-url``, the fleet panel over
``--fleet-targets``, the train panel over ``--train-url`` or
``PIO_TPU_TRAIN_STATUS_URL``), ``adminserver`` (apps and keys over
REST), ``route --targets H:P,...`` (the serving router, ``/router.json``;
``route --deploy IID --url U`` pushes a verified deploy through a running
router) and ``rollout --url U --start IID | --abort`` (the
shadow, canary and promote controller of a running router). None of these
touches a device: they serve, scrape and forward over HTTP, and the
members they front serve on the card. ``--targets`` falls back to
``PIO_TPU_FLEET_TARGETS``; none exits 1.

``template list`` prints the bundled engine factories; ``run
module:function [args...]`` calls a user entry point with the port
importable and storage configured (the passthrough list as its one
argument, or no argument where it takes none; an int it returns is the
exit code). The front of ``deploy`` is the knob ``PIO_TPU_HTTP_FRONT``
(``threaded`` or ``evloop``), which every pool worker inherits; there is
no flag for it, as in the reference.

``lint [paths]`` runs the port's static analysis (``pio_tpu_torch/
analysis``) over the port and its tests (``--json``, ``--list-rules``,
``--changed``/``--base``, ``--dump-{failpoints,callgraph,effects,
contracts}``); it exits 0 when clean and 1 on findings.

Usage: ``python -m pio_tpu_torch <verb> ...``
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import logging
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Optional

import torch

import pio_tpu_torch
from pio_tpu_torch import faults
from pio_tpu_torch.parallel import distributed
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.utils import knobs


def _out(s: str = ""):
    # flushed: a parent that reads a server's "listening on" line through
    # a pipe must not wait for a block buffer to fill
    print(s, flush=True)


def _err(s: str) -> int:
    print(f"[ERROR] {s}", file=sys.stderr, flush=True)
    return 1


def _arm_faults(args) -> None:
    """``--faults SPEC``: parse it first, so that a bad spec exits 1
    before anything starts; then export it for spawned workers (they arm
    from ``PIO_TPU_FAULTS`` at import) and arm this process."""
    spec = getattr(args, "faults", None) or None
    if not spec:
        return
    try:
        faults.parse_faults(spec)
    except faults.FaultError as e:
        raise SystemExit(_err(f"--faults: {e}"))
    os.environ[faults.ENV_VAR] = spec
    faults.install(spec)


def _request_plane(args) -> tuple:
    """``--slo`` and ``--qos``: parse them first, so that a bad spec exits
    1 before anything starts; then export them for spawned workers.
    Returns ``(slos or None, qos or None)``."""
    from pio_tpu_torch.obs.slo import parse_slo
    from pio_tpu_torch.qos import parse_qos

    slos = list(getattr(args, "slo", None) or []) or None
    qos = getattr(args, "qos", None) or None
    for spec in slos or ():
        try:
            parse_slo(spec)
        except ValueError as e:
            raise SystemExit(_err(f"--slo: {e}"))
    if qos:
        try:
            parse_qos(qos)
        except ValueError as e:
            raise SystemExit(_err(f"--qos: {e}"))
    if slos:
        os.environ["PIO_TPU_SLO"] = ",".join(slos)
    if qos:
        os.environ["PIO_TPU_QOS"] = qos
    return slos, qos


def _request_plane_flags(a) -> None:
    a.add_argument(
        "--slo", action="append", default=[], metavar="SPEC",
        help="declare a serving SLO, repeatable: p99=50ms:99.9 (99.9%% of "
             "requests within 50 ms) or availability=99.9, optional "
             "/WINDOW suffix (e.g. /6h); evaluated on /slo.json and "
             "exported as pio_tpu_slo_* gauges",
    )
    a.add_argument(
        "--qos", default=None, metavar="SPEC",
        help="admission control, e.g. 'rps=500,queue=64,deadline=100ms' "
             "(keys: rps, burst, key_rps, key_burst, inflight, queue, "
             "deadline, cache, fail_rate, fail_window, probes, cooldown); "
             "excess load is shed with 429/503 + Retry-After, state on "
             "/qos.json",
    )


def _faults_flag(a, example: str) -> None:
    a.add_argument(
        "--faults", default=None, metavar="SPEC",
        help=f"failpoint spec for fault drills, e.g. {example!r}; "
             "actions error, latency, torn-write, crash; state on "
             "/faults.json",
    )


def _resolve_app(name: str):
    app = Storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise SystemExit(_err(f"app {name!r} not found"))
    return app


def _channel_id(app_id: int, channel: Optional[str]):
    from pio_tpu_torch.data.store import resolve_channel

    try:
        return resolve_channel(app_id, channel)
    except ValueError as e:
        raise SystemExit(_err(str(e)))


def _context(args, seed: int = 0, group: bool = True) -> ComputeContext:
    """The run's context on ``--device`` (with ``group``, the process
    group's when the env contract names one); no card for ``cuda`` exits
    1 with resolve_device's message."""
    try:
        if group:
            return ComputeContext.create(seed=seed, device=args.device)
        return ComputeContext.local(seed=seed, device=args.device)
    except RuntimeError as e:
        raise SystemExit(_err(str(e)))


# ----------------------------------------------------------------- app verbs
def cmd_app_new(args) -> int:
    from pio_tpu_torch.storage.records import AccessKey, App

    apps = Storage.get_meta_data_apps()
    app_id = apps.insert(App(0, args.name, args.description))
    if app_id is None:
        return _err(f"app {args.name!r} already exists")
    key = Storage.get_meta_data_access_keys().insert(AccessKey("", app_id))
    _out(f"App created: id={app_id} name={args.name}")
    _out(f"Access key: {key}")
    return 0


def cmd_app_list(args) -> int:
    keys = Storage.get_meta_data_access_keys()
    for app in Storage.get_meta_data_apps().get_all():
        ks = [k.key for k in keys.get_by_app_id(app.id)]
        _out(f"id={app.id} name={app.name} accessKeys={','.join(ks) or '-'}")
    return 0


def cmd_app_delete(args) -> int:
    app = _resolve_app(args.name)
    for k in Storage.get_meta_data_access_keys().get_by_app_id(app.id):
        Storage.get_meta_data_access_keys().delete(k.key)
    for c in Storage.get_meta_data_channels().get_by_app_id(app.id):
        Storage.get_meta_data_channels().delete(c.id)
        _delete_events(app.id, c.id)
    _delete_events(app.id, None)
    Storage.get_meta_data_apps().delete(app.id)
    _out(f"App {args.name!r} deleted")
    return 0


def _delete_events(app_id, channel_id):
    from pio_tpu_torch.storage.registry import StorageConfigError

    try:
        Storage.get_levents().remove(app_id, channel_id)
    except StorageConfigError:
        # bulk-only backend (parquet) has no LEvents; delete via PEvents
        pe = Storage.get_pevents()
        ids = [e.event_id for e in pe.find(app_id, channel_id=channel_id)]
        if ids:
            pe.delete(ids, app_id, channel_id)


def cmd_app_data_delete(args) -> int:
    app = _resolve_app(args.name)
    _delete_events(app.id, _channel_id(app.id, args.channel))
    _out(f"Event data deleted for app {args.name!r}"
         + (f" channel {args.channel!r}" if args.channel else ""))
    return 0


def cmd_app_compact(args) -> int:
    """Reclaim space in the event store: eventlog drops tombstones and
    shadowed upserts, parquet merges shards. No-op for backends without a
    compact operation."""
    from pio_tpu_torch.storage.registry import StorageConfigError

    app = _resolve_app(args.name)
    channel_id = _channel_id(app.id, args.channel)
    try:
        backend = Storage.get_levents()
    except StorageConfigError:
        # bulk-only backend (parquet) has no LEvents side
        backend = Storage.get_pevents()
    if not hasattr(backend, "compact"):
        _out(f"backend {type(backend).__name__} does not need compaction")
        return 0
    n = backend.compact(app.id, channel_id)
    _out(
        f"compacted app {args.name!r}"
        + (f": reclaimed {n} bytes" if n is not None else "")
    )
    return 0


def cmd_channel_new(args) -> int:
    from pio_tpu_torch.storage.records import Channel

    app = _resolve_app(args.app)
    chans = Storage.get_meta_data_channels().get_by_app_id(app.id)
    if any(c.name == args.channel for c in chans):
        return _err(
            f"channel {args.channel!r} already exists for app {args.app!r}"
        )
    cid = Storage.get_meta_data_channels().insert(
        Channel(0, args.channel, app.id)
    )
    if cid is None:
        return _err(
            f"cannot create channel {args.channel!r} ({Channel.NAME_CONSTRAINT})"
        )
    _out(f"Channel created: id={cid} name={args.channel} app={args.app}")
    return 0


def cmd_channel_delete(args) -> int:
    app = _resolve_app(args.app)
    cid = _channel_id(app.id, args.channel)
    Storage.get_levents().remove(app.id, cid)
    Storage.get_meta_data_channels().delete(cid)
    _out(f"Channel {args.channel!r} deleted")
    return 0


# ----------------------------------------------------------- accesskey verbs
def cmd_accesskey_new(args) -> int:
    from pio_tpu_torch.storage.records import AccessKey

    app = _resolve_app(args.app)
    events = tuple(e for e in (args.events or "").split(",") if e)
    key = Storage.get_meta_data_access_keys().insert(
        AccessKey("", app.id, events)
    )
    _out(f"Access key: {key}")
    return 0


def cmd_accesskey_list(args) -> int:
    keys = Storage.get_meta_data_access_keys()
    items = (
        keys.get_by_app_id(_resolve_app(args.app).id) if args.app else keys.get_all()
    )
    for k in items:
        _out(f"key={k.key} appId={k.app_id} events={','.join(k.events) or '(all)'}")
    return 0


def cmd_accesskey_delete(args) -> int:
    if not Storage.get_meta_data_access_keys().delete(args.key):
        return _err("key not found")
    _out("Access key deleted")
    return 0


# -------------------------------------------------------------- train / eval
def cmd_train(args) -> int:
    from pio_tpu_torch.workflow.core_workflow import run_train
    from pio_tpu_torch.workflow.engine_json import build_engine, load_variant
    from pio_tpu_torch.workflow.params import WorkflowParams

    if args.checkpoint_dir and not args.checkpoint_every:
        raise SystemExit(_err(
            "--checkpoint-dir has no effect without --checkpoint-every N "
            "(nothing would be snapshotted)"
        ))
    _arm_faults(args)
    ctx = _context(args, args.seed)
    variant = load_variant(args.engine_json)
    engine, ep = build_engine(variant)
    wp = WorkflowParams(
        batch=args.batch,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
        seed=args.seed,
        profile_dir=args.profile_dir,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
    )
    status_port = args.status_port
    if status_port is None:
        status_port = knobs.knob_int("PIO_TPU_TRAIN_STATUS_PORT")
    status_server = None
    if status_port >= 0:
        from pio_tpu_torch.server.train_status import (
            create_train_status_server,
        )

        status_server = create_train_status_server(port=status_port)
        status_server.start()
        _out(f"Training status sidecar on 127.0.0.1:{status_server.port} "
             "(/train.json /device.json /metrics)")
    if ctx.group is not None:
        _out(f"Process group: rank {ctx.rank} of {ctx.world_size} on "
             f"{ctx.device}")
    try:
        instance_id = run_train(engine, ep, variant, wp, ctx=ctx)
    finally:
        if status_server is not None:
            status_server.stop()
        distributed.shutdown()
    _out(f"Training completed: engine instance {instance_id}")
    return 0


def cmd_runs(args) -> int:
    """The run registry: ``$PIO_TPU_HOME/runs/<engine-id>.jsonl``, one
    row per ``run_train``. Lists it by default; ``--diff`` compares the
    last two COMPLETED runs with the direction-aware regression logic
    (exit 1 on a regression)."""
    from pio_tpu_torch.obs import trainwatch
    from pio_tpu_torch.workflow.engine_json import load_variant

    engine_id = args.engine_id
    if not engine_id:
        engine_id = load_variant(args.engine_json).engine_id
    rows = trainwatch.read_runs(engine_id)
    if not rows:
        return _err(
            f"no recorded runs for engine {engine_id!r} "
            f"(ledger: {trainwatch.runs_path(engine_id)})"
        )
    if args.n and not args.diff:
        rows = rows[-args.n:]
    if args.json:
        _out(json.dumps(rows, indent=2, sort_keys=True))
        return 0
    if args.diff:
        done = [r for r in rows if r.get("status") == "COMPLETED"]
        if len(done) < 2:
            return _err(
                f"--diff needs two COMPLETED runs for {engine_id!r} "
                f"(have {len(done)})"
            )
        threshold = (
            args.threshold if args.threshold is not None
            else trainwatch.DEFAULT_RUN_THRESHOLD
        )
        lines, regressed = trainwatch.run_delta_table(
            done[-2], done[-1], threshold=threshold,
        )
        for line in lines:
            _out(line)
        if regressed:
            _err("run regression in: " + ", ".join(regressed))
            return 1
        return 0
    _out(f"{'run_id':<36} {'timestamp':<26} {'status':<10} "
         f"{'train_s':>9} {'algo':<12} {'loss':>10}")
    for r in rows:
        loss = r.get("final_loss")
        _out(f"{str(r.get('run_id') or '?'):<36} "
             f"{str(r.get('timestamp') or '?'):<26} "
             f"{str(r.get('status') or '?'):<10} "
             f"{r.get('train_seconds', 0):>9} "
             f"{str((r.get('step_summary') or {}).get('algo') or '-'):<12} "
             f"{loss if loss is not None else '-':>10}")
    return 0


def _import_attr(spec: str, call: bool = True):
    """Resolve ``module:attr``; with ``call`` (the eval-verb convention),
    zero-arg callables are invoked to produce the object."""
    mod_name, _, attr = spec.partition(":")
    mod = importlib.import_module(mod_name)
    if not attr:
        return mod
    obj = getattr(mod, attr)
    return obj() if call and callable(obj) else obj


def cmd_eval(args) -> int:
    from pio_tpu_torch.workflow.core_workflow import run_evaluation

    ctx = _context(args, group=False)
    evaluation = _import_attr(args.evaluation)
    generator = (
        _import_attr(args.engine_params_generator)
        if args.engine_params_generator
        else None
    )
    if generator is None:
        generator = getattr(evaluation, "engine_params_generator", None)
    if generator is None:
        return _err(
            "no EngineParamsGenerator: pass --engine-params-generator or set "
            ".engine_params_generator on the Evaluation"
        )
    result = run_evaluation(
        evaluation,
        generator,
        ctx=ctx,
        evaluation_class=args.evaluation,
        generator_class=args.engine_params_generator or "",
    )
    _out(f"Best params (score {result.best_score}):")
    _out(result.to_json())
    return 0


# ------------------------------------------------------------------- servers
def cmd_eventserver(args) -> int:
    from pio_tpu_torch.server.event_server import create_event_server

    slos, qos = _request_plane(args)
    _arm_faults(args)
    server = create_event_server(host=args.ip, port=args.port, slos=slos,
                                 qos=qos)
    _out(f"Event Server listening on {args.ip}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _out("shutting down")
    finally:
        server.stop()
    return 0


def cmd_blobserver(args) -> int:
    """Run the blob daemon — the remote Models endpoint (the HDFS/S3
    slot). Point MODELDATA at it: PIO_STORAGE_SOURCES_<N>_TYPE=blob,
    PIO_STORAGE_SOURCES_<N>_PATH=http://host:port[?accessKey=…]."""
    from pio_tpu_torch.server.blob_server import create_blob_server

    server = create_blob_server(
        args.root, host=args.ip, port=args.port, access_key=args.access_key
    )
    _out(f"Blob server serving {args.root} on {args.ip}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _out("shutting down")
    finally:
        server.stop()
    return 0


def cmd_dashboard(args) -> int:
    from pio_tpu_torch.server.dashboard import create_dashboard

    server = create_dashboard(
        host=args.ip, port=args.port, query_url=args.query_url,
        fleet_targets=args.fleet_targets, train_url=args.train_url,
    )
    _out(f"Dashboard listening on {args.ip}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _out("shutting down")
    finally:
        server.stop()
    return 0


def cmd_fleet(args) -> int:
    """Run the fleet telemetry aggregator: scrape every ``--targets``
    member, serve the federated ``/metrics`` and the ``/fleet.json``
    cluster status the router steers by."""
    from pio_tpu_torch.obs.fleet import TARGETS_ENV, parse_targets
    from pio_tpu_torch.server.fleetd import create_fleet_server

    targets = args.targets or knobs.knob_str(TARGETS_ENV)
    if not parse_targets(targets):
        return _err("no fleet targets: pass --targets host:port,... or set "
                    f"{TARGETS_ENV}")
    server = create_fleet_server(
        targets, host=args.ip, port=args.port, interval_s=args.interval,
    )
    server.service.agg.start()
    members = ", ".join(m.name for m in server.service.agg.members())
    _out(f"Fleet aggregator listening on {args.ip}:{server.port} "
         f"(members: {members})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _out("shutting down")
    finally:
        server.service.agg.stop()
        server.stop()
    return 0


def _route_deploy(args) -> int:
    """``route --deploy IID``: push a manifest-verified deploy through the
    router at ``--url``; exit 0 only if every member verified."""
    import urllib.error
    import urllib.request

    body = json.dumps({"engineInstanceId": args.deploy}).encode()
    headers = {"Content-Type": "application/json; charset=utf-8"}
    if args.admin_key:
        headers["Authorization"] = f"Bearer {args.admin_key}"
    req = urllib.request.Request(args.url.rstrip("/") + "/deploy",
                                 data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            report = json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return _err(f"deploy failed: HTTP {e.code}: "
                    f"{e.read().decode('utf-8', 'replace')[:500]}")
    except Exception as e:
        return _err(f"deploy failed: cannot reach router at {args.url}: "
                    f"{e}")
    for row in report.get("members", []):
        _out(f"  {row['member']}: {row['outcome']}")
    ok = report.get("verified") == len(report.get("members", []))
    _out(f"instance {report.get('engineInstanceId')}: "
         f"{report.get('verified')}/{len(report.get('members', []))} "
         f"member(s) verified")
    return 0 if ok else 1


def cmd_route(args) -> int:
    """Run the serving-router daemon, or with ``--deploy`` push a
    manifest-verified deploy through a running one."""
    if args.deploy:
        return _route_deploy(args)
    from pio_tpu_torch.obs.fleet import TARGETS_ENV, parse_targets
    from pio_tpu_torch.server.routerd import create_router_server

    targets = args.targets or knobs.knob_str(TARGETS_ENV)
    if not parse_targets(targets):
        return _err("no serving members: pass --targets host:port,... or "
                    f"set {TARGETS_ENV}")
    server = create_router_server(
        parse_targets(targets), host=args.ip, port=args.port,
        partitions=args.partitions, interval_s=args.interval,
        admin_key=args.admin_key, timeout_s=args.timeout,
    )
    server.service.start()
    members = ", ".join(m.name for m in server.service.agg.members())
    _out(f"Serving router listening on {args.ip}:{server.port} "
         f"(members: {members})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _out("shutting down")
    finally:
        server.service.stop()
        server.stop()
    return 0


#: ``rollout --start`` flags → the ``POST /rollout`` body's keys
_ROLLOUT_KNOBS = (
    ("shadow_rate", "shadowRate"),
    ("shadow_min_samples", "shadowMinSamples"),
    ("shadow_hold", "shadowHoldSeconds"),
    ("canary_fraction", "canaryFraction"),
    ("canary_hold", "canaryHoldSeconds"),
    ("canary_min_requests", "canaryMinRequests"),
    ("judge_interval", "judgeIntervalSeconds"),
    ("judge_fast", "judgeFastSeconds"),
    ("judge_slow", "judgeSlowSeconds"),
    ("burn_limit", "burnLimit"),
    ("mismatch_limit", "mismatchLimit"),
    ("incumbent", "incumbentInstance"),
)


def _print_rollout(ro: dict) -> None:
    _out(f"stage: {ro.get('stage')}")
    if ro.get("stage") == "idle":
        return
    _out(f"candidate: {ro.get('candidateInstance')}  "
         f"incumbent: {ro.get('incumbentInstance')}")
    shadow = ro.get("shadow") or {}
    _out(f"shadow: {shadow.get('samples', 0)} samples, "
         f"mismatch rate {shadow.get('mismatchRate', 0.0)}, "
         f"{shadow.get('dropped', 0)} dropped")
    canary = ro.get("canary") or {}
    _out(f"canary: {canary.get('requests', 0)} requests at fraction "
         f"{canary.get('fraction')}")
    judge = ro.get("judge") or {}
    _out(f"judge: {judge.get('ticks', 0)} ticks, last verdict "
         f"{judge.get('lastVerdict')}, burn {judge.get('burnRates')}")
    for entry in ro.get("trail") or []:
        window = f" [{entry['window']}]" if entry.get("window") else ""
        detail = f" — {entry['detail']}" if entry.get("detail") else ""
        _out(f"  {entry.get('from')} -> {entry.get('to')}: "
             f"{entry.get('signal')}{window}{detail}")


def cmd_rollout(args) -> int:
    """Drive the rollout controller of a running router: start a
    shadow, canary and promote rollout, abort one, or print the live
    stage and the decision trail."""
    import urllib.error
    import urllib.request

    base = args.url.rstrip("/")
    headers = {"Content-Type": "application/json; charset=utf-8"}
    if args.admin_key:
        headers["Authorization"] = f"Bearer {args.admin_key}"

    def call(method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data,
                                     headers=headers, method=method)
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    try:
        if args.start:
            body = {"engineInstanceId": args.start,
                    "targets": args.targets or "", "by": "pio rollout"}
            for attr, key in _ROLLOUT_KNOBS:
                val = getattr(args, attr)
                if val is not None:
                    body[key] = val
            ro = call("POST", "/rollout", body).get("rollout") or {}
            _out(f"rollout #{ro.get('generation')} of {args.start} "
                 f"started: stage {ro.get('stage')}")
            return 0
        if args.abort:
            ro = call("POST", "/rollout/abort", {}).get("rollout") or {}
            _out(f"rollout aborted: stage {ro.get('stage')}")
            return 0
        ro = call("GET", "/rollout.json")
    except urllib.error.HTTPError as e:
        return _err(f"rollout request failed: HTTP {e.code}: "
                    f"{e.read().decode('utf-8', 'replace')[:500]}")
    except Exception as e:
        return _err(f"cannot reach router at {base}: {e}")
    _print_rollout(ro)
    return 0


def cmd_adminserver(args) -> int:
    from pio_tpu_torch.server.admin import create_admin_server

    server = create_admin_server(host=args.ip, port=args.port,
                                 admin_key=args.admin_key)
    _out(f"Admin API listening on {args.ip}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _out("shutting down")
    finally:
        server.stop()
    return 0


def cmd_deploy(args) -> int:
    from pio_tpu_torch.server.query_server import deploy_query_server
    from pio_tpu_torch.workflow.engine_json import load_variant

    slos, qos = _request_plane(args)
    _arm_faults(args)
    feedback_app_id = (_resolve_app(args.feedback_app).id
                       if args.feedback_app else None)
    if args.workers > 1:
        return _deploy_pool(args, load_variant(args.engine_json), slos, qos,
                            feedback_app_id)
    for flag in ("device_worker", "mesh_worker"):
        if getattr(args, flag):
            return _err(f"--{flag.replace('_', '-')} needs --workers > 1")
    device = _context(args, group=False).device
    variant = load_variant(args.engine_json)
    server = deploy_query_server(
        variant,
        host=args.ip,
        port=args.port,
        instance_id=args.engine_instance_id,
        device=device,
        admin_key=args.admin_key,
        feedback=feedback_app_id is not None,
        feedback_app_id=feedback_app_id,
        slos=slos,
        qos=qos,
    )
    _out(
        f"Query Server for instance {server.service.instance_id} "
        f"listening on {args.ip}:{server.port}"
    )
    try:
        server.serve_forever()  # until POST /undeploy stops it
    except KeyboardInterrupt:
        _out("shutting down")
    finally:
        server.close()
    return 0


#: seconds a serving pool may take to load its models and become ready
POOL_READY_S = 120.0


def _deploy_pool(args, variant, slos=None, qos=None,
                 feedback_app_id=None) -> int:
    """``deploy --workers N``: a supervised SO_REUSEPORT pool. The device
    is resolved in the device worker, never here (one process holds the
    card); without a card its startup fails and this exits 1, and so does
    a QoS rate budget where the pool's shared metrics segment, which keeps
    the one budget of the pool, cannot be made."""
    from pio_tpu_torch.server.worker_pool import ServingPool

    try:
        pool = ServingPool(
            variant, host=args.ip, port=args.port, n_workers=args.workers,
            instance_id=args.engine_instance_id, admin_key=args.admin_key,
            device_worker=args.device_worker, device=args.device,
            mesh_worker=args.mesh_worker,
            mesh_devices=(args.mesh_devices.split(",")
                          if args.mesh_devices else None),
            slos=slos, qos=qos, feedback_app_id=feedback_app_id,
        )
    except ValueError as e:
        return _err(str(e))
    pool.start()
    try:
        # readiness-gated: "listening" only once a worker (and with
        # --device-worker, worker 0) passes every readiness check
        pool.wait_ready(timeout=POOL_READY_S)
    except (RuntimeError, TimeoutError) as e:
        pool.stop()
        return _err(f"serving pool failed to start: {e}")
    owner = (", mesh worker 0" if args.mesh_worker
             else ", device worker 0" if args.device_worker else "")
    _out(f"Query Server pool ({args.workers} workers{owner}) "
         f"listening on {args.ip}:{pool.port}")
    try:
        pool.wait()  # until POST /undeploy on any worker
    except KeyboardInterrupt:
        _out("shutting down pool")
        pool.stop()
    return 0


def cmd_undeploy(args) -> int:
    url = f"http://{args.ip}:{args.port}/undeploy"
    if args.admin_key:
        url += f"?accessKey={args.admin_key}"
    try:
        req = urllib.request.Request(url, data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            _out(resp.read().decode())
        return 0
    except urllib.error.HTTPError as e:
        return _err(f"query server refused undeploy: {e.code} "
                    f"{e.read().decode(errors='replace')}")
    except OSError as e:
        return _err(f"cannot reach query server at {url}: {e}")


def cmd_batchpredict(args) -> int:
    from pio_tpu_torch.workflow.batch_predict import run_batch_predict
    from pio_tpu_torch.workflow.engine_json import load_variant

    ctx = _context(args, group=False)
    variant = load_variant(args.engine_json)
    n = run_batch_predict(
        variant,
        args.input,
        args.output,
        instance_id=args.engine_instance_id,
        ctx=ctx,
    )
    _out(f"Batch predict done: {n} queries -> {args.output}")
    return 0


# ------------------------------------------------------------- import/export
def cmd_import(args) -> int:
    from pio_tpu_torch.tools.data_io import import_events

    app = _resolve_app(args.app)
    imported, failed = import_events(
        args.input, app.id, _channel_id(app.id, args.channel)
    )
    _out(f"Imported {imported} events ({failed} failed)")
    return 0 if failed == 0 else 1


def cmd_export(args) -> int:
    from pio_tpu_torch.tools.data_io import export_events

    app = _resolve_app(args.app)
    n = export_events(args.output, app.id, _channel_id(app.id, args.channel))
    _out(f"Exported {n} events -> {args.output}")
    return 0


# -------------------------------------------------------------------- status
def cmd_status(args) -> int:
    from pio_tpu_torch.storage.registry import pio_home

    _out(f"pio-tpu-torch {pio_tpu_torch.__version__}")
    _out(f"home: {pio_home()}")
    if args.device == "cpu":
        # device_count reads the CUDA device count without opening a device
        # (no CUDA context is made)
        _out(f"devices: ['cpu'] ({torch.cuda.device_count()} CUDA "
             f"device(s) not opened)")
    elif torch.cuda.is_available():
        names = [f"cuda:{k} {torch.cuda.get_device_name(k)}"
                 for k in range(torch.cuda.device_count())]
        _out(f"devices: {names}")
    else:
        _out("devices: unavailable (no CUDA device)")
    if distributed.env_configured():
        ctx = _context(args)
        _out(f"process group: rank {ctx.rank} of {ctx.world_size} "
             f"({torch.distributed.get_backend()}, {ctx.device})")
        distributed.shutdown()
    checks = Storage.verify_all_data_objects()
    ok = all(checks.values())
    for name, healthy in sorted(checks.items()):
        _out(f"  {'OK ' if healthy else 'FAIL'} {name}")
    _out("(sanity check " + ("passed)" if ok else "FAILED)"))
    try:
        insts = Storage.get_meta_data_engine_instances().get_all()
    except Exception:
        # status must degrade gracefully on the exact broken-backend
        # condition it reports (the FAIL lines above already said so)
        insts = []
    if insts:
        _out("recent engine instances:")
        for inst in sorted(
            insts, key=lambda i: i.start_time, reverse=True
        )[:5]:
            secs = inst.env.get("train_seconds", "")
            _out(
                f"  {inst.id[:12]}  {inst.status:<9} "
                f"{inst.engine_factory}"
                + (f"  ({secs}s)" if secs else "")
            )
    return 0 if ok else 1


def cmd_top(args) -> int:
    """Live device telemetry table: poll a ``/device.json`` surface — the
    query server or a trainer status sidecar — and render the device's
    memory and the compile-site attribution, ``top``-style. ``--once``
    prints a single snapshot and exits."""
    url = args.url.rstrip("/")
    mb = lambda v: (
        f"{v / 1048576.0:,.1f}" if isinstance(v, (int, float)) else "n/a"
    )

    def snapshot() -> str:
        with urllib.request.urlopen(url + "/device.json", timeout=3.0) as r:
            data = json.loads(r.read().decode("utf-8"))
        budget = data.get("budgetBytes") or 0
        headroom = data.get("headroomBytes")
        lines = [
            f"pio-tpu devices  {url}/device.json",
            f"mode {data.get('mode', '?')}  gen {data.get('generation', 0)}"
            f"  samples {data.get('samples', 0)}"
            + (f"  budget {mb(budget)} MiB" if budget else "")
            + (f"  headroom {mb(headroom)} MiB"
               if headroom is not None else ""),
            "",
            f"{'dev':<5}{'in-use MiB':>12}{'peak MiB':>12}"
            f"{'limit MiB':>12}{'ledger MiB':>12}{'drift MiB':>12}  source",
        ]
        for d in data.get("devices") or []:
            lines.append(
                f"{d.get('device', '?'):<5}{mb(d.get('bytesInUse')):>12}"
                f"{mb(d.get('peakBytes')):>12}{mb(d.get('limitBytes')):>12}"
                f"{mb(d.get('ledgerBytes')):>12}{mb(d.get('driftBytes')):>12}"
                f"  {d.get('source', '-')}"
            )
        compiles = data.get("compiles") or {}
        lines += ["", f"compiles total {compiles.get('total', 0)}"]
        sites = compiles.get("sites") or {}
        if sites:
            lines.append(f"{'site':<18}{'count':>8}{'seconds':>10}")
            for site, row in sorted(sites.items()):
                lines.append(
                    f"{site:<18}{row.get('count', 0):>8}"
                    f"{row.get('seconds', 0.0):>10.3f}"
                )
        ledger = data.get("ledger") or {}
        placements = data.get("placements") or []
        lines += [
            "",
            f"placements {len(placements)}"
            f"  ledger {mb(ledger.get('totalBytes'))} MiB",
        ]
        return "\n".join(lines)

    remaining = 1 if args.once else args.iterations
    clear = not args.once and sys.stdout.isatty()
    try:
        while True:
            try:
                text = snapshot()
            except Exception as e:
                if args.once:
                    return _err(f"{url}/device.json unreachable: {e}")
                text = (f"pio-tpu devices  {url}/device.json\n"
                        f"scrape failed: {e}")
            _out(("\x1b[2J\x1b[H" if clear else "") + text)
            if remaining:
                remaining -= 1
                if remaining == 0:
                    return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_shell(args) -> int:
    """Interactive Python shell with the port preloaded: the store
    facades, the storage registry and ``torch`` (the reference's
    ``bin/pio-shell`` rebuild binds jax and jnp)."""
    import code

    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.data.store import LEventStore, PEventStore

    ns = {
        "pio_tpu_torch": pio_tpu_torch,
        "Storage": Storage,
        "PEventStore": PEventStore,
        "LEventStore": LEventStore,
        "Event": Event,
        "torch": torch,
    }
    banner = (
        f"pio-tpu-torch {pio_tpu_torch.__version__} shell\n"
        "preloaded: Storage, PEventStore, LEventStore, Event, torch\n"
        'e.g.  PEventStore.find("myapp", event_names=["rate"])'
    )
    code.interact(banner=banner, local=ns, exitmsg="")
    return 0


def cmd_upgrade(args) -> int:
    """Migrate configured SQLite storage to this build's schema
    (reference ``pio upgrade``). Opening a database applies pending
    migrations, so this verb touches every configured store and reports
    the stamped schema version. ``--rebuild-search-index`` also drops and
    refills every searchable store's FTS index — required after an
    out-of-band VACUUM (which may renumber the implicit rowids the index
    is keyed on)."""
    import sqlite3

    from pio_tpu_torch.storage.base import StorageError
    from pio_tpu_torch.storage.sqlite import SCHEMA_VERSION, SQLiteClient

    try:
        clients = Storage.sqlite_clients()
    except StorageError as e:  # schema newer than build, or misconfig
        return _err(str(e))
    except sqlite3.Error as e:  # failed migration SQL, locked db, ...
        return _err(f"migration failed: {e}")
    if not clients:
        _out("no SQLite stores configured; nothing to migrate")
        return 0
    seen_paths = set()
    rebuilt_paths = set()
    for label, client in clients.items():
        v = SQLiteClient.schema_version(client.conn())
        note = " (same file as above)" if client.path in seen_paths else ""
        seen_paths.add(client.path)
        _out(
            f"  {label}: {client.path} at schema v{v} "
            f"(current v{SCHEMA_VERSION}){note}"
        )
        rebuild = getattr(client, "rebuild_index", None)
        if (args.rebuild_search_index and callable(rebuild)
                and client.path not in rebuilt_paths):
            try:
                rebuild()
            except sqlite3.Error as e:  # locked or corrupt db: clean error
                return _err(f"index rebuild failed for {label}: {e}")
            rebuilt_paths.add(client.path)
            _out(f"  {label}: FTS index rebuilt")
    _out("storage schema up to date")
    return 0


def cmd_template_list(args) -> int:
    """List the bundled engine factories (the reference's ``pio template
    list``; the templates ship in the package)."""
    import pkgutil

    import pio_tpu_torch.templates as templates
    from pio_tpu_torch.controller.engine import engine_factory_names

    for m in pkgutil.iter_modules(templates.__path__):
        # importing a template module registers its factory
        importlib.import_module(f"{templates.__name__}.{m.name}")
    for name in engine_factory_names():
        _out(name)
    return 0


def cmd_run(args) -> int:
    """Run a user entry point with the port importable and storage
    configured (the reference's ``pio run <main class> -- args``): the
    target is ``module:function``, called with the passthrough argument
    list (or with none where it takes none)."""
    import inspect

    # a console-script install does not put the invocation directory on
    # sys.path as `python -m` does, and a script there is the usual target
    if "" not in sys.path and os.getcwd() not in sys.path:
        sys.path.insert(0, os.getcwd())
    target = _import_attr(args.target, call=False)
    if not callable(target):
        return _err(f"{args.target!r} is not callable")
    argv = list(args.args)
    try:
        params = inspect.signature(target).parameters.values()
        takes_args = any(
            p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                       p.VAR_POSITIONAL)
            for p in params
        )
    except (TypeError, ValueError):  # some C-implemented callables
        takes_args = bool(argv)
    if argv and not takes_args:
        return _err(
            f"{args.target!r} accepts no positional arguments but "
            f"passthrough args were given: {argv}"
        )
    out = target(argv) if takes_args else target()
    return out if isinstance(out, int) else 0


def cmd_version(args) -> int:
    _out(pio_tpu_torch.__version__)
    return 0


def cmd_lint(args) -> int:
    """The port's static analysis (see ``pio_tpu_torch/analysis``): the
    serving stack's concurrency and naming conventions as AST rules, over
    the port and its tests by default. Exit 0 = clean, 1 = findings."""
    from pio_tpu_torch.analysis import all_rules, run_lint
    from pio_tpu_torch.analysis.core import (
        collect_files,
        default_paths,
        parse_module,
        render_json,
        render_text,
    )
    from pio_tpu_torch.analysis.rules_convention import failpoint_inventory

    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid:24s} [{rule.family}] {rule.description}")
        return 0

    paths = args.paths or default_paths()
    if args.dump_failpoints or args.dump_callgraph or args.dump_effects \
            or args.dump_contracts:
        modules = []
        for path in collect_files(paths):
            parsed = parse_module(path)
            if hasattr(parsed, "tree"):   # skip unparsable files
                modules.append(parsed)
        if args.dump_failpoints:
            payload = {"failpoints": failpoint_inventory(modules)}
        elif args.dump_callgraph:
            from pio_tpu_torch.analysis.effects import callgraph_inventory
            payload = {"callgraph": callgraph_inventory(modules)}
        elif args.dump_contracts:
            from pio_tpu_torch.analysis.contracts import contracts_inventory
            from pio_tpu_torch.analysis.core import LintContext
            payload = contracts_inventory(modules, LintContext())
        else:
            from pio_tpu_torch.analysis.effects import (
                effects_inventory,
                frame_inventory,
            )
            payload = effects_inventory(modules)
            payload["frames"] = frame_inventory(modules)
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0

    only = None
    if args.changed:
        only = _changed_py_files(args.base)
        if only is not None and not only:
            print("pio lint: no changed python or knob-table files")
            return 0

    rule_ids = args.rules.split(",") if args.rules else None
    try:
        findings = run_lint(paths, rule_ids=rule_ids, only=only)
    except ValueError as exc:
        print(f"pio lint: {exc}", file=sys.stderr)
        return 2
    print(render_json(findings) if args.json else render_text(findings))
    return 1 if findings else 0


def _changed_py_files(base: str):
    """``git diff --name-only <base>`` filtered to .py plus the port's
    ``.md`` files, as absolute paths — or None (fall back to a full lint)
    when git is unavailable. The knob table ``pio_tpu_torch/KNOBS.md`` is
    a linted contract surface (knob-doc-drift), so a change to it alone
    must still re-lint contracts instead of early-exiting."""
    import subprocess
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", base, "--"],
            capture_output=True, text=True, check=True,
        ).stdout
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as exc:
        print(f"pio lint: --changed unavailable ({exc}); linting all",
              file=sys.stderr)
        return None
    return [
        os.path.join(top, line)
        for line in out.splitlines()
        if line.endswith(".py")
        or (line.endswith(".md") and line.startswith("pio_tpu_torch/"))
    ]


# -------------------------------------------------------------------- parser
def _device_flag(a) -> None:
    a.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the run's tensors live (default cuda; without a card "
             "the run exits with an error)",
    )


def _pool_plane_parsers(sub) -> None:
    """``dashboard``, ``fleet``, ``route``, ``rollout`` and
    ``adminserver``: the reference's flags and defaults."""
    a = sub.add_parser("dashboard", help="run the evaluation dashboard")
    a.add_argument("--ip", default="0.0.0.0")
    a.add_argument("--port", type=int, default=9000)
    a.add_argument(
        "--query-url", default="http://127.0.0.1:8000",
        help="query server (or any pool worker) whose /metrics the "
             "/serving.html view scrapes")
    a.add_argument(
        "--fleet-targets", default=None, metavar="HOST:PORT,...",
        help="enable the embedded /fleet.html panel scraping these "
             "members (default: PIO_TPU_FLEET_TARGETS)")
    a.add_argument(
        "--train-url", default=None, metavar="URL",
        help="trainer status sidecar whose /train.json the "
             "/training.html view follows (default: "
             "PIO_TPU_TRAIN_STATUS_URL)")
    a.set_defaults(fn=cmd_dashboard)

    a = sub.add_parser("fleet", help="run the fleet telemetry aggregator")
    a.add_argument("--ip", default="0.0.0.0")
    a.add_argument("--port", type=int, default=7000)
    a.add_argument(
        "--targets", default=None, metavar="HOST:PORT,...",
        help="comma list of member servers to scrape (falls back to "
             "PIO_TPU_FLEET_TARGETS)")
    a.add_argument(
        "--interval", type=float, default=None, metavar="SECONDS",
        help="scrape interval (default 5s, jittered; also "
             "PIO_TPU_FLEET_INTERVAL_S)")
    a.set_defaults(fn=cmd_fleet)

    a = sub.add_parser(
        "route", help="run the serving router (multi-host front tier)")
    a.add_argument("--ip", default="0.0.0.0")
    a.add_argument("--port", type=int, default=8500)
    a.add_argument(
        "--targets", default=None, metavar="HOST:PORT,...",
        help="comma list of serving members to route across (falls back "
             "to PIO_TPU_FLEET_TARGETS)")
    a.add_argument(
        "--partitions", type=int, default=None, metavar="N",
        help="partition count for entity co-location (affinity engages "
             "when it matches the member count)")
    a.add_argument(
        "--interval", type=float, default=None, metavar="SECONDS",
        help="member scrape interval (default 5s, jittered; also "
             "PIO_TPU_FLEET_INTERVAL_S)")
    a.add_argument(
        "--timeout", type=float, default=5.0, metavar="SECONDS",
        help="upstream forward timeout per attempt (default 5s)")
    a.add_argument(
        "--admin-key", default=None,
        help="bearer key for /deploy (loopback-only without one); also "
             "sent member-ward on deploy pushes")
    a.add_argument(
        "--deploy", default=None, metavar="INSTANCE_ID",
        help="client mode: push a manifest-verified rollout of this "
             "engine instance through the router at --url, then exit")
    a.add_argument(
        "--url", default="http://127.0.0.1:8500", metavar="URL",
        help="router base URL for --deploy (default localhost:8500)")
    a.set_defaults(fn=cmd_route)

    a = sub.add_parser(
        "rollout",
        help="progressive delivery: shadow/canary a candidate instance "
             "through a running router")
    a.add_argument(
        "--url", default="http://127.0.0.1:8500", metavar="URL",
        help="router base URL (default localhost:8500)")
    a.add_argument(
        "--start", default=None, metavar="INSTANCE_ID",
        help="start a rollout of this candidate engine instance")
    a.add_argument(
        "--abort", action="store_true",
        help="abort the live rollout (immediate incumbent rollback)")
    a.add_argument(
        "--targets", default=None, metavar="HOST:PORT,...",
        help="candidate serving members for --start")
    a.add_argument(
        "--incumbent", default=None, metavar="INSTANCE_ID",
        help="pin the incumbent instance (default: discovered from the "
             "ring members' GET /deploy.json)")
    a.add_argument("--shadow-rate", type=float, default=None,
                   metavar="FRACTION",
                   help="fraction of live traffic mirrored (default 0.25)")
    a.add_argument("--shadow-min-samples", type=int, default=None,
                   metavar="N")
    a.add_argument("--shadow-hold", type=float, default=None,
                   metavar="SECONDS")
    a.add_argument("--canary-fraction", type=float, default=None,
                   metavar="FRACTION",
                   help="keyspace fraction served by the candidate "
                        "during canary (default 0.1)")
    a.add_argument("--canary-hold", type=float, default=None,
                   metavar="SECONDS")
    a.add_argument("--canary-min-requests", type=int, default=None,
                   metavar="N")
    a.add_argument("--judge-interval", type=float, default=None,
                   metavar="SECONDS")
    a.add_argument("--judge-fast", type=float, default=None,
                   metavar="SECONDS", help="fast burn window (default 30s)")
    a.add_argument("--judge-slow", type=float, default=None,
                   metavar="SECONDS",
                   help="slow burn window (default 120s)")
    a.add_argument("--burn-limit", type=float, default=None,
                   metavar="RATE")
    a.add_argument("--mismatch-limit", type=float, default=None,
                   metavar="FRACTION")
    a.add_argument("--admin-key", default=None,
                   help="bearer key when the router requires one")
    a.add_argument("--timeout", type=float, default=10.0, metavar="SECONDS")
    a.set_defaults(fn=cmd_rollout)

    a = sub.add_parser("adminserver", help="run the admin REST API")
    a.add_argument("--ip", default="0.0.0.0")
    a.add_argument("--port", type=int, default=7071)
    a.add_argument(
        "--admin-key", default=None,
        help="access key required for mutating routes; without one they "
             "are loopback-only")
    a.set_defaults(fn=cmd_adminserver)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio-tpu-torch",
        description="ML server CLI (PyTorch/CUDA port)",
        epilog="global flags (-v/-q) go BEFORE the verb: "
               "pio-tpu-torch -v train …",
    )
    vq = p.add_mutually_exclusive_group()
    vq.add_argument("-v", "--verbose", action="count", default=0,
                    help="debug logging")
    vq.add_argument("-q", "--quiet", action="store_true", help="warnings only")
    sub = p.add_subparsers(dest="verb", required=True)

    app = sub.add_parser("app", help="manage apps").add_subparsers(
        dest="app_verb", required=True
    )
    a = app.add_parser("new")
    a.add_argument("name")
    a.add_argument("--description", default=None)
    a.set_defaults(fn=cmd_app_new)
    app.add_parser("list").set_defaults(fn=cmd_app_list)
    a = app.add_parser("delete")
    a.add_argument("name")
    a.set_defaults(fn=cmd_app_delete)
    a = app.add_parser("data-delete")
    a.add_argument("name")
    a.add_argument("--channel", default=None)
    a.set_defaults(fn=cmd_app_data_delete)
    a = app.add_parser("compact")
    a.add_argument("name")
    a.add_argument("--channel", default=None)
    a.set_defaults(fn=cmd_app_compact)
    a = app.add_parser("channel-new")
    a.add_argument("app")
    a.add_argument("channel")
    a.set_defaults(fn=cmd_channel_new)
    a = app.add_parser("channel-delete")
    a.add_argument("app")
    a.add_argument("channel")
    a.set_defaults(fn=cmd_channel_delete)

    ak = sub.add_parser("accesskey", help="manage access keys").add_subparsers(
        dest="ak_verb", required=True
    )
    a = ak.add_parser("new")
    a.add_argument("app")
    a.add_argument("--events", default="")
    a.set_defaults(fn=cmd_accesskey_new)
    a = ak.add_parser("list")
    a.add_argument("app", nargs="?")
    a.set_defaults(fn=cmd_accesskey_list)
    a = ak.add_parser("delete")
    a.add_argument("key")
    a.set_defaults(fn=cmd_accesskey_delete)

    a = sub.add_parser("train", help="run a training workflow")
    a.add_argument("--engine-json", default="engine.json")
    a.add_argument("--batch", default="")
    a.add_argument("--skip-sanity-check", action="store_true")
    a.add_argument("--stop-after-read", action="store_true")
    a.add_argument("--stop-after-prepare", action="store_true")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler trace of the train into this dir",
    )
    a.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="snapshot training state every N steps; a preempted run "
             "restarted with the same engine.json resumes automatically",
    )
    a.add_argument(
        "--checkpoint-dir", default="",
        help="explicit snapshot dir (default: per-engine-config under "
             "$PIO_TPU_HOME)",
    )
    a.add_argument(
        "--status-port", type=int, default=None, metavar="PORT",
        help="loopback port for the live /train.json progress sidecar "
             "(default: PIO_TPU_TRAIN_STATUS_PORT or 0 = ephemeral, "
             "printed at start; negative disables)",
    )
    _faults_flag(a, "stream.put=latency:20ms")
    _device_flag(a)
    a.set_defaults(fn=cmd_train)

    a = sub.add_parser(
        "runs", help="list / diff the training run registry"
    )
    a.add_argument("--engine-json", default="engine.json")
    a.add_argument(
        "--engine-id", default=None,
        help="ledger to read (default: the engine id of --engine-json)",
    )
    a.add_argument(
        "-n", type=int, default=0, metavar="N",
        help="show only the last N runs (0 = all)",
    )
    a.add_argument(
        "--diff", action="store_true",
        help="delta table for the last two COMPLETED runs; exits 1 when "
             "a field regresses past --threshold",
    )
    a.add_argument(
        "--threshold", type=float, default=None,
        help="fractional regression threshold for --diff (default 0.05)",
    )
    a.add_argument("--json", action="store_true",
                   help="raw ledger rows as JSON")
    a.set_defaults(fn=cmd_runs)

    a = sub.add_parser("eval", help="run an evaluation sweep")
    a.add_argument("evaluation", help="module:attr returning an Evaluation")
    a.add_argument(
        "engine_params_generator", nargs="?", default=None,
        help="module:attr returning an EngineParamsGenerator",
    )
    _device_flag(a)
    a.set_defaults(fn=cmd_eval)

    a = sub.add_parser("deploy", help="serve the trained engine over HTTP")
    a.add_argument("--engine-json", default="engine.json")
    a.add_argument("--ip", default="0.0.0.0")
    a.add_argument("--port", type=int, default=8000)
    a.add_argument("--engine-instance-id", default=None)
    a.add_argument(
        "--feedback-app", default=None,
        help="app name to log prediction feedback events into",
    )
    a.add_argument(
        "--admin-key", default=None,
        help="access key required by /reload and /undeploy; without one "
             "they are loopback-only",
    )
    a.add_argument(
        "--workers", type=int, default=1,
        help="serving processes sharing the port via SO_REUSEPORT; "
             "without --device-worker every worker serves on the CPU",
    )
    a.add_argument(
        "--device-worker", action="store_true",
        help="with --workers > 1: worker 0 serves on --device and the "
             "others send it their queries over the shared-memory batch "
             "lane; only worker 0 holds the card",
    )
    a.add_argument(
        "--mesh-worker", action="store_true",
        help="with --workers > 1: worker 0 owns every local CUDA device "
             "and serves the recommendation tables sharded over them "
             "(PIO_TPU_MESH_SERVE); the others serve on the CPU",
    )
    a.add_argument(
        "--mesh-devices", default=None,
        help="with --mesh-worker: the comma-separated devices worker 0 "
             "shards over (default: every local CUDA device); a device may "
             "repeat, e.g. cuda:0,cuda:0 on a one-card host",
    )
    _request_plane_flags(a)
    _faults_flag(a, "storage.sqlite.commit=latency:200ms,"
                    "worker.serve=crash:once")
    _device_flag(a)
    a.set_defaults(fn=cmd_deploy)

    a = sub.add_parser("undeploy", help="stop a running query server")
    a.add_argument("--ip", default="127.0.0.1")
    a.add_argument("--port", type=int, default=8000)
    a.add_argument(
        "--admin-key", default=None,
        help="admin access key if the server was deployed with one",
    )
    a.set_defaults(fn=cmd_undeploy)

    a = sub.add_parser("batchpredict", help="bulk offline scoring")
    a.add_argument("--engine-json", default="engine.json")
    a.add_argument("--input", required=True)
    a.add_argument("--output", required=True)
    a.add_argument("--engine-instance-id", default=None)
    _device_flag(a)
    a.set_defaults(fn=cmd_batchpredict)

    a = sub.add_parser("eventserver", help="run the event ingestion server")
    a.add_argument("--ip", default="0.0.0.0")
    a.add_argument("--port", type=int, default=7070)
    _request_plane_flags(a)
    _faults_flag(a, "storage.sqlite.commit=error:0.1")
    a.set_defaults(fn=cmd_eventserver)

    a = sub.add_parser(
        "blobserver", help="run the blob daemon (remote Models endpoint)"
    )
    a.add_argument("--root", required=True,
                   help="directory the daemon serves blobs from")
    a.add_argument("--ip", default="0.0.0.0")
    a.add_argument("--port", type=int, default=7088)
    a.add_argument("--access-key", default=None,
                   help="require this bearer key on every request")
    a.set_defaults(fn=cmd_blobserver)

    _pool_plane_parsers(sub)

    a = sub.add_parser("import", help="import JSON-lines events")
    a.add_argument("--app", required=True)
    a.add_argument("--input", required=True)
    a.add_argument("--channel", default=None)
    a.set_defaults(fn=cmd_import)

    a = sub.add_parser("export", help="export events as JSON-lines")
    a.add_argument("--app", required=True)
    a.add_argument("--output", required=True)
    a.add_argument("--channel", default=None)
    a.set_defaults(fn=cmd_export)

    a = sub.add_parser("status", help="storage/device health check")
    _device_flag(a)
    a.set_defaults(fn=cmd_status)
    a = sub.add_parser(
        "top", help="live device memory + compile table from /device.json"
    )
    a.add_argument(
        "--url", default="http://127.0.0.1:8000", metavar="URL",
        help="query server or trainer status sidecar base URL",
    )
    a.add_argument(
        "--interval", type=float, default=2.0, metavar="S",
        help="poll interval in seconds (default 2.0)",
    )
    a.add_argument(
        "--once", action="store_true",
        help="print one snapshot and exit (no screen clearing)",
    )
    a.add_argument(
        "-n", "--iterations", type=int, default=0, metavar="N",
        help="stop after N refreshes (0 = run until interrupted)",
    )
    a.set_defaults(fn=cmd_top)
    sub.add_parser("version").set_defaults(fn=cmd_version)
    a = sub.add_parser(
        "upgrade", help="migrate storage to this build's schema"
    )
    a.add_argument(
        "--rebuild-search-index", action="store_true",
        help="drop + refill searchable stores' FTS indexes "
             "(run after an out-of-band VACUUM)",
    )
    a.set_defaults(fn=cmd_upgrade)
    sub.add_parser(
        "shell", help="interactive Python shell with stores preloaded"
    ).set_defaults(fn=cmd_shell)
    t = sub.add_parser("template", help="bundled engine templates"
                       ).add_subparsers(dest="template_verb", required=True)
    t.add_parser("list").set_defaults(fn=cmd_template_list)
    a = sub.add_parser(
        "run", help="run a module:function entry point with the framework"
    )
    a.add_argument("target", help="entry point as module:function")
    a.add_argument(
        "args", nargs=argparse.REMAINDER,
        help="passthrough arguments (everything after the target, "
             "flag-like tokens included)",
    )
    a.set_defaults(fn=cmd_run)

    a = sub.add_parser(
        "lint",
        help="project-native static analysis (concurrency + conventions)",
    )
    a.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: pio_tpu_torch and the "
             "port's tests, tests/test_torch_*.py and tests/torch_*.py)",
    )
    a.add_argument("--json", action="store_true", help="JSON findings")
    a.add_argument(
        "--rules", default=None, metavar="ID[,ID…]",
        help="run only these rule ids",
    )
    a.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    a.add_argument(
        "--dump-failpoints", action="store_true",
        help="machine-readable inventory of failpoint() call sites "
             "(cross-check chaos specs against real points)",
    )
    a.add_argument(
        "--dump-callgraph", action="store_true",
        help="resolved call edges (caller -> callees) as JSON",
    )
    a.add_argument(
        "--dump-effects", action="store_true",
        help="hot-path roots, per-function effect summaries and "
             "frame-family census as JSON",
    )
    a.add_argument(
        "--dump-contracts", action="store_true",
        help="extracted cross-surface inventory as JSON: endpoint "
             "payload keys with producers/consumers, X-Pio-* header "
             "flows, and PIO_TPU_* knob sites joined against the "
             "port's knob registry",
    )
    a.add_argument(
        "--changed", action="store_true",
        help="report findings only for files in `git diff --name-only "
             "<base>` (whole tree still loads for call-graph context)",
    )
    a.add_argument(
        "--base", default="HEAD", metavar="REV",
        help="diff base for --changed (default: HEAD)",
    )
    a.set_defaults(fn=cmd_lint)
    return p


def _configure_logging(verbosity: int) -> None:
    """Console logging for CLI runs: pio_tpu_torch at INFO by default;
    -q → WARNING, -v → DEBUG."""
    level = (
        logging.WARNING if verbosity < 0
        else logging.DEBUG if verbosity > 0
        else logging.INFO
    )
    logging.basicConfig(format="[%(levelname)s] [%(name)s] %(message)s")
    logging.getLogger("pio_tpu_torch").setLevel(level)


#: the variables a verb exports for the processes it spawns (``--slo``,
#: ``--qos``, ``--faults``); :func:`main` gives them back when it returns
EXPORTED_ENV = ("PIO_TPU_SLO", "PIO_TPU_QOS", faults.ENV_VAR)


@contextlib.contextmanager
def verb_scope():
    """What a verb sets up for itself and its workers lasts until the
    block ends: the exports (``EXPORTED_ENV``) are given back, and a
    fault registry the verb armed (``--faults``) is disarmed, or re-armed
    with the spec it had before."""
    saved = {k: os.environ.get(k) for k in EXPORTED_ENV}
    armed = faults.snapshot()["spec"]
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if faults.snapshot()["spec"] != armed:
            if armed:
                faults.install(armed)
            else:
                faults.uninstall()


def main(argv=None) -> int:
    """Run one verb in :func:`verb_scope`: its exports and its fault
    registry last while it runs, for the workers it spawns, and are
    undone when it returns. A verb run in a longer-lived process (a test,
    a script driving ``main``) leaves no ``--qos`` or ``--faults`` behind
    for what that process does later."""
    args = build_parser().parse_args(argv)
    _configure_logging(-1 if args.quiet else args.verbose)
    with verb_scope():
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
