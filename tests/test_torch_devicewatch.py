"""The port's device telemetry plane against the JAX package's, on the CPU.

- ``DeviceWatch`` in both packages, the same operations: the ledger
  (place, release, resize, peak retention, generation stamps), the live
  rows from a stats function (drift, headroom against a budget), the
  compile attribution (span dedup by site and key, seconds, the
  families' text) and the module hooks give equal results, and equal
  ``/device.json`` payloads with the clocks masked; ``shape_key`` gives
  the reference's keys for nested containers.
- The ledger fallback of a served template: the classification template
  deployed resident (buckets 1, 2, 4, warmup on, sampler off) books the
  same bytes by category and counts the same compiles by site in both
  packages after deploy and 4 queries; ``/device.json`` has the
  reference's keys; ``/metrics`` parses with ``pio_tpu.obs.promparse``
  into a subset of the reference's family names that holds every device
  family; and no CUDA context was made (``torch.cuda.is_initialized()``
  stays false), also for a watch whose device is CUDA.
- The profile hook's window on the same deploy (``PIO_TPU_PROFILE``, 5
  executions): the ladder's 3 warmup sweeps are its first executions in
  both packages, and 2 queries close it, the port's through the
  micro-batcher; the hook's states are the reference's.
- The trainer's status sidecar answers ``/train.json``, ``/device.json``,
  ``/metrics``, ``/healthz`` and ``/readyz`` with the reference's
  status codes and keys, without and with an active run.
- On the card (``cuda``): the watch reads the allocator's counters.
"""

import datetime as dt
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.controller import ComputeContext as JaxContext
from pio_tpu.data import Event as JaxEvent
from pio_tpu.obs import devicewatch as rdw
from pio_tpu.obs import trainwatch as rtw
from pio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from pio_tpu.obs.promparse import parse_prometheus_text
from pio_tpu.server.fleetd import (
    create_train_status_server as jax_train_status_server,
)
from pio_tpu.server.query_server import QueryServerService
from pio_tpu.storage import App as JaxApp
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.templates.classification import Query as JaxQuery
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
# the storage layer's families live on the process-global registry from
# import on, in both packages; the port's storage is imported by this
# process, so the reference's is too, for the sidecars' /metrics to
# compare like with like
import pio_tpu.storage.groupcommit  # noqa: E402,F401
import pio_tpu.storage.retry  # noqa: E402,F401
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.obs import devicewatch as pdw
from pio_tpu_torch.obs import trainwatch as ptw
from pio_tpu_torch.obs.metrics import MetricsRegistry
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.http import Request
from pio_tpu_torch.server.query_server import deploy_query_server
from pio_tpu_torch.server.train_status import create_train_status_server
from pio_tpu_torch.storage.records import App
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.classification import Query
from pio_tpu_torch.workflow.core_workflow import run_train
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict

PACKAGES = [pytest.param((rdw, JaxRegistry), id="reference"),
            pytest.param((pdw, MetricsRegistry), id="port")]
CLOCK_KEYS = ("asOf", "uptimeS")
DEVICE_FAMILIES = {
    "pio_tpu_device_bytes_in_use", "pio_tpu_device_peak_bytes",
    "pio_tpu_device_limit_bytes", "pio_tpu_device_budget_headroom_bytes",
    "pio_tpu_device_estimate_drift_bytes", "pio_tpu_xla_compile_total",
    "pio_tpu_xla_compile_seconds",
}


def _watch(pkg, **kw):
    dw, reg = pkg
    return dw.DeviceWatch(registry=reg(), **kw)


def _live(in_use, peak=None, limit=2 ** 20, label="gpu:0"):
    return [(label, {"bytes_in_use": in_use,
                     "peak_bytes_in_use": peak if peak is not None
                     else in_use,
                     "bytes_limit": limit}, 0)]


def _masked(payload: dict) -> dict:
    """The payload without its clocks, device 0's row only: the
    reference's CPU backend lists the host platform's devices (the test
    session forces 8), the port's watch its one device."""
    out = {k: v for k, v in payload.items() if k not in CLOCK_KEYS}
    out["devices"] = out["devices"][:1]
    out["compiles"] = {**out["compiles"], "sites": {
        site: {k: v for k, v in row.items() if k not in ("seconds", "lastS")}
        for site, row in out["compiles"]["sites"].items()}}
    return out


def _device0(lines: list) -> list:
    """Exposition lines without the other devices' series and without
    the timed spans' seconds (their counts stay)."""
    return [line for line in lines
            if ('device="' not in line or 'device="cpu:0"' in line
                or 'device="gpu:' in line)
            and not line.startswith(("pio_tpu_xla_compile_seconds_bucket",
                                     "pio_tpu_xla_compile_seconds_sum"))]


def _ledger_ops(w):
    w.ledger_place("resident", "m1", 1000, name="model one")
    w.ledger_place("donated", "m1", 200)
    first = w.sample()
    w.set_generation(3)
    w.ledger_place("resident", "m2", 30)
    w.ledger_place("donated", "m1", 500)  # re-place = resize
    w.ledger_release("resident", "m1")
    w.set_generation(4)
    second = w.sample()
    return first, second, w.ledger_bytes(), w.measured_bytes()


def _compile_ops(w):
    fresh = []
    for site, key in (("resident_scorer", ("b", 4)),
                      ("resident_scorer", ("b", 4)),
                      ("resident_scorer", ("b", 8)),
                      ("train_step", ("b", 4)),
                      ("bucket_warmup", None), ("bucket_warmup", None)):
        with w.span(site, key=key) as f:
            fresh.append(f)
    w.record_compile("train_step", 0.25, trace_id="t-1")
    w.record_compile("bucket_dispatch")
    return fresh, w.compile_counts()


SCENARIOS = {
    "ledger": (lambda: {}, _ledger_ops),
    "live": (lambda: {"stats_fn": lambda: _live(5000, peak=8000),
                      "budget_bytes": 6000}, _ledger_ops),
    "two_devices": (lambda: {"stats_fn": lambda: _live(600) + [
        ("gpu:1", {"bytes_in_use": 900, "peak_bytes_in_use": 900,
                   "bytes_limit": None}, 1)], "budget_bytes": 1000},
                    _ledger_ops),
    "compiles": (lambda: {}, _compile_ops),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=list(SCENARIOS))
def test_watch_matches_reference(scenario):
    """The same operations on both packages' watches: equal returns,
    payloads (clocks masked) and rendered families."""
    kw, ops = SCENARIOS[scenario]
    got = []
    for pkg in (PACKAGES[0].values[0], PACKAGES[1].values[0]):
        w = _watch(pkg, interval_s=2.0, **kw())
        out = ops(w)
        if ops is _ledger_ops:
            out = (out[0][:1], out[1][:1]) + out[2:]
        got.append((out, _masked(w.payload()), _device0(w.registry.render())))
    assert got[0] == got[1]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_module_hooks_route_to_the_active_watch(pkg):
    dw, _ = pkg
    w = _watch(pkg)
    dw.deactivate()
    dw.record_compile("train_step")
    with dw.compile_span("train_step", key=1) as fresh:
        assert not fresh
    with dw.watching(w, sample=False):
        assert dw.active_watch() is w
        dw.record_compile("train_step")
        with dw.compile_span("train_step", key=(1,)) as fresh:
            assert fresh
        dw.ledger_place("resident", "k", 64)
        dw.set_generation(2)
    assert w.compile_counts() == {"train_step": 2}
    assert w.ledger_bytes() == 64 and dw.active_watch() is None
    assert dw.last_watch() is w
    dw.ledger_place("resident", "k2", 64)  # nothing active: no booking
    assert w.ledger_bytes() == 64


@pytest.mark.parametrize("tree", [
    [np.zeros((2, 3)), np.zeros(4)],
    {"b": np.zeros(4), "a": (np.zeros((1,)), None), "c": [np.zeros((2, 2))]},
    (np.zeros(()), 5, None),
    np.zeros((3, 1)),
], ids=["list", "nested", "scalars", "leaf"])
def test_shape_key_matches_reference(tree):
    assert pdw.shape_key(tree) == rdw.shape_key(tree)
    as_torch = pdw.shape_key(
        [torch.zeros(2, 3), {"x": torch.zeros(4)}])
    assert as_torch == ((2, 3), (4,))


def test_a_scope_gives_the_displaced_watch_back():
    """A run's watch inside a serving process: the server's watch is
    active again after the run (the reference leaves none active)."""
    server_watch = pdw.DeviceWatch(registry=MetricsRegistry())
    pdw.activate(server_watch)
    try:
        with pdw.watching(pdw.DeviceWatch(registry=MetricsRegistry()),
                          sample=False) as run_watch:
            pdw.ledger_place("resident", "during", 8)
        pdw.ledger_place("resident", "after", 16)
        assert run_watch.ledger_bytes() == 8
        assert server_watch.ledger_bytes() == 16
        assert pdw.active_watch() is server_watch
        assert pdw.last_watch() is server_watch
    finally:
        pdw.deactivate(server_watch)


def test_a_cuda_watch_never_makes_a_context():
    """A watch whose device is CUDA reads nothing until the process
    uses the card: here it keeps the ledger and leaves CUDA alone."""
    w = pdw.DeviceWatch(registry=MetricsRegistry(),
                        device=torch.device("cuda"))
    w.ledger_place("resident", "m", 10)
    w.start()
    try:
        (row,) = w.payload()["devices"]
    finally:
        w.stop()
    assert row["source"] == "ledger" and row["device"] == "cuda:0"
    assert row["bytesInUse"] == 10 and w.measured_bytes() is None
    assert not torch.cuda.is_initialized()


# ------------------------------------------------- a served template
T0 = dt.datetime(2026, 5, 1, tzinfo=dt.timezone.utc)
VARIANT = {
    "id": "cls-devwatch",
    "engineFactory": "templates.classification",
    "datasource": {"params": {"app_name": "devwatch-test"}},
    "algorithms": [{"name": "logreg", "params": {}}],
}
N_QUERIES = 4


@pytest.fixture()
def resident(tmp_home, monkeypatch):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_BATCH_BUCKETS", "1,2,4")
    monkeypatch.setenv("PIO_TPU_BUCKET_WARMUP", "1")
    monkeypatch.setenv("PIO_TPU_DEVICEWATCH", "0")  # sample on demand
    Storage.reset()
    JaxStorage.reset()
    yield
    Storage.reset()
    JaxStorage.reset()


def _seed(storage, app_cls, event_cls):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "devwatch-test"))
    le = storage.get_levents()
    rng = np.random.default_rng(7)
    n = 0
    for plan, hot in (("basic", 0), ("premium", 1), ("pro", 2)):
        for _ in range(8):
            attrs = rng.integers(0, 3, size=3)
            attrs[hot] += 6
            props = {f"attr{j}": int(attrs[j]) for j in range(3)}
            props["plan"] = plan
            le.insert(event_cls("$set", "user", f"u{n}", properties=props,
                                event_time=T0 + dt.timedelta(minutes=n)),
                      app_id)
            n += 1


def _family_names(text: str) -> set:
    return set(parse_prometheus_text(text).types)


def test_served_template_books_like_the_reference(resident):
    _seed(JaxStorage, JaxApp, JaxEvent)
    v = jax_variant_from_dict(VARIANT)
    engine, ep = jax_build_engine(v)
    ctx = JaxContext.local()
    jax_run_train(engine, ep, v, ctx=ctx)
    ref = QueryServerService(v, ctx=ctx)
    try:
        for _ in range(N_QUERIES):
            ref._predict_one(JaxQuery(attrs=(9.0, 1.0, 1.0)))
        want = ref.get_device(None)[1]
        want_metrics = ref.get_metrics(None)[1].body
    finally:
        ref.devwatch.stop()
        rdw.deactivate(ref.devwatch)

    _seed(Storage, App, Event)
    v = variant_from_dict(VARIANT)
    engine, ep = build_engine(v)
    run_train(engine, ep, v,
              ctx=ComputeContext.create(seed=0, device="cpu"))
    server = deploy_query_server(v, host="127.0.0.1", port=0, device="cpu")
    svc = server.service
    try:
        assert svc._gen.resident  # residency placed, or the test is vacuous
        for _ in range(N_QUERIES):
            svc._predict_one(Query(attrs=(9.0, 1.0, 1.0)))
        router = svc.router()
        status, got = router.dispatch(Request("GET", "/device.json", {}, None))
        assert status == 200
        status, metrics = router.dispatch(Request("GET", "/metrics", {}, None))
        assert status == 200 and metrics.content_type.startswith("text/plain")
        stats = svc.stats()
    finally:
        server.close()
    assert pdw.active_watch() is None

    assert got["mode"] == want["mode"] == "ledger"
    assert got["ledger"] == want["ledger"]
    assert got["ledger"]["byCategory"]["resident"] > 0
    assert got["ledger"]["byCategory"]["donated"] > 0
    assert {s: r["count"] for s, r in got["compiles"]["sites"].items()} == \
        {s: r["count"] for s, r in want["compiles"]["sites"].items()}
    assert got["compiles"]["sites"]["bucket_warmup"]["count"] == 3
    assert "bucket_dispatch" not in got["compiles"]["sites"]
    assert got["generation"] == want["generation"] == 1
    assert set(got) == set(want)
    assert set(got["devices"][0]) == set(want["devices"][0])
    assert got["devices"][0]["bytesInUse"] == want["devices"][0]["bytesInUse"]
    assert [set(p) for p in got["placements"]] == \
        [set(p) for p in want["placements"]]
    assert {(p["category"], p["bytes"]) for p in got["placements"]} == \
        {(p["category"], p["bytes"]) for p in want["placements"]}
    names = _family_names(metrics.body)
    assert DEVICE_FAMILIES <= names <= _family_names(want_metrics)
    assert stats["residency"]["measuredBytes"] is None
    assert not torch.cuda.is_initialized()


def _hook_state(hook, base) -> dict:
    d = dict(hook.to_dict())
    d["directory"] = os.path.relpath(d["directory"], base)
    return d


def test_profile_window_takes_the_warmup_like_the_reference(
        resident, monkeypatch, tmp_path):
    import jax

    calls = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: calls.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: calls.append("stop"))
    monkeypatch.setenv("PIO_TPU_PROFILE_EXECUTIONS", "5")
    body = {"attr0": 9.0, "attr1": 1.0, "attr2": 1.0}

    monkeypatch.setenv("PIO_TPU_PROFILE", str(tmp_path / "r"))
    _seed(JaxStorage, JaxApp, JaxEvent)
    v = jax_variant_from_dict(VARIANT)
    engine, ep = jax_build_engine(v)
    ctx = JaxContext.local()
    jax_run_train(engine, ep, v, ctx=ctx)
    ref = QueryServerService(v, ctx=ctx)
    want = []
    try:
        want.append(_hook_state(ref.profile_hook, tmp_path / "r"))
        for _ in range(2):
            ref._predict_one(JaxQuery(**body))
        want.append(_hook_state(ref.profile_hook, tmp_path / "r"))
    finally:
        ref.devwatch.stop()
        rdw.deactivate(ref.devwatch)

    monkeypatch.setenv("PIO_TPU_PROFILE", str(tmp_path / "p"))
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_US", "2000")
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE", "0")
    _seed(Storage, App, Event)
    v = variant_from_dict(VARIANT)
    engine, ep = build_engine(v)
    run_train(engine, ep, v,
              ctx=ComputeContext.create(seed=0, device="cpu"))
    server = deploy_query_server(v, host="127.0.0.1", port=0, device="cpu")
    svc = server.service
    got = []
    try:
        got.append(_hook_state(svc.profile_hook, tmp_path / "p"))
        for _ in range(2):
            svc.query(json.dumps(body).encode())
        got.append(_hook_state(svc.profile_hook, tmp_path / "p"))
        batched = svc.stats()["microbatch"]["batchedQueries"]
    finally:
        server.close()
    assert got == want
    assert (want[0]["seen"], want[0]["active"]) == (3, True)
    assert (want[1]["seen"], want[1]["armed"]) == (5, False)
    assert calls == ["start", "stop"] and batched == 2
    with open(tmp_path / "p" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


# ------------------------------------------------ the trainer's sidecar
def _http(url):
    try:
        with urllib.request.urlopen(url, timeout=15) as resp:
            body = resp.read().decode()
            return resp.status, body
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


ROUTES = ("/train.json", "/device.json", "/healthz", "/readyz")


def _sidecar_answers(make_server, tw, dw, reg):
    """Each route's (status, JSON keys) without a run, then inside one;
    and the family names of /metrics inside the run."""
    tw.deactivate()
    dw.deactivate()
    server = make_server().start()
    base = f"http://127.0.0.1:{server.port}"
    out = []
    try:
        for route in ROUTES:
            status, body = _http(base + route)
            out.append((route, status, sorted(json.loads(body))))
        rec = tw.StepRecorder("run-1", "eng")
        watch = dw.DeviceWatch(registry=reg(), interval_s=2.0)
        with tw.recording(rec), dw.watching(watch, sample=False):
            tw.begin_algo("als", total_steps=2)
            tw.record_steps(2, examples=8)
            for route in ROUTES:
                status, body = _http(base + route)
                got = json.loads(body)
                out.append((route, status, sorted(got)))
                if route == "/train.json":
                    out.append(("step", got["step"], got["runId"]))
            status, metrics = _http(base + "/metrics")
    finally:
        server.stop()
    return out, status, _family_names(metrics)


def test_train_sidecar_answers_like_the_reference():
    want, want_status, want_names = _sidecar_answers(
        jax_train_status_server, rtw, rdw, JaxRegistry)
    got, status, names = _sidecar_answers(
        create_train_status_server, ptw, pdw, MetricsRegistry)
    assert got == want
    assert [s for r, s, _ in got[:4]] == [503, 503, 200, 503]
    assert status == want_status == 200
    assert "pio_tpu_train_steps_total" in names
    assert names - {"pio_tpu_train_stage_seconds"} <= want_names


# ---------------------------------------------------------------- the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_watch_reads_the_allocator_on_the_card(cuda_device):
    x = torch.empty(1 << 20, device=cuda_device)
    w = pdw.DeviceWatch(registry=MetricsRegistry(), device=cuda_device)
    (row,) = w.payload()["devices"]
    assert row["source"] == "memory_stats" and row["device"] == "cuda:0"
    assert row["bytesInUse"] == torch.cuda.memory_allocated(cuda_device)
    assert row["limitBytes"] == \
        torch.cuda.get_device_properties(cuda_device).total_memory
    assert w.measured_bytes() == row["bytesInUse"] >= x.nbytes
