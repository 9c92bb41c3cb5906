"""The port's pool plane against the JAX package's, on the CPU.

- The shared metrics segment (``obs/shm.py``): a segment written by one
  package is read by the other, and the same operations give the same
  bytes.
- The stripe mirror (``obs/metrics.py``): 2-4 registries bound to the
  stripes of one segment, the same seeded operations, the same pool-wide
  exposition text from every worker; a respawned worker adopts its
  stripe.
- The striped token bucket (``qos/limiter.py``) on a fake clock: the same
  admit/shed sequence, and one budget for the pool.
- ``obs/promparse.py`` on the reference's own exposition texts, and the
  fleet aggregator (``obs/fleet.py``) over stub fetchers: the same
  payload and federated sums.
- The routes of ``fleet``, ``dashboard`` and ``adminserver`` from both
  packages over HTTP: statuses, content types and normalized bodies.
- One spawned 2-worker pool of the port under ``rps=``: every worker's
  ``/metrics`` gives the pool's totals, the pool admits one budget, and a
  killed worker's respawn adopts its stripe (generation 2, totals kept).
"""

import http.client
import json
import threading
import urllib.error

import numpy as np
import pytest

from pio_tpu.obs import metrics as r_metrics
from pio_tpu.obs import promparse as r_promparse
from pio_tpu.obs import shm as r_shm
from pio_tpu.obs.fleet import FleetAggregator as RFleet
from pio_tpu.qos import limiter as r_limiter
from pio_tpu.server import admin as r_admin
from pio_tpu.server import dashboard as r_dashboard
from pio_tpu.server import fleetd as r_fleetd
from pio_tpu.server.http import JsonHTTPServer as RServer
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu_torch.obs import metrics as p_metrics
from pio_tpu_torch.obs import promparse as p_promparse
from pio_tpu_torch.obs import shm as p_shm
from pio_tpu_torch.obs.fleet import FleetAggregator as PFleet
from pio_tpu_torch.obs.fleet import parse_targets
from pio_tpu_torch.qos import limiter as p_limiter
from pio_tpu_torch.server import admin as p_admin
from pio_tpu_torch.server import dashboard as p_dashboard
from pio_tpu_torch.server import fleetd as p_fleetd
from pio_tpu_torch.server.http import JsonHTTPServer as PServer
from pio_tpu_torch.server.worker_pool import ServingPool
from pio_tpu_torch.storage.registry import Storage
from test_torch_classification import APP, QUERIES, user_rows
from test_torch_microbatch import HTTP_S, JOIN_S, cls_variant, train_cls, until
from test_torch_similarproduct import seed_events

#: (metrics, shm, promparse, limiter) of each package
PACKAGES = {
    "port": (p_metrics, p_shm, p_promparse, p_limiter),
    "reference": (r_metrics, r_shm, r_promparse, r_limiter),
}
#: the pool's startup and a worker's respawn, seconds
READY_S = 120


def request(port, method, path, body=b""):
    """One request on a fresh connection: ``(status, content type,
    body)``, the body parsed where it is JSON."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
    try:
        conn.request(method, path, body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read().decode()
        ctype = r.getheader("Content-Type", "")
        return r.status, ctype, (json.loads(raw) if "json" in ctype
                                 else raw)
    finally:
        conn.close()


# ----------------------------------------------------------------- segment
def _write_segment(shm, path):
    """The same operations on a fresh 3-stripe segment of 16 slots."""
    seg = shm.PoolMetricsSegment.create(str(path), 3, 16)
    for w in range(3):
        seg.bump_generation(w)
    seg.bump_generation(1)
    seg.retire_stripe(2)
    for w in range(3):
        for slot in range(16):
            seg.set(w, slot, (w + 1) * 1000.5 + slot * 0.25)
    return seg


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_segment_bytes_both_ways(tmp_path, writer, reader):
    seg = _write_segment(PACKAGES[writer][1], tmp_path / "w.shm")
    other = PACKAGES[reader][1].PoolMetricsSegment.open(str(tmp_path / "w.shm"))
    try:
        assert (other.n_workers, other.slots_per_worker) == (3, 16)
        assert other.generations() == seg.generations() == [1, 2, -1]
        for slot in range(16):
            assert other.read_all(slot) == seg.read_all(slot)
            assert other.sum_slot(slot) == seg.sum_slot(slot)
        other.set(0, 3, -7.5)
        assert seg.read(0, 3) == -7.5
    finally:
        other.close()
        seg.close()
    _write_segment(PACKAGES[reader][1], tmp_path / "r.shm").close()
    raw_w = (tmp_path / "w.shm").read_bytes()
    raw_r = (tmp_path / "r.shm").read_bytes()
    assert len(raw_w) == len(raw_r)
    # the reader wrote slot 3 of stripe 0: every other byte is the same
    off = 32 + 3 * 8 + 3 * 8
    assert raw_w[:off] == raw_r[:off] and raw_w[off + 8:] == raw_r[off + 8:]


# ------------------------------------------------------------ stripe mirror
def _worker_registry(metrics):
    reg = metrics.MetricsRegistry()
    reg.counter("pio_tpu_t_total", "requests", ("engine_id",)).labels("e")
    h = reg.histogram("pio_tpu_t_seconds", "stage seconds", ("stage",),
                      buckets=(0.001, 0.01, 0.1))
    h.labels("a")
    h.labels("b")
    reg.gauge("pio_tpu_t_up", "a worker's own gauge")
    return reg


def _pool_ops(regs, seed):
    """Seeded operations over the workers' registries; the counter's
    increments, summed."""
    rng = np.random.default_rng(seed)
    total = 0
    for _ in range(300):
        w = int(rng.integers(len(regs)))
        op = int(rng.integers(4))
        reg = regs[w]
        if op == 0:
            n = int(rng.integers(1, 5))
            reg.counter("pio_tpu_t_total", "requests",
                        ("engine_id",)).inc(n, engine_id="e")
            total += n
        elif op == 1:
            reg.histogram("pio_tpu_t_seconds", "stage seconds",
                          ("stage",)).observe(
                float(rng.exponential(0.01)),
                stage="ab"[int(rng.integers(2))])
        elif op == 2:
            reg.gauge("pio_tpu_t_up", "a worker's own gauge").set(
                float(rng.integers(100)))
        else:  # created after the bind: stays local
            reg.counter("pio_tpu_t_late_total", "late",
                        ("k",)).inc(1, k=str(w))
    return total


@pytest.mark.parametrize("n_workers", [2, 3, 4])
def test_pool_exposition_matches_reference(tmp_path, n_workers):
    texts, locals_, adopted = {}, {}, {}
    for name, (metrics, shm, _, _) in PACKAGES.items():
        seg = shm.PoolMetricsSegment.create(str(tmp_path / f"{name}.shm"),
                                            n_workers, 64)
        regs = [_worker_registry(metrics) for _ in range(n_workers)]
        for w, reg in enumerate(regs):
            reg.bind_pool_segment(seg, w)
        assert all(reg.pool_bound for reg in regs)
        total = _pool_ops(regs, seed=n_workers)
        texts[name] = ["\n".join(reg.render()) for reg in regs]
        locals_[name] = ["\n".join(reg.render(pool=False)) for reg in regs]
        c = regs[-1].counter("pio_tpu_t_total", "requests", ("engine_id",))
        assert c.value("e") == total
        # a respawn of worker 0: a fresh registry adopts its stripe
        fresh = _worker_registry(metrics)
        fresh.bind_pool_segment(seg, 0)
        adopted[name] = "\n".join(fresh.render())
        seg.close()
    assert texts["port"] == texts["reference"]
    assert locals_["port"] == locals_["reference"]
    assert adopted["port"] == adopted["reference"]
    # every worker renders the same pool-wide counter and histograms
    pooled = [t.split("# HELP pio_tpu_t_up")[0] for t in texts["port"]]
    assert len(set(pooled)) == 1
    assert adopted["port"].split("# HELP pio_tpu_t_up")[0] == pooled[0]


def test_segment_too_small_raises_like_reference(tmp_path):
    for name, (metrics, shm, _, _) in PACKAGES.items():
        seg = shm.PoolMetricsSegment.create(str(tmp_path / f"{name}.shm"),
                                            2, 4)
        with pytest.raises(ValueError, match="too small"):
            _worker_registry(metrics).bind_pool_segment(seg, 0)
        seg.close()


# ---------------------------------------------------------- striped bucket
class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _bucket_run(metrics, shm, limiter, path, bound, seed=3):
    """Three workers' buckets (rate 5/s, burst 4) on one fake clock, bound
    to the stripes of a segment or not; a seeded sequence of acquisitions
    with and without a priority floor. Returns the decisions, the clock's
    end and the admissions."""
    clock = Clock()
    seg = shm.PoolMetricsSegment.create(str(path), 3, 4) if bound else None
    buckets = []
    for w in range(3):
        reg = metrics.MetricsRegistry()
        cell = reg.counter("pio_tpu_qos_admitted_total", "admitted",
                           ("scope",)).labels("queryserver")
        if seg is not None:
            reg.bind_pool_segment(seg, w)
        b = limiter.TokenBucket(5.0, 4.0, cell=cell, clock=clock)
        b.rebase()
        buckets.append(b)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(400):
        clock.t += float(rng.exponential(0.05))
        w = int(rng.integers(3))
        floor = (0.0, 0.5)[int(rng.integers(2))]
        ok, retry = buckets[w].try_acquire(floor=floor)
        out.append((w, ok, round(retry, 12)))
    if seg is not None:
        seg.close()
    return out, clock.t, sum(ok for _, ok, _ in out)


def test_striped_bucket_sequence_matches_reference(tmp_path):
    runs = {name: _bucket_run(*mods[:2], mods[3], tmp_path / f"{name}.shm",
                              bound=True)
            for name, mods in PACKAGES.items()}
    assert runs["port"][0] == runs["reference"][0]
    seq, t_end, admitted = runs["port"]
    # one budget: at most the burst plus the rate over the run
    assert admitted <= 4 + 5.0 * t_end + 1e-9
    # three unbound buckets admit well beyond it
    _, _, alone = _bucket_run(p_metrics, p_shm, p_limiter, None, bound=False)
    assert alone > 4 + 5.0 * t_end


# ------------------------------------------------------- promparse, fleet
def _reference_texts():
    """Exposition texts of the reference's own registries: labels that
    need escaping, exemplars, a summary of histogram buckets."""
    reg = r_metrics.MetricsRegistry()
    c = reg.counter("pio_tpu_queries_total", 'Queries "served"\nall',
                    ("engine_id",))
    c.inc(3, engine_id='e"1\\x')
    c.inc(2, engine_id="e2")
    h = reg.histogram("pio_tpu_request_seconds", "latency", ("engine_id",),
                      buckets=(0.005, 0.05, 0.5))
    for k, v in enumerate((0.001, 0.02, 0.02, 0.3, 4.0)):
        h.observe(v, exemplar=f"query-{k}", engine_id="e2")
    reg.gauge("pio_tpu_up", "up").set(1.5)
    return ["\n".join(reg.render()),
            "# TYPE pio_tpu_x counter\npio_tpu_x 7\n"
            "pio_tpu_x{a=\"c\"} +Inf\n"]


def _parsed(pm):
    return (pm.samples, pm.types, pm.helps, pm.exemplars)


def test_promparse_reads_reference_exposition():
    texts = _reference_texts()
    for text in texts:
        got = p_promparse.parse_prometheus_text(text)
        want = r_promparse.parse_prometheus_text(text)
        assert repr(_parsed(got)) == repr(_parsed(want))
        assert p_promparse.render(got) == r_promparse.render(want)
        assert (got.histogram_quantile("pio_tpu_request_seconds", 0.5,
                                       engine_id="e2")
                == want.histogram_quantile("pio_tpu_request_seconds", 0.5,
                                           engine_id="e2"))
    merged = p_promparse.merge(*[
        p_promparse.with_labels(p_promparse.parse_prometheus_text(t),
                                pio_tpu_member=f"m{k}")
        for k, t in enumerate(texts)])
    ref = r_promparse.merge(*[
        r_promparse.with_labels(r_promparse.parse_prometheus_text(t),
                                pio_tpu_member=f"m{k}")
        for k, t in enumerate(texts)])
    assert p_promparse.render(merged) == r_promparse.render(ref)


class FakeFleet:
    """Members' endpoints as strings; None is an unreachable member."""

    def __init__(self, members):
        self.members = members

    def fetch(self, url, timeout):
        host, _, path = url.split("://", 1)[1].partition("/")
        endpoints = self.members.get(host)
        if endpoints is None:
            raise OSError(f"connection refused: {host}")
        if "/" + path not in endpoints:
            raise urllib.error.HTTPError(url, 404, "absent", {}, None)
        return endpoints["/" + path].encode()


def fleet_members():
    text = _reference_texts()[0]
    slo = {"slos": [{"name": "p99", "burnRates": {"300s": 0.5,
                                                  "3600s": 1.25}}]}
    return {
        "a:1": {"/metrics": text, "/readyz": '{"ready": true}',
                "/slo.json": json.dumps(slo),
                "/stats.json": json.dumps({"poolSize": 2, "worker": 0})},
        "b:2": {"/metrics": "# TYPE pio_tpu_queries_total counter\n"
                            'pio_tpu_queries_total{engine_id="e2"} 4\n'},
        "c:3": None,
    }


def _no_ages(x):
    """A payload with its clock readings (ages, times) dropped."""
    if isinstance(x, dict):
        return {k: _no_ages(v) for k, v in x.items()
                if "age" not in k.lower() and "time" not in k.lower()}
    if isinstance(x, list):
        return [_no_ages(v) for v in x]
    return x


def _no_age_lines(lines):
    return [ln for ln in lines if "scrape_age" not in ln]


def test_fleet_sums_over_stub_fetchers_match_reference():
    fake = FakeFleet(fleet_members())
    aggs = {}
    for name, cls, metrics in (("port", PFleet, p_metrics),
                               ("reference", RFleet, r_metrics)):
        agg = cls(parse_targets("a:1,b:2,c:3"),
                  registry=metrics.MetricsRegistry(), interval_s=0.05,
                  fetch=fake.fetch)
        assert agg.scrape_once() == 2
        aggs[name] = agg
    got, want = (aggs[k].fleet_payload() for k in ("port", "reference"))
    assert _no_ages(got) == _no_ages(want)
    assert got["fleet"]["up"] == 2 and got["fleet"]["down"] == 1
    assert (_no_age_lines(aggs["port"].obs.render())
            == _no_age_lines(aggs["reference"].obs.render()))
    pm = p_promparse.parse_prometheus_text(
        "\n".join(aggs["port"].obs.render()))
    assert pm.value("pio_tpu_queries_total", engine_id="e2",
                    pio_tpu_member="a:1") == 2
    assert pm.value("pio_tpu_queries_total", engine_id="e2",
                    pio_tpu_member="b:2") == 4


# ------------------------------------------------------------------ routes
@pytest.fixture()
def both_stores(tmp_path, monkeypatch):
    """Both packages' storage in memory, empty."""
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    monkeypatch.delenv("PIO_TPU_FLEET_TARGETS", raising=False)
    monkeypatch.delenv("PIO_TPU_TRAIN_STATUS_URL", raising=False)
    Storage.reset()
    JaxStorage.reset()
    yield
    Storage.reset()
    JaxStorage.reset()


def _normalized(status_ctype_body):
    """Families instead of a metrics text; keys for random strings."""
    status, ctype, body = status_ctype_body
    if isinstance(body, str) and "# TYPE" in body:
        body = sorted(line.split()[2] for line in body.splitlines()
                      if line.startswith("# TYPE "))
    return status, ctype.split(";")[0], body


def _serve_both(make, paths, scrape=None):
    """Each package's service on its own HTTP server: the normalized
    answers to ``paths`` (method, path, body) from each."""
    out = {}
    for name, service, server_cls in make():
        server = server_cls(service.router, "127.0.0.1", 0,
                            name=f"test-{name}").start()
        try:
            if scrape is not None:
                scrape(service)
            out[name] = [_normalized(request(server.port, m, p, b))
                         for m, p, b in paths]
        finally:
            server.stop()
    return out["port"], out["reference"]


def test_fleetd_routes_match_reference():
    fake = FakeFleet(fleet_members())

    def make():
        for name, mod, server_cls in (("port", p_fleetd, PServer),
                                      ("reference", r_fleetd, RServer)):
            yield name, mod.FleetService(parse_targets("a:1,b:2,c:3"),
                                         interval_s=0.05,
                                         fetch=fake.fetch), server_cls

    paths = [("GET", "/", b""), ("GET", "/readyz", b""),
             ("GET", "/healthz", b"")]
    got, want = _serve_both(make, paths)
    assert got == want and got[1][0] == 503  # no scrape pass yet
    paths = [("GET", "/readyz", b""), ("GET", "/metrics", b""),
             ("GET", "/fleet.json", b"")]
    got, want = _serve_both(make, paths,
                            scrape=lambda svc: svc.agg.scrape_once())
    assert got[0][0] == 200
    assert got[:2] == want[:2]
    assert _no_ages(list(got[2])) == _no_ages(list(want[2]))


def _stub_member():
    """A query server stand-in for the dashboard's serving view."""
    from pio_tpu_torch.server.http import Router, metrics_response

    r = Router()
    text = _reference_texts()[0] + "\n"
    r.add("GET", "/metrics", lambda req: (200, metrics_response([text])))
    r.add("GET", "/", lambda req: (200, {
        "status": "deployed", "engineInstanceId": "i1",
        "startTime": "2026-01-01T00:00:00+00:00", "requestCount": 5}))
    return PServer(r, "127.0.0.1", 0, name="stub-member").start()


def test_dashboard_routes_match_reference(both_stores):
    member = _stub_member()
    url = f"http://127.0.0.1:{member.port}"

    def make():
        yield ("port", p_dashboard.DashboardService(query_url=url), PServer)
        yield ("reference", r_dashboard.DashboardService(query_url=url),
               RServer)

    paths = [("GET", p, b"") for p in (
        "/", "/instances.json", "/instances/none.json",
        "/instances/none.html", "/serving.html", "/fleet.html",
        "/fleet.json", "/training.html", "/devices.html", "/metrics",
        "/healthz", "/readyz")]
    try:
        got, want = _serve_both(make, paths)
    finally:
        member.stop()
    statuses = [(s, c) for s, c, _ in got]
    assert statuses == [(s, c) for s, c, _ in want]
    assert [s for s, _ in statuses] == [200, 200, 404, 404, 200, 200, 404,
                                        200, 200, 200, 200, 200]
    assert statuses[0][1] == "text/html"
    # the pages without a live number and the JSON bodies are the same
    for k in (0, 1, 2, 3, 5, 6, 7, 9, 10, 11):
        assert got[k] == want[k], paths[k]
    # the serving view read the member's pool-wide totals
    assert "5" in got[4][2] and "pio_tpu_queries_total" not in got[4][2]


def test_admin_routes_match_reference(both_stores):
    def make():
        yield "port", p_admin.AdminService(), PServer
        yield "reference", r_admin.AdminService(), RServer

    paths = [("GET", "/", b""), ("GET", "/cmd/status", b""),
             ("POST", "/cmd/app", json.dumps({"name": "a1"}).encode()),
             ("POST", "/cmd/app", json.dumps({"name": "a1"}).encode()),
             ("POST", "/cmd/app", b"{}"), ("GET", "/cmd/app", b""),
             ("DELETE", "/cmd/app/a1/data", b""),
             ("DELETE", "/cmd/app/a1", b""),
             ("DELETE", "/cmd/app/a1", b""), ("GET", "/cmd/app", b"")]
    got, want = _serve_both(make, paths)

    def keyless(x, key=False):
        """Generated access keys (random in both packages) as ``<key>``."""
        if isinstance(x, dict):
            return {k: keyless(v, "key" in k.lower()) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [keyless(v, key) for v in x]
        return "<key>" if key and isinstance(x, str) else x

    assert [keyless(a) for a in got] == [keyless(a) for a in want]
    assert [s for s, _, _ in got][:5] == [200, 200, 201, 409, 400]


# ---------------------------------------------------------------- the pool
@pytest.fixture(scope="module")
def pool_home(tmp_path_factory):
    """SQLite storage under a module home with one stored classification
    instance; spawned workers inherit the environment."""
    mp = pytest.MonkeyPatch()
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        mp.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", raising=False)
    for name in ("PIO_TPU_QOS", "PIO_TPU_SLO", "PIO_TPU_FAULTS"):
        mp.delenv(name, raising=False)
    mp.setenv("PIO_TPU_HOME", str(tmp_path_factory.mktemp("plane-home")))
    Storage.reset()
    seed_events(user_rows(), app=APP, reference=False)
    yield train_cls(1)
    Storage.reset()
    mp.undo()


def _families(port, path="/metrics"):
    return p_promparse.parse_prometheus_text(request(port, "GET", path)[2])


def test_pool_reports_pool_totals_and_one_budget(pool_home):
    """Two CPU workers under ``rps=0.01,burst=6``: 20 queries on fresh
    connections (the kernel spreads them over the workers) admit the
    burst, not twice it; each worker's sidecar ``/metrics`` reports the
    same pool-wide totals; a killed worker's respawn adopts its stripe."""
    pool = ServingPool(cls_variant(1), host="127.0.0.1", port=0,
                       n_workers=2, device="cpu", qos="rps=0.01,burst=6")
    pool.start()
    sup = None
    try:
        pool.wait_ready(timeout=READY_S)
        assert until(lambda: min(pool._health_ports) > 0, READY_S)
        assert pool._metrics_seg.generations() == [1, 1]
        body = json.dumps(QUERIES[0]).encode()
        statuses = [request(pool.port, "POST", "/queries.json", body)[0]
                    for _ in range(20)]
        assert sorted(set(statuses)) == [200, 429]
        assert statuses.count(200) == 6
        # both workers' views of the pool, through their sidecars
        views = [_families(pool._health_ports[w]) for w in range(2)]
        eng = cls_variant(1).engine_id
        for pm in views:
            assert pm.value("pio_tpu_queries_total", engine_id=eng) == 20
            assert pm.value("pio_tpu_qos_admitted_total",
                            scope="queryserver") == 6
            assert pm.value("pio_tpu_qos_shed_total", scope="queryserver",
                            reason="rate_limit") == 14
            assert [pm.value("pio_tpu_pool_stripe_generation",
                             worker=str(w)) for w in range(2)] == [1, 1]
        errors = views[0].value("pio_tpu_query_errors_total", engine_id=eng)
        assert views[1].value("pio_tpu_query_errors_total",
                              engine_id=eng) == errors
        assert pool.worker_stats(1)["pool"] == {"requestCount": 20,
                                                "errorCount": int(errors)}
        ready = request(pool._health_ports[1], "GET", "/readyz")
        assert ready[0] == 200 and "pool_stripe" in json.dumps(ready[2])
        # kill worker 1: its respawn adopts the stripe
        sup = threading.Thread(target=pool.wait, kwargs={"poll_s": 0.1},
                               daemon=True)
        sup.start()
        victim = pool._procs[1]
        victim.kill()
        victim.join(HTTP_S)
        assert until(lambda: pool._procs[1] is not victim
                     and pool._procs[1].is_alive()
                     and pool._health_ports[1] > 0, READY_S)
        assert until(lambda: request(pool._health_ports[1], "GET",
                                     "/readyz")[0] == 200, READY_S)
        assert pool._metrics_seg.generations() == [1, 2]
        pm = _families(pool._health_ports[1])
        assert pm.value("pio_tpu_queries_total", engine_id=eng) == 20
        assert pm.value("pio_tpu_pool_stripe_generation", worker="1") == 2
        assert request(pool.port, "POST", "/undeploy", b"{}")[0] == 200
        sup.join(JOIN_S)
        assert not sup.is_alive()
    finally:
        pool.stop()
        if sup is not None:
            sup.join(JOIN_S)
