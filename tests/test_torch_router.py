"""The port's router and rollout against the JAX package's, on the CPU.

- ``router/ring.py``: ``slot_of`` and ``hrw_score`` bit for bit over
  10,000 keys, and the ring's orders.
- ``router/core.py``: the member choice over the same fleet payloads
  (affinity, spreading, demotion of burning members, a partlog leader's
  replication lag over ``PIO_TPU_ROUTER_LAG_SOFT_BYTES``), the sheds
  with their reason and ``Retry-After``, ``forward_headers``, and the
  hedged forwards of ``PIO_TPU_ROUTER_HEDGE_MS`` over stub members.
- ``router/rollout.py``: ``diff_answers``, and the controller's promote
  and rollback decisions over scripted candidate metrics and over fake
  members with manifest verification.
- ``router/deploy.py`` against the port's ``/deploy.json``: both
  packages' ``push_deploy`` flip a real port query server's generation
  after ``verify_instance``, a bad instance answers 409 and keeps it.
- The query server's ``GET``/``POST /deploy.json`` against the
  reference's, each a two-worker pool over its own store: the report
  (a sharded instance's sha256s too), 400 without an instance id, 409
  on a torn or disagreeing manifest, and the pool's shared generation.
- ``server/routerd.py``: both packages' routers in front of the same two
  port query servers answer as the servers do, with the same routes; a
  rollout through each promotes, and one whose candidate burns its SLO
  rolls back and leaves the old generation; a rollout over the
  recommendation template's keyed queries diverts the canary's share of
  the keyspace to the candidate.
- The verbs ``fleet``, ``route`` and ``rollout`` exit 1 on a bad spec as
  the reference's do.
"""

import argparse
import contextlib
import http.client
import http.server
import json
import threading
import time

import pytest

from pio_tpu.obs.metrics import MetricsRegistry as RRegistry
from pio_tpu.router import core as r_core
from pio_tpu.router import deploy as r_deploy
from pio_tpu.router import ring as r_ring
from pio_tpu.router import rollout as r_rollout
from pio_tpu.server import routerd as r_routerd
from pio_tpu.server.http import JsonHTTPServer as RServer
from pio_tpu.tools import cli as r_cli
from pio_tpu_torch.obs.metrics import MetricsRegistry as PRegistry
from pio_tpu_torch.router import core as p_core
from pio_tpu_torch.router import deploy as p_deploy
from pio_tpu_torch.router import ring as p_ring
from pio_tpu_torch.router import rollout as p_rollout
from pio_tpu_torch.server import routerd as p_routerd
from pio_tpu_torch.server.http import JsonHTTPServer as PServer
from pio_tpu_torch.server.query_server import deploy_query_server
from pio_tpu_torch.storage.records import Model
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.tools import cli as p_cli
from test_rollout import _Member, _dual_store, _manifest_for, _shas
from test_torch_classification import APP, QUERIES, user_rows
from test_torch_microbatch import HTTP_S, cls_variant, train_cls, until
from test_torch_similarproduct import seed_events

#: (ring, core, rollout, deploy, routerd, registry, HTTP server) a package
PACKAGES = {
    "port": (p_ring, p_core, p_rollout, p_deploy, p_routerd, PRegistry,
             PServer),
    "reference": (r_ring, r_core, r_rollout, r_deploy, r_routerd, RRegistry,
                  RServer),
}
KEYS = [f"user{i}" for i in range(10_000)]
MEMBERS = [f"m{i}" for i in range(5)]
#: an address nothing listens on: a forward there fails at connect
DEAD = "http://127.0.0.1:9"


def request(port, method, path, body=None, headers=None):
    """``(status, headers, parsed body)`` on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, data,
                     {"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        raw = r.read().decode()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        try:
            return r.status, hdrs, json.loads(raw)
        except ValueError:
            return r.status, hdrs, raw
    finally:
        conn.close()


# -------------------------------------------------------------------- ring
@pytest.mark.parametrize("partitions", [1, 3, 7, 64])
def test_slot_and_hrw_score_are_bitwise(partitions):
    assert ([p_ring.slot_of(k, partitions) for k in KEYS]
            == [r_ring.slot_of(k, partitions) for k in KEYS])
    for m in MEMBERS[:2]:
        assert ([p_ring.hrw_score(m, k) for k in KEYS]
                == [r_ring.hrw_score(m, k) for k in KEYS])


@pytest.mark.parametrize("partitions,alive", [
    (None, MEMBERS), (5, MEMBERS), (5, MEMBERS[1:]), (3, MEMBERS[:3]),
])
def test_ring_ranks_match_reference(partitions, alive):
    got = p_ring.Ring(MEMBERS, partitions=partitions)
    want = r_ring.Ring(MEMBERS, partitions=partitions)
    for k in KEYS[:2000]:
        assert got.rank(k, alive) == want.rank(k, alive)


def test_forward_headers_match_reference():
    headers = {"Content-Type": "application/json", "X-Pio-Priority": "batch",
               "x-pio-deadline-ms": "50", "Authorization": "Bearer k",
               "Connection": "keep-alive", "Content-Length": "12",
               "Host": "h", "X-Other": "1"}
    assert p_core.forward_headers(headers) == r_core.forward_headers(headers)


# ------------------------------------------------------------ member choice
def _fleet(status=None, burn=None, headroom=None, lag=None):
    """A ``/fleet.json`` payload over MEMBERS; ``lag`` is a partlog
    leader's replication lag by follower (member), in bytes, over two
    partitions (the router keeps a follower's worst)."""
    status, burn, headroom = status or {}, burn or {}, headroom or {}
    payload = {"members": [
        {"member": m, "status": status.get(m, "up"),
         "slo": {"worstBurn": burn[m]} if m in burn else None,
         "devices": ({"headroomBytes": headroom[m]}
                     if m in headroom else None)}
        for m in MEMBERS]}
    if lag:
        payload["partlog"] = {"leaders": [{
            "member": "log0", "partitionDetail": [
                {"partition": k, "followers": [
                    {"follower": m, "lagBytes": n // (2 - k)}
                    for m, n in lag.items()] + [
                    {"follower": "m0", "lagBytes": None}]}
                for k in (0, 1)]}]}
    return payload


SCENARIOS = {
    "all_up": (_fleet(), ""),
    "one_down": (_fleet(status={"m1": "down", "m3": "stale"}), ""),
    "burning": (_fleet(burn={"m2": 3.0, "m0": 0.5}), ""),
    "no_headroom": (_fleet(headroom={"m4": 0.0, "m0": 1e9}), ""),
    "all_burning_batch": (_fleet(burn={m: 5.0 for m in MEMBERS}),
                          "batchpredict"),
    "all_burning_interactive": (_fleet(burn={m: 5.0 for m in MEMBERS}), ""),
    "all_down": (_fleet(status={m: "down" for m in MEMBERS}), ""),
    # replication lag weighs in the load score over the soft limit
    # (PIO_TPU_ROUTER_LAG_SOFT_BYTES): the keyless spread and a burning
    # fleet's order put lagging followers last
    "lagging": (_fleet(lag={"m1": 3 << 27, "m3": 1 << 20}), ""),
    "lagging_soft_limit": (_fleet(burn={"m2": 1.0}, lag={"m3": 1 << 20}),
                           ""),
    "all_burning_lagging": (_fleet(burn={m: 5.0 for m in MEMBERS},
                                   lag={"m2": 1 << 26, "m4": 1 << 25}), ""),
}
#: the knobs a scenario sets (in both packages, which share their names)
SCENARIO_ENV = {"lagging_soft_limit": {
    "PIO_TPU_ROUTER_LAG_SOFT_BYTES": str(1 << 19)}}


def _picks(core, registry, payload, priority):
    router = core.ServingRouter([(m, DEAD) for m in MEMBERS], registry(),
                                partitions=5, burn_limit=2.0)
    router.ingest_fleet(payload)
    out = []
    for k in KEYS[:300] + [None] * 12:
        try:
            out.append([m.name for m in router.pick(k, priority)])
        except core.Shed as s:
            out.append(("shed", s.status, s.reason, s.retry_after_s))
    snap = router.snapshot()
    router.close()
    return out, snap


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_member_choice_and_sheds_match_reference(scenario, monkeypatch):
    for name, value in SCENARIO_ENV.get(scenario, {}).items():
        monkeypatch.setenv(name, value)
    payload, priority = SCENARIOS[scenario]
    got, got_snap = _picks(p_core, PRegistry, payload, priority)
    want, want_snap = _picks(r_core, RRegistry, payload, priority)
    assert got == want
    assert got_snap == want_snap
    if scenario in ("all_down", "all_burning_batch"):
        assert all(p[0] == "shed" and p[1] == 503 for p in got)


def test_router_shed_answers_503_with_retry_after_like_reference():
    answers = {}
    for name, (_, _, _, _, routerd, _, server_cls) in PACKAGES.items():
        service = routerd.RouterService([("m0", DEAD), ("m1", DEAD)],
                                        interval_s=5.0,
                                        fetch=lambda url, t: b"")
        service.core.ingest_fleet({"members": [
            {"member": m, "status": "down"} for m in ("m0", "m1")]})
        server = server_cls(service.router, "127.0.0.1", 0,
                            name=f"router-{name}").start()
        try:
            answers[name] = request(server.port, "POST", "/queries.json",
                                    {"user": "u1"})
        finally:
            server.stop()
            service.core.close()
    (s, h, b), (rs, rh, rb) = answers["port"], answers["reference"]
    assert (s, h["retry-after"], b) == (rs, rh["retry-after"], rb)
    assert s == 503 and "no_members" in b["message"]


# ------------------------------------------------------------------ hedging
#: the hedge budget (ms), and how long the slow and the medium members
#: take (s)
HEDGE_MS, SLOW_S, MEDIUM_S = 200, 1.5, 0.4


class _Stub(http.server.BaseHTTPRequestHandler):
    """A member that answers any POST with its name after its delay."""
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        time.sleep(self.server.delay_s)
        body = json.dumps({"member": self.server.label}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@contextlib.contextmanager
def _stub_members(delays):
    """``[(name, url)]``: a stub a delay, and ``None`` a dead member."""
    servers, out = [], []
    for k, delay in enumerate(delays):
        if delay is None:
            out.append((f"m{k}", DEAD))
            continue
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
        srv.delay_s, srv.label, srv.daemon_threads = delay, f"m{k}", True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        out.append((f"m{k}", f"http://127.0.0.1:{srv.server_port}"))
    try:
        yield out
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def _key_led_by(router, first, second):
    """A key whose plan starts ``[first, second]``."""
    for key in KEYS:
        if [m.name for m in router.pick(key)[:2]] == [first, second]:
            return key
    raise AssertionError((first, second))


def _hedged(core, registry, members, requests):
    """Each ``(key, priority)`` forwarded: ``(status, answer, member)``
    each, then the router's relay counters once every loser is done, and
    its hedge budget."""
    reg = registry()
    router = core.ServingRouter(members, reg, partitions=5, burn_limit=2.0)
    try:
        out = []
        for key, priority in requests:
            status, _, body, member = router.forward(
                "POST", "/queries.json", b"{}",
                {"Content-Type": "application/json"}, entity_id=key,
                priority=priority)
            out.append((status, json.loads(body), member))
        time.sleep(SLOW_S + 0.5)  # the slow losers answer in the back
        counters = sorted(ln for ln in reg.render() if ln.startswith((
            "pio_tpu_router_hedged_total", "pio_tpu_router_forwarded",
            "pio_tpu_router_retried", "pio_tpu_router_forward_errors")))
        return out, counters, router.snapshot()["policy"]["hedgeMs"]
    finally:
        router.close()


def test_hedged_forwards_match_reference(monkeypatch):
    """``PIO_TPU_ROUTER_HEDGE_MS``: an interactive request whose primary
    has not answered within the budget races the next replica and the
    first answer wins (the backup's, or the slow primary's); a primary
    that answers in time, and a batch request, are never hedged; a dead
    primary hedges at once."""
    monkeypatch.setenv("PIO_TPU_ROUTER_HEDGE_MS", str(HEDGE_MS))
    with _stub_members([SLOW_S, 0.0, None, MEDIUM_S]) as members:
        probe = p_core.ServingRouter(members, PRegistry(), partitions=5)
        requests = [
            (_key_led_by(probe, "m0", "m1"), ""),              # hedge won
            (_key_led_by(probe, "m3", "m0"), ""),              # primary won
            (_key_led_by(probe, "m1", "m0"), ""),              # in time
            (_key_led_by(probe, "m0", "m1"), "batchpredict"),  # no hedge
            (_key_led_by(probe, "m2", "m1"), ""),              # dead primary
        ]
        probe.close()
        got = _hedged(p_core, PRegistry, members, requests)
        want = _hedged(r_core, RRegistry, members, requests)
    assert got == want
    assert [m for _, _, m in got[0]] == ["m1", "m3", "m1", "m0", "m1"]
    assert got[2] == HEDGE_MS
    hedged = [ln for ln in got[1] if ln.startswith("pio_tpu_router_hedged")]
    assert hedged == ['pio_tpu_router_hedged_total{outcome="hedge_won"} 2',
                      'pio_tpu_router_hedged_total{outcome="primary_won"} 1']


# ----------------------------------------------------------------- rollout
@pytest.mark.parametrize("a,b,tol", [
    (b'{"x":1}', b'{"x":1}', 1e-3),
    (json.dumps({"itemScores": [{"item": "i1", "score": 1.0},
                                {"item": "i2", "score": 2.0}]}).encode(),
     json.dumps({"itemScores": [{"item": "i2", "score": 2.0004},
                                {"item": "i1", "score": 1.0}]}).encode(),
     1e-3),
    (json.dumps({"itemScores": [{"item": "i1", "score": 1.0}]}).encode(),
     json.dumps({"itemScores": [{"iid": "i1", "score": 1.5}]}).encode(),
     1e-3),
    (json.dumps({"label": "a", "confidence": 0.5}).encode(),
     json.dumps({"label": "a", "confidence": 0.5000001}).encode(), 1e-3),
    (b"abc", b"abd", 1e-3),
])
def test_diff_answers_match_reference(a, b, tol):
    for sa, sb in ((200, 200), (200, 500)):
        assert (p_rollout.diff_answers(sa, a, sb, b, score_tolerance=tol)
                == r_rollout.diff_answers(sa, a, sb, b, score_tolerance=tol))


#: scripted candidate scrapes: (queries total, errors, unreachable) a tick
JUDGE_SCRIPTS = {
    "clean": ([(100, 0, False), (200, 0, False), (300, 1, False)], {}),
    "burn": ([(100, 0, False), (200, 90, False), (300, 90, False)], {}),
    "unreachable": ([(100, 0, True)] * 4, {}),
    "mismatch": ([(100, 0, False)] * 2, {"mismatches": (45, 5)}),
    "latency": ([(100, 0, False)] * 2, {"latency": (0.010, 0.200)}),
    "abort": ([(100, 0, False)] * 2, {"abort": True}),
}


def _judge(rollout, core, registry, script, extra):
    state = {}

    def fetch(url, timeout):
        if state["down"]:
            raise OSError("injected scrape failure")
        return (f"pio_tpu_queries_total {state['total']}\n"
                f"pio_tpu_query_errors_total {state['errors']}\n").encode()

    cfg = rollout.RolloutConfig(
        candidate_instance="cand", candidate_targets=[("cand0", DEAD)],
        incumbent_instance="inc", judge_fast_s=30.0, judge_slow_s=120.0,
        burn_limit=2.0, availability_objective=0.99,
        shadow_min_samples=50 if "mismatches" in extra else 10_000,
        shadow_hold_s=10_000.0, mismatch_limit=0.02, latency_limit_x=5.0,
        down_after_failures=3)
    router = core.ServingRouter([("inc0", DEAD)], registry())
    ctrl = rollout.RolloutController(
        router, cfg, rollout.RolloutMetrics(registry()),
        manifest_loader=lambda iid: None, fetch=fetch)
    ctrl.stage = "shadow"
    ctrl._stage_entered = 0.0
    if "mismatches" in extra:
        ctrl.shadow_matches, ctrl.shadow_mismatches = extra["mismatches"]
    if "latency" in extra:
        ctrl._lat_incumbent.extend([extra["latency"][0]] * 30)
        ctrl._lat_candidate.extend([extra["latency"][1]] * 30)
    verdicts = []
    for tick, (total, errors, down) in enumerate(script):
        state.update(total=float(total), errors=float(errors), down=down)
        if extra.get("abort") and tick == 1:
            ctrl.abort(by="test")
        verdicts.append(ctrl.judge_once(now=10.0 * tick))
    trail = [(e["from"], e["to"], e["signal"], e.get("window"))
             for e in ctrl.trail]
    router.close()
    return verdicts, trail, ctrl.stage


@pytest.mark.parametrize("script", sorted(JUDGE_SCRIPTS))
def test_rollout_decisions_match_reference(script):
    ticks, extra = JUDGE_SCRIPTS[script]
    got = _judge(p_rollout, p_core, PRegistry, ticks, extra)
    want = _judge(r_rollout, r_core, RRegistry, ticks, extra)
    assert got == want
    assert got[2] == ("shadow" if script == "clean" else "rolled_back")


def _fabric_run(rollout, core, registry, reject_second):
    """Two incumbents and a candidate (fake members verifying pushed
    manifests against one store) through deploy, shadow, canary and
    promote; with ``reject_second`` the second incumbent refuses the
    candidate and the promote rolls back. Returns the trail's signals,
    the stage and each member's swaps."""
    store, manifests = _dual_store()
    incs = [_Member(f"inc{i}", store, instance="inc",
                    manifest=manifests["inc"]) for i in range(2)]
    cand = _Member("cand0", store)
    incs[1].reject_deploys = reject_second
    router = core.ServingRouter([(m.name, m.url) for m in incs], registry())
    ctrl = rollout.RolloutController(
        router, rollout.RolloutConfig(
            candidate_instance="cand",
            candidate_targets=[(cand.name, cand.url)], shadow_rate=1.0,
            shadow_min_samples=2, shadow_hold_s=0.0, canary_fraction=1.0,
            canary_hold_s=0.0, canary_min_requests=1, mismatch_limit=0.5),
        rollout.RolloutMetrics(router.obs), manifest_loader=manifests.get)
    try:
        ctrl._deploy_candidate()
        ctrl._enter_shadow()
        out = json.dumps({"itemScores": [{"item": "i1", "score": 1.0}]})
        for i in range(3):
            ctrl.observe("POST", "/queries.json",
                         json.dumps({"user": f"user{i}"}).encode(),
                         {"content-type": "application/json"}, f"user{i}",
                         "", "inc0", 200, out.encode(), 0.002)
        assert until(lambda: ctrl.shadow_matches
                     + ctrl.shadow_mismatches >= 2)
        verdicts = [ctrl.judge_once()]
        router.forward("POST", "/queries.json",
                       json.dumps({"user": "user1"}).encode(),
                       {"content-type": "application/json"},
                       entity_id="user1")
        assert until(lambda: ctrl.canary_requests >= 1)
        verdicts.append(ctrl.judge_once())
        return (verdicts, [e["signal"] for e in ctrl.trail], ctrl.stage,
                [[(iid, shas == _shas(manifests[iid]), gen)
                  for iid, shas, gen in m.swaps] for m in incs + [cand]])
    finally:
        ctrl.stop()
        router.close()
        for m in incs + [cand]:
            m.stop()


@pytest.mark.parametrize("reject_second", [False, True],
                         ids=["promote", "rollback"])
def test_rollout_stage_machine_matches_reference(reject_second):
    got = _fabric_run(p_rollout, p_core, PRegistry, reject_second)
    want = _fabric_run(r_rollout, r_core, RRegistry, reject_second)
    assert got == want
    assert got[2] == ("rolled_back" if reject_second else "promoted")


# --------------------------------------------- /deploy.json and the routers
@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """Two stored classification instances in the port's memory storage
    and two port query servers over the first (``deploy_query_server``,
    on the CPU)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PIO_TPU_HOME", str(tmp_path_factory.mktemp("router-home")))
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        mp.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    mp.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    mp.setenv("PIO_TPU_DEVICEWATCH", "0")
    for name in ("PIO_TPU_QOS", "PIO_TPU_SLO", "PIO_TPU_FAULTS",
                 "PIO_TPU_FLEET_TARGETS", "PIO_TPU_SERVE_MICROBATCH_US"):
        mp.delenv(name, raising=False)
    Storage.reset()
    seed_events(user_rows(), app=APP, reference=False)
    iids = [train_cls(1), train_cls(2)]
    servers = [deploy_query_server(cls_variant(1), host="127.0.0.1", port=0,
                                   instance_id=iids[0], device="cpu").start()
               for _ in range(2)]
    try:
        yield iids, servers
    finally:
        for s in servers:
            s.close()
        Storage.reset()
        mp.undo()


def _reset(servers, iid):
    for s in servers:
        s.service._load(iid)


def test_push_deploy_against_the_port_deploy_json(members):
    (first, second), servers = members
    _reset(servers, first)
    url = f"http://127.0.0.1:{servers[0].port}"
    status, _, report = request(servers[0].port, "GET", "/deploy.json")
    assert status == 200
    assert report["engineInstanceId"] == first
    assert report["manifestSha256"] == []
    gen = report["generation"]
    for k, deploy in enumerate((p_deploy, r_deploy)):
        target = (second, first)[k]
        outcome, detail = deploy.push_deploy(url, target, None)
        assert outcome == "verified" and detail["verified"] is True
        assert detail["engineInstanceId"] == target
        assert detail["sharded"] is False
        report = request(servers[0].port, "GET", "/deploy.json")[2]
        assert report["engineInstanceId"] == target
        assert report["generation"] == gen + k + 1
        outcome, detail = deploy.push_deploy(url, "absent", None)
        assert outcome == "rejected"
        assert request(servers[0].port, "GET", "/deploy.json")[2] == report


def test_verify_instance_matches_reference_on_the_port_store(members):
    (first, _), _ = members
    store = Storage.get_model_data_models()
    assert (p_deploy.verify_instance(store, first)
            == r_deploy.verify_instance(store, first))
    shards = [b"\x01" * 64, b"\x02" * 96]
    manifest = _manifest_for("sharded", shards)
    store.insert(Model("sharded.shards", json.dumps(manifest).encode()))
    for i, b in enumerate(shards):
        store.insert(Model(f"sharded.shard{i}", b))
    assert (p_deploy.verify_instance(store, "sharded", expected=manifest)
            == r_deploy.verify_instance(store, "sharded", expected=manifest))
    assert (p_deploy.manifest_digests(manifest)
            == r_deploy.manifest_digests(manifest))
    store.insert(Model("sharded.shard1", b"\x03" * 96))  # torn shard
    for mod in (p_deploy, r_deploy):
        with pytest.raises(mod.DeployVerifyError, match="checksum"):
            mod.verify_instance(store, "sharded", expected=manifest)
    other = dict(manifest, algos=[])
    for mod in (p_deploy, r_deploy):
        with pytest.raises(mod.DeployVerifyError, match="disagrees"):
            mod.verify_instance(store, "sharded", expected=other)
    for k in ("sharded.shards", "sharded.shard0", "sharded.shard1"):
        store.delete(k)


@pytest.fixture(scope="module")
def twin_pools(members, tmp_path_factory):
    """Each package serving the classification template from its own
    store (the same events, two instances trained in each): two query
    servers over the first instance, joined as the two workers of one
    pool by a shared generation and metrics segment, as ``ServingPool``
    joins them. ``{name: (iids, services, ports, models store, Model)}``;
    the port's instances are ``members``'."""
    import multiprocessing

    import pio_tpu.templates  # noqa: F401  (the JAX engine factories)
    from pio_tpu.obs import devicewatch as r_devicewatch
    from pio_tpu.obs import slog as r_slog
    from pio_tpu.obs.shm import PoolMetricsSegment as RSegment
    from pio_tpu.parallel.context import ComputeContext as JaxContext
    from pio_tpu.server import query_server as r_qs
    from pio_tpu.storage import Storage as JaxStorage
    from pio_tpu.storage.records import Model as RModel
    from pio_tpu.workflow import build_engine as jax_build_engine
    from pio_tpu.workflow import run_train as jax_run_train
    from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
    from pio_tpu_torch.obs import slog as p_slog
    from pio_tpu_torch.obs.shm import PoolMetricsSegment as PSegment
    from test_torch_classification import variant

    (first, second), _ = members
    JaxStorage.reset()
    seed_events(user_rows(), app=APP, port=False, reference=True)
    spec = variant("logreg")
    spec["algorithms"][0]["params"]["seed"] = 1
    rv = jax_variant_from_dict(spec)
    rctx = JaxContext.create(seed=0)
    riids = [jax_run_train(*jax_build_engine(rv), rv, ctx=rctx)
             for _ in range(2)]
    stamps = [(m, m.install().worker) for m in (p_slog, r_slog)]
    tmp = tmp_path_factory.mktemp("deploy-pools")
    segs = {"port": PSegment.create(str(tmp / "p.shm"), 2),
            "reference": RSegment.create(str(tmp / "r.shm"), 2)}
    pservers = [deploy_query_server(cls_variant(1), host="127.0.0.1",
                                    port=0, instance_id=first,
                                    device="cpu").start() for _ in range(2)]
    rpairs = [r_qs.create_query_server(rv, host="127.0.0.1", port=0,
                                       instance_id=riids[0], ctx=rctx)
              for _ in range(2)]
    for server, _ in rpairs:
        server.start()
    pools = {
        "port": ((first, second), [s.service for s in pservers],
                 [s.port for s in pservers], Storage.get_model_data_models(),
                 Model),
        "reference": (tuple(riids), [svc for _, svc in rpairs],
                      [srv.port for srv, _ in rpairs],
                      JaxStorage.get_model_data_models(), RModel),
    }
    for name, (_, services, _, _, _) in pools.items():
        gen = multiprocessing.Value("L", 0)
        for w, service in enumerate(services):
            service.enable_pool(w, 2, gen, threading.Event(),
                                metrics_path=segs[name].path)
    try:
        yield pools
    finally:
        for s in pservers:
            s.close()
        for server, service in rpairs:
            server.stop()
            service.devwatch.stop()
            r_devicewatch.deactivate(service.devwatch)
        for seg in segs.values():
            seg.unlink()
        for mod, worker in stamps:
            mod.install().worker = worker
        JaxStorage.reset()


#: the shards of a sharded instance's manifest, and a torn copy of one
SHARDS = [b"\x05" * 64, b"\x06" * 96]


def _deploy_case(case, iids, services, ports, store, model_cls):
    """One ``/deploy.json`` exchange on a pool whose workers serve the
    first instance: ``[(status, body)]``, each instance id named by its
    role and each generation counted from the case's start."""
    first, second = iids
    for service in services:
        service._load(first)
    gen0 = request(ports[0], "GET", "/deploy.json")[2]["generation"]
    names = {first: "<first>", second: "<second>"}

    def norm(x):
        if isinstance(x, dict):
            return {k: (v - gen0 if k == "generation" else norm(v))
                    for k, v in x.items()}
        if isinstance(x, list):
            return [norm(v) for v in x]
        return names.get(x, x) if isinstance(x, str) else x

    def exchange(method, body=None, port=ports[0]):
        status, _, got = request(port, method, "/deploy.json", body)
        return status, norm(got)

    manifest = _manifest_for("torn", SHARDS)
    keys = []
    try:
        if case == "sharded_report":
            # the served instance's manifest, as a sharded save leaves it
            served = _manifest_for(first, SHARDS)
            rows = {f"{first}.shards": json.dumps(served).encode(),
                    **{f"{first}.shard{i}": b for i, b in enumerate(SHARDS)}}
        elif case in ("torn", "disagrees"):
            rows = {"torn.shards": json.dumps(manifest).encode(),
                    "torn.shard0": SHARDS[0],
                    "torn.shard1": (b"\x07" * 96 if case == "torn"
                                    else SHARDS[1])}
        else:
            rows = {}
        for key, blob in rows.items():
            store.insert(model_cls(key, blob))
            keys.append(key)
        if case in ("report", "sharded_report"):
            return [exchange("GET")]
        if case == "no_id":
            return [exchange("POST", {}), exchange("GET")]
        if case == "absent":
            return [exchange("POST", {"engineInstanceId": "absent"}),
                    exchange("GET")]
        if case in ("torn", "disagrees"):
            sent = (manifest if case == "torn"
                    else dict(manifest, algos=[]))
            return [exchange("POST", {"engineInstanceId": "torn",
                                      "manifest": sent}),
                    exchange("GET")]
        # "swap": worker 0 swaps, worker 1 follows the pool's generation
        # at its next request, to the newest instance (the second)
        out = [exchange("POST", {"engineInstanceId": second}),
               exchange("GET")]
        # an unsharded report counts the stored blob's bytes, which each
        # package pickles its own way
        report = out[0][1]
        report["bytes"] = report["bytes"] == len(store.get(second).models)
        request(ports[1], "GET", "/")
        return out + [exchange("GET", port=ports[1])]
    finally:
        for key in keys:
            store.delete(key)


@pytest.mark.parametrize("case", ["report", "sharded_report", "no_id",
                                  "absent", "torn", "disagrees", "swap"])
def test_deploy_json_matches_reference(twin_pools, case):
    """GET and POST ``/deploy.json`` of the port's query server against
    the reference's, each pool over its own store: the report (with a
    sharded instance's manifest sha256s), a swap without an instance id
    (400), to an absent instance, to a torn or disagreeing manifest
    (409, the old generation kept), and a verified swap that bumps the
    pool's shared generation for the sibling."""
    got = _deploy_case(case, *twin_pools["port"])
    want = _deploy_case(case, *twin_pools["reference"])
    assert got == want
    first = got[0]
    if case == "sharded_report":
        assert first[1]["manifestSha256"] == _shas(
            _manifest_for("x", SHARDS))
    if case == "no_id":
        assert first[0] == 400
    if case in ("torn", "disagrees"):
        assert first[0] == 409 and got[1][1]["generation"] == 0
    if case == "swap":
        assert first[0] == 200 and first[1]["verified"] is True
        assert first[1]["bytes"] is True
        assert [b["engineInstanceId"] for _, b in got[1:]] == ["<second>"] * 2


def _router(name, servers, **kw):
    _, _, _, _, routerd, _, server_cls = PACKAGES[name]
    service = routerd.RouterService(
        [(f"m{i}", f"http://127.0.0.1:{s.port}")
         for i, s in enumerate(servers)], interval_s=0.1, **kw)
    server = server_cls(service.router, "127.0.0.1", 0,
                        name=f"router-{name}").start()
    service.start()
    assert until(lambda: service.agg.passes >= 1)
    return service, server


def _normalized_router_json(body):
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if "age" not in k.lower() and k not in (
                        "forwarded", "passes", "retried", "errors")}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(body)


def test_routers_answer_as_the_members_like_reference(members):
    (first, second), servers = members
    _reset(servers, first)
    direct = [request(servers[0].port, "POST", "/queries.json", q)[2]
              for q in QUERIES]
    seen = {}
    for name in PACKAGES:
        service, server = _router(name, servers)
        try:
            # the template's queries name no entity: the router spreads
            relayed = [request(server.port, "POST", "/queries.json", q)
                       for q in QUERIES]
            assert [b for _, _, b in relayed] == direct
            assert {h["x-pio-router-member"] for _, h, _ in relayed} <= {
                "m0", "m1"}
            out = [request(server.port, "GET", p)
                   for p in ("/", "/router.json", "/rollout.json",
                             "/healthz", "/readyz")]
            metrics = request(server.port, "GET", "/metrics")[2]
            seen[name] = (
                [(s, b) for s, _, b in out[:1]],
                _normalized_router_json(out[1][2]),
                [(s, b) for s, _, b in out[2:3]],
                [s for s, _, _ in out[3:]],
                sorted(ln.split()[2] for ln in metrics.splitlines()
                       if ln.startswith("# TYPE ")),
                [h["x-pio-router-member"] for _, h, _ in relayed])
        finally:
            server.stop()
            service.stop()
    assert seen["port"] == seen["reference"]
    assert seen["port"][3] == [200, 200]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_route_deploy_flips_every_member(members, name):
    (first, second), servers = members
    _reset(servers, first)
    before = [request(s.port, "GET", "/deploy.json")[2]["generation"]
              for s in servers]
    service, server = _router(name, servers)
    try:
        status, _, report = request(server.port, "POST", "/deploy",
                                    {"engineInstanceId": second})
        assert status == 200 and report["verified"] == 2
        assert [m["outcome"] for m in report["members"]] == ["verified"] * 2
        status, _, report = request(server.port, "POST", "/deploy",
                                    {"engineInstanceId": "absent"})
        assert status == 502 and report["verified"] == 0
    finally:
        server.stop()
        service.stop()
    after = [request(s.port, "GET", "/deploy.json")[2] for s in servers]
    assert [a["engineInstanceId"] for a in after] == [second] * 2
    assert [a["generation"] for a in after] == [g + 1 for g in before]


#: a rollout's knobs: short holds, every request mirrored, the whole
#: keyspace in canary; the template's queries name no entity, so none is
#: diverted to the candidate and the canary needs no requests
FAST_ROLLOUT = {"shadowRate": 1.0, "shadowMinSamples": 2,
                "shadowHoldSeconds": 0.0, "canaryFraction": 1.0,
                "canaryHoldSeconds": 0.0, "canaryMinRequests": 0,
                "judgeIntervalSeconds": 0.05, "mismatchLimit": 0.5}


def _rollout_through(name, servers, second, burn, queries=QUERIES,
                     knobs=FAST_ROLLOUT, record=None):
    """Ring ``[m0]``, candidate ``m1``: start a rollout of ``second``
    through the package's router, drive ``queries`` until it ends (with
    ``burn``, bad queries straight to the candidate burn its SLO).
    Returns the trail's signals and the end stage; ``record`` gets each
    relayed query with the member that answered it (``relayed``) and the
    last ``/rollout.json`` (``rollout``)."""
    service, server = _router(name, servers[:1])
    relayed = []
    try:
        body = dict(knobs, engineInstanceId=second,
                    targets=f"127.0.0.1:{servers[1].port}",
                    availabilityObjective=0.99, judgeFastSeconds=5.0,
                    judgeSlowSeconds=10.0, burnLimit=2.0)
        if burn:  # held in shadow until the judge sees the burn
            body["shadowMinSamples"] = 1_000_000
        status, _, got = request(server.port, "POST", "/rollout", body)
        assert status == 202, got
        stop = threading.Event()

        def traffic():
            k = 0
            while not stop.is_set():
                q = queries[k % len(queries)]
                _, hdrs, _ = request(server.port, "POST", "/queries.json", q)
                relayed.append((q, hdrs.get("x-pio-router-member")))
                if burn:
                    request(servers[1].port, "POST", "/queries.json",
                            {"attr0": 1})
                k += 1

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        try:
            assert until(lambda: request(server.port, "GET", "/rollout.json")
                         [2]["stage"] in ("promoted", "rolled_back",
                                          "failed"), 60)
        finally:
            stop.set()
            t.join(HTTP_S)
        ro = request(server.port, "GET", "/rollout.json")[2]
        if record is not None:
            record.update(relayed=relayed, rollout=ro)
        return [e["signal"] for e in ro["trail"]], ro["stage"]
    finally:
        server.stop()
        service.stop()


@pytest.mark.parametrize("burn", [False, True], ids=["promote", "slo_burn"])
def test_rollout_through_the_routers_like_reference(members, burn):
    (first, second), servers = members
    ends = {}
    for name in PACKAGES:
        _reset(servers, first)
        gen0 = request(servers[0].port, "GET", "/deploy.json")[2]
        ends[name] = _rollout_through(name, servers, second, burn)
        report = request(servers[0].port, "GET", "/deploy.json")[2]
        if burn:
            # the incumbent never left its generation
            assert report == gen0
        else:
            assert report["engineInstanceId"] == second
            assert report["generation"] == gen0["generation"] + 1
    assert ends["port"] == ends["reference"]
    assert ends["port"][1] == ("rolled_back" if burn else "promoted")
    if burn:
        assert ends["port"][0] == ["start", "candidate_verified", "slo_burn",
                                   "incumbent_restored"]


#: a canary over keyed queries: half the keyspace diverted to the
#: candidate, which must serve some of them before the rollout promotes
KEYED_ROLLOUT = dict(FAST_ROLLOUT, canaryFraction=0.5, canaryMinRequests=4)


@pytest.fixture(scope="module")
def rec_members(members):
    """The recommendation template, whose queries name a user: two ALS
    instances in the port's store (beside ``members``' classification
    app) and two port query servers over the first."""
    from pio_tpu_torch.parallel.context import ComputeContext
    from pio_tpu_torch.workflow.core_workflow import run_train
    from pio_tpu_torch.workflow.engine_json import (
        build_engine,
        variant_from_dict,
    )
    from test_torch_microbatch import REC_APP, REC_VARIANT, rec_rows

    seed_events([("rate", "user", u, i, {"rating": r}, t)
                 for u, i, r, t in rec_rows()], app=REC_APP,
                reference=False)
    v = variant_from_dict(REC_VARIANT)
    iids = [run_train(*build_engine(v), v, ctx=ComputeContext.create(
        seed=seed, device="cpu")) for seed in (1, 2)]
    servers = [deploy_query_server(v, host="127.0.0.1", port=0,
                                   instance_id=iids[0], device="cpu").start()
               for _ in range(2)]
    try:
        yield iids, servers
    finally:
        for s in servers:
            s.close()


def _canary_carve(rollout, candidate, users):
    """The users a package's rollout of ``candidate`` diverts in canary."""
    ctl = argparse.Namespace(
        cfg=argparse.Namespace(
            canary_fraction=KEYED_ROLLOUT["canaryFraction"]),
        _canary_seed=f"rollout:{candidate}")
    return {u for u in users
            if rollout.RolloutController.in_canary_keyspace(ctl, u)}


def test_canary_diverts_keyed_queries_like_reference(rec_members):
    """Through each package's router, a rollout whose queries name a user
    diverts the canary's share of the keyspace to the candidate, which
    serves at least ``canaryMinRequests`` of them before the rollout
    promotes; the other users stay on the incumbent."""
    from test_torch_microbatch import N_USERS

    (first, second), servers = rec_members
    queries = [{"user": f"u{k}", "num": 3} for k in range(N_USERS)]
    users = [q["user"] for q in queries]
    carve = _canary_carve(p_rollout, second, users)
    assert carve == _canary_carve(r_rollout, second, users)
    ends, diverted = {}, {}
    for name in PACKAGES:
        _reset(servers, first)
        rec = {}
        ends[name] = _rollout_through(name, servers, second, False,
                                      queries=queries, knobs=KEYED_ROLLOUT,
                                      record=rec)
        by = {m for _, m in rec["relayed"]} - {"m0"}
        diverted[name] = {q["user"] for q, m in rec["relayed"] if m != "m0"}
        canary = rec["rollout"]["canary"]
        assert len(by) == 1, by  # the candidate, and no other member
        assert canary["requests"] >= KEYED_ROLLOUT["canaryMinRequests"]
        assert canary["errors"] == 0
        assert diverted[name] and diverted[name] <= carve
    assert ends["port"] == ends["reference"]
    assert ends["port"] == (["start", "candidate_verified", "shadow_clean",
                             "canary_clean", "all_verified"], "promoted")
    report = request(servers[0].port, "GET", "/deploy.json")[2]
    assert report["engineInstanceId"] == second


# -------------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv", [
    ["fleet"],
    ["fleet", "--targets", " , "],
    ["route"],
    ["route", "--deploy", "i1", "--url", DEAD, "--timeout", "5"],
    ["rollout", "--url", DEAD, "--timeout", "5"],
    ["rollout", "--start", "i1", "--url", DEAD, "--timeout", "5"],
    ["rollout", "--abort", "--url", DEAD, "--timeout", "5"],
])
def test_bad_specs_of_the_new_verbs_exit_1_like_reference(monkeypatch,
                                                          capsys, argv):
    """The reference raises on a target list of separators alone (its
    process exits 1 on the traceback); the port says so and exits 1."""
    monkeypatch.delenv("PIO_TPU_FLEET_TARGETS", raising=False)
    assert p_cli.main(argv) == 1
    port_err = capsys.readouterr().err
    assert port_err.startswith("[ERROR] ")
    try:
        rc = r_cli.main(argv)
    except ValueError:
        rc = 1
    assert rc == 1


def test_new_verbs_parse_like_reference():
    argv = {
        "dashboard": ["--query-url", "http://h:1", "--fleet-targets", "a:1",
                      "--train-url", "http://h:2", "--port", "0"],
        "fleet": ["--targets", "a:1", "--interval", "0.5"],
        "route": ["--targets", "a:1,b:2", "--partitions", "2",
                  "--admin-key", "k", "--timeout", "3"],
        "rollout": ["--start", "i2", "--targets", "c:3", "--shadow-rate",
                    "0.5", "--canary-fraction", "0.2", "--burn-limit", "3"],
        "adminserver": ["--admin-key", "k", "--port", "0"],
    }
    for verb, rest in argv.items():
        got = vars(p_cli.build_parser().parse_args([verb, *rest]))
        want = vars(r_cli.build_parser().parse_args([verb, *rest]))
        for d in (got, want):
            d.pop("fn")
        assert got == want, verb

