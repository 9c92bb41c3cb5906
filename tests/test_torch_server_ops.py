"""The request plane of the port's two servers against the JAX package's,
on the CPU, over HTTP on loopback.

One text model (V = 512, hidden 16, 4 labels) is trained by the reference
on seeded ``$set`` events in memory storage and carried across to the
port with ``convert.py``; the reference serves its stored instance, the
port the same arrays in memory. Then, the same requests to each:

- a traced query: the stages in order, the adopted ``X-Pio-Trace`` id and
  parent, the echoed header, the ``served query`` record under the id in
  ``/logs.json``, and the payload keys of ``/traces.json``,
  ``/debug/hotpath.json``, ``/slo.json``, ``/qos.json``, ``/logs.json``,
  ``/plugins.json`` and the families of ``/metrics``;
- sheds under ``inflight=1,queue=0`` with a held predict holding the
  slot (503 ``queue_full``), the rate shed (429), both with
  ``Retry-After``; the deadline shed (nothing predicted) and a malformed
  deadline (400); the scorer breaker tripping on failing predictions,
  the stale cache's degraded answer and the ``breaker`` shed while open;
- the output blockers and sniffers of the plugins; feedback's ``predict``
  events field for field (``prId`` aside);
- the event server's new routes (payload keys), its traced stages, the
  webhooks storing the same events, an input blocker rejecting the same
  event, and the storage breaker tripping;
- ``deploy`` / ``eventserver`` with a bad ``--slo`` or ``--qos`` exit 1
  (the port in process, the reference as two processes);
- two pool workers of each package bound to a shared metrics segment
  admit one rate budget for the pool, with the reference's statuses.

Holding a slot uses an event, never a sleep: no verdict depends on a
wall-clock rate.
"""

import argparse
import contextlib
import http.client
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.data import Event as JaxEvent
from pio_tpu.obs import devicewatch as r_devicewatch
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.server import event_server as r_es
from pio_tpu.server import plugins as r_plugins
from pio_tpu.server import query_server as r_qs
from pio_tpu.storage import App as JaxApp
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.storage.records import AccessKey as JaxAccessKey
from pio_tpu.templates import textclassification as jtc
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.controller.engine import EngineParams, get_engine_factory
from pio_tpu_torch.convert import text_mlp_from_reference
from pio_tpu_torch.server import event_server as p_es
from pio_tpu_torch.server import plugins as p_plugins
from pio_tpu_torch.server import query_server as p_qs
from pio_tpu_torch.storage.records import AccessKey, App
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates import textclassification as ptc
from pio_tpu_torch.tools import cli as p_cli

REPO = pathlib.Path(__file__).resolve().parents[1]
HTTP_S = 30
APP, FEEDBACK_APP, KEY = "ops-text", "ops-feedback", "ops-key"
N_WORDS, N_DOCS = 600, 96
LABELS = ("atheism", "graphics", "hockey", "space")
#: the port's confidences against the reference's, the same f32 logits
#: summed in another order (as the text template's tests hold them)
CONF_TOL = 1e-5
VARIANT = {
    "id": APP,
    "engineFactory": "templates.textclassification",
    "datasource": {"params": {"app_name": APP}},
    "preparator": {"params": {"max_features": 511, "max_doc_tokens": 16}},
    "algorithms": [{"name": "mlp", "params": {
        "hidden": 16, "iterations": 5, "learning_rate": 0.05}}],
}


def corpus(seed, n):
    """Seeded documents: each label draws from its own quarter of the
    vocabulary, plus shared words, so V reaches 512."""
    rng = np.random.default_rng(seed)
    docs = []
    for k in range(n):
        label = LABELS[k % len(LABELS)]
        lo = (k % len(LABELS)) * (N_WORDS // len(LABELS))
        own = rng.integers(lo, lo + N_WORDS // len(LABELS), size=12)
        shared = rng.integers(0, N_WORDS, size=6)
        docs.append((label, " ".join(f"w{i}" for i in [*own, *shared])))
    return docs


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    """Both packages' memory storage with the app, the feedback app and a
    key; the reference's trained instance; the port's twin model."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PIO_TPU_HOME", str(tmp_path_factory.mktemp("ops")))
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        mp.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    mp.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    mp.setenv("PIO_TPU_DEVICEWATCH", "0")
    for name in ("PIO_TPU_SERVE_MICROBATCH_US", "PIO_TPU_QOS",
                 "PIO_TPU_SLO", "PIO_TPU_PLUGINS", "PIO_TPU_FAULTS",
                 "PIO_TPU_SLOW_TRACE_MS"):
        mp.delenv(name, raising=False)
    Storage.reset()
    JaxStorage.reset()
    ids = {}
    for storage, app_cls, key_cls, event_cls, pkg in (
            (JaxStorage, JaxApp, JaxAccessKey, JaxEvent, "reference"),
            (Storage, App, AccessKey, None, "port")):
        apps = storage.get_meta_data_apps()
        app_id = apps.insert(app_cls(0, APP))
        fb_id = apps.insert(app_cls(0, FEEDBACK_APP))
        storage.get_meta_data_access_keys().insert(key_cls(KEY, app_id, ()))
        ids[pkg] = (app_id, fb_id)
        if event_cls is not None:
            le = storage.get_levents()
            for n, (label, body) in enumerate(corpus(0, N_DOCS)):
                le.insert(event_cls("$set", "content", f"doc{n}",
                                    properties={"text": body,
                                                "label": label}), app_id)
    v = jax_variant_from_dict(VARIANT)
    engine, ep = jax_build_engine(v)
    ctx = JaxContext.local(0)
    iid = jax_run_train(engine, ep, v, ctx=ctx)
    ref = jax_load_models(iid, engine, ep, ctx)[0]
    arrays = {
        "w_in": ref.mlp.w_in, "b_in": ref.mlp.b_in,
        "w_out": ref.mlp.w_out, "b_out": ref.mlp.b_out,
        "vocab": ref.vectorizer.vocab, "idf": ref.vectorizer.idf,
        "labels": [ref.label_index.inverse[i]
                   for i in range(len(ref.label_index))],
        "bag_width": ref.bag_width, "token_cap": ref.token_cap,
    }
    port_model = text_mlp_from_reference(arrays, device="cpu")
    assert port_model.mlp.n_features == 512
    queries = [{"text": body} for _, body in corpus(1, 12)]
    yield argparse.Namespace(iid=iid, variant=v, ctx=ctx,
                             port_model=port_model, ids=ids, queries=queries)
    Storage.reset()
    JaxStorage.reset()
    mp.undo()


@contextlib.contextmanager
def query_servers(text, **kw):
    """``{"port": (port, service), "reference": (port, service)}`` over
    the same model, both started, both stopped after."""
    p_kw = dict(kw)
    r_kw = dict(kw)
    if "feedback_app_id" in kw:
        p_kw["feedback_app_id"] = text.ids["port"][1]
        r_kw["feedback_app_id"] = text.ids["reference"][1]
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", ptc.MLPParams()),))
    pserver = p_qs.create_query_server(
        engine, ep, [text.port_model], host="127.0.0.1", port=0,
        device="cpu", **p_kw)
    rserver, rservice = r_qs.create_query_server(
        text.variant, host="127.0.0.1", port=0, instance_id=text.iid,
        ctx=text.ctx, **r_kw)
    pserver.start()
    rserver.start()
    try:
        yield {"port": (pserver.port, pserver.service),
               "reference": (rserver.port, rservice)}
    finally:
        pserver.close()
        rserver.stop()
        rservice.devwatch.stop()
        r_devicewatch.deactivate(rservice.devwatch)


class Client:
    """One keep-alive connection: each answer is read before the next
    request, so a server's post-write hook has run by then."""

    def __init__(self, port):
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=HTTP_S)

    def __call__(self, method, path, body=None, headers=None):
        data = None
        if isinstance(body, (dict, list)):
            data = json.dumps(body).encode()
        elif isinstance(body, (bytes, str)):
            data = body if isinstance(body, bytes) else body.encode()
        self.conn.request(method, path, data, headers or {})
        r = self.conn.getresponse()
        raw = r.read()
        try:
            payload = json.loads(raw)
        except ValueError:
            payload = raw.decode()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, payload

    def close(self):
        self.conn.close()


def post_query(client, body, headers=None):
    return client("POST", "/queries.json", body,
                  {"Content-Type": "application/json", **(headers or {})})


def family_names(text_body):
    return {line.split()[2] for line in text_body.splitlines()
            if line.startswith("# TYPE ")}


def same_answer(got, want):
    assert got["label"] == want["label"]
    assert got["confidence"] == pytest.approx(want["confidence"],
                                              abs=CONF_TOL)


@contextlib.contextmanager
def held_predict():
    """Both packages' text predict blocks on an event: ``entered`` is set
    once a predict is inside, ``release`` lets it finish; ``calls``
    counts the predicts."""
    entered, release, calls = threading.Event(), threading.Event(), []
    mp = pytest.MonkeyPatch()
    for mod in (jtc, ptc):
        orig = mod.MLPAlgorithm.predict

        def predict(self, model, query, _orig=orig):
            calls.append(1)
            entered.set()
            release.wait(HTTP_S)
            return _orig(self, model, query)

        mp.setattr(mod.MLPAlgorithm, "predict", predict)
    try:
        yield entered, release, calls
    finally:
        release.set()
        mp.undo()


# ------------------------------------------------------------- query path
def test_traced_query_stages_header_and_logs_match_reference(text):
    out = {}
    with query_servers(text, slos=["p99=50ms:99.9", "availability=99.9"],
                       qos="inflight=8,queue=8,cache=8") as servers:
        for pkg, (port, svc) in servers.items():
            c = Client(port)
            answers = []
            for k, body in enumerate(text.queries[:4]):
                status, headers, got = post_query(
                    c, body, {"X-Pio-Trace": f"ops-{k}/caller"})
                assert status == 200
                answers.append((headers["x-pio-trace"], got))
            status, headers, got = post_query(c, text.queries[4])
            minted = headers["x-pio-trace"]
            _, _, one = c("GET", "/traces.json?id=ops-1")
            _, _, logs = c("GET", "/logs.json?trace_id=ops-2")
            routes = {r: c("GET", r) for r in (
                "/traces.json", "/traces.json?slow=1", "/debug/hotpath.json",
                "/slo.json", "/qos.json", "/logs.json?n=3", "/plugins.json",
                "/stats.json")}
            _, _, metrics = c("GET", "/metrics")
            _, _, missing = c("GET", "/traces.json?id=nope")
            c.close()
            out[pkg] = dict(answers=answers, minted=minted, one=one,
                            logs=logs, routes=routes, metrics=metrics,
                            missing=missing)
    got, want = out["port"], out["reference"]
    for (g_id, g), (w_id, w) in zip(got["answers"], want["answers"]):
        assert g_id == w_id
        same_answer(g, w)
    assert [a[0] for a in got["answers"]] == [f"ops-{k}" for k in range(4)]
    assert got["minted"].startswith("query-")
    g_tr, w_tr = got["one"]["traces"][0], want["one"]["traces"][0]
    stages = [s["stage"] for s in g_tr["spans"]]
    # admit.queue: the time in the concurrency limiter, recorded at the
    # tail of admit
    assert stages == [s["stage"] for s in w_tr["spans"]] == [
        "accept", "admit.queue", "admit", "parse", "queue", "execute.device",
        "execute", "serialize", "write"]
    assert g_tr["parent"] == w_tr["parent"] == "caller"
    assert g_tr.keys() == w_tr.keys()
    # the port's top-level spans tile the request: each starts where the
    # one before ended (each end read once; 0.0011 ms the two roundings)
    top = [s for s in g_tr["spans"] if "." not in s["stage"]]
    assert top[0]["startMs"] == 0.0
    for a, b in zip(top, top[1:]):
        assert b["startMs"] == pytest.approx(a["startMs"] + a["durMs"],
                                             abs=0.0011), (a, b)
    for pkg in out:
        msgs = [e["msg"] for e in out[pkg]["logs"]["logs"]]
        assert any(m.startswith("served query") for m in msgs), pkg
    for route, (status, _, payload) in got["routes"].items():
        w_status, _, w_payload = want["routes"][route]
        assert status == w_status == 200, route
        if route == "/stats.json":
            assert payload["stages"].keys() == w_payload["stages"].keys()
            continue
        assert payload.keys() == w_payload.keys(), route
    g_hot = got["routes"]["/debug/hotpath.json"][2]
    assert [s["stage"] for s in g_hot["stages"]] == [
        "accept", "admit", "parse", "queue", "execute", "serialize",
        "write"]
    assert g_hot["attributedFraction"] == pytest.approx(1.0, abs=0.05)
    g_slo = got["routes"]["/slo.json"][2]
    assert [s["name"] for s in g_slo["slos"]] == [
        s["name"] for s in want["routes"]["/slo.json"][2]["slos"]]
    assert got["missing"] == want["missing"]
    g_fam, w_fam = family_names(got["metrics"]), family_names(want["metrics"])
    for fam in ("pio_tpu_query_stage_seconds", "pio_tpu_request_seconds",
                "pio_tpu_e2e_seconds", "pio_tpu_queries_total",
                "pio_tpu_qos_shed_total", "pio_tpu_slo_burn_rate",
                "pio_tpu_log_messages_total"):
        assert fam in g_fam and fam in w_fam, fam


def test_sheds_answer_like_reference(text):
    """inflight=1, queue=0: a held predict holds the slot, the next query
    is shed 503 queue_full; then rps=0.001: the second query 429."""
    out = {}
    with held_predict() as (entered, release, _):
        with query_servers(text, qos="inflight=1,queue=0") as servers:
            for pkg, (port, _) in servers.items():
                entered.clear()
                release.clear()
                holder = {}
                t = threading.Thread(target=lambda: holder.setdefault(
                    "r", post_query(Client(port), text.queries[0])))
                t.start()
                assert entered.wait(HTTP_S)
                c = Client(port)
                shed = post_query(c, text.queries[1])
                release.set()
                t.join(HTTP_S)
                _, _, qos = c("GET", "/qos.json")
                c.close()
                out[pkg] = (holder["r"][0], shed[0], shed[1].get(
                    "retry-after"), shed[2], qos["shed"])
    with query_servers(text, qos="rps=0.001,burst=1") as servers:
        for pkg, (port, _) in servers.items():
            c = Client(port)
            first = post_query(c, text.queries[0])
            second = post_query(c, text.queries[1])
            c.close()
            out[pkg] += (first[0], second[0], second[1].get("retry-after"),
                         second[2])
    assert out["port"] == out["reference"]
    assert out["port"][:3] == (200, 503, "1")
    assert out["port"][3] == {"message": "overloaded: queue_full"}
    assert out["port"][5:8] == (200, 429, "1000")


def test_deadline_shed_launches_nothing_like_reference(text):
    out = {}
    with held_predict() as (_, release, calls):
        release.set()
        with query_servers(text, qos="inflight=4,queue=4") as servers:
            for pkg, (port, _) in servers.items():
                n0 = len(calls)
                c = Client(port)
                spent = post_query(c, text.queries[0],
                                   {"X-Pio-Deadline-Ms": "0.000001"})
                bad = post_query(c, text.queries[0],
                                 {"X-Pio-Deadline-Ms": "soon"})
                ok = post_query(c, text.queries[0],
                                {"X-Pio-Deadline-Ms": "60000"})
                _, _, qos = c("GET", "/qos.json")
                c.close()
                out[pkg] = (spent[0], spent[1].get("retry-after"), spent[2],
                            bad[0], ok[0], qos["shed"]["deadline"],
                            len(calls) - n0)
    assert out["port"] == out["reference"]
    assert out["port"] == (503, "1", {"message": "overloaded: deadline"},
                           400, 200, 1, 1)


def test_breaker_trips_and_stale_cache_degrades_like_reference(text):
    """One answer and one failing prediction fill the window of 2 at a
    failure rate of 0.5: the scorer breaker opens; a query answered
    before comes back 200 from the stale cache, marked, with its earlier
    answer; another is shed 503 breaker."""
    out = {}
    qos = "cache=8,fail_window=2,fail_rate=0.5,cooldown=60s,probes=1"
    with query_servers(text, qos=qos) as servers:
        for pkg, (port, _) in servers.items():
            c = Client(port)
            first = post_query(c, text.queries[0])
            mp = pytest.MonkeyPatch()
            for mod in (jtc, ptc):
                mp.setattr(mod.MLPAlgorithm, "predict",
                           lambda self, m, q: (_ for _ in ()).throw(
                               RuntimeError("scorer down")))
            try:
                fails = [post_query(c, text.queries[1])[0]]
                degraded = post_query(c, text.queries[0])
                shed = post_query(c, text.queries[3])
            finally:
                mp.undo()
            _, _, qos_json = c("GET", "/qos.json")
            c.close()
            out[pkg] = dict(
                first=first[2], fails=fails, degraded=degraded,
                shed=(shed[0], shed[2], int(shed[1]["retry-after"]) > 50),
                state=qos_json["breakers"]["scorer"]["state"],
                counts=(qos_json["degraded"], qos_json["shed"]["breaker"]))
    got, want = out["port"], out["reference"]
    assert got["fails"] == want["fails"] == [500]
    for pkg in out:
        d = out[pkg]["degraded"]
        assert d[0] == 200 and d[1]["x-pio-degraded"] == "stale-cache"
        assert d[2] == out[pkg]["first"]
    same_answer(got["degraded"][2], want["degraded"][2])
    assert got["shed"] == want["shed"] == (
        503, {"message": "overloaded: breaker"}, True)
    assert got["state"] == want["state"] == "open"
    assert got["counts"] == want["counts"] == (1, 1)


def test_breaker_shed_returns_its_admission_slot_like_reference(text):
    """inflight=1: the query the breaker sheds gives its concurrency slot
    back, so the next one is shed by the breaker again, not queue_full."""
    qos = "inflight=1,queue=0,fail_window=1,fail_rate=1,cooldown=60s"
    out = {}
    with query_servers(text, qos=qos) as servers:
        for pkg, (port, _) in servers.items():
            c = Client(port)
            mp = pytest.MonkeyPatch()
            for mod in (jtc, ptc):
                mp.setattr(mod.MLPAlgorithm, "predict",
                           lambda self, m, q: (_ for _ in ()).throw(
                               RuntimeError("scorer down")))
            try:
                codes = [post_query(c, text.queries[k]) for k in range(3)]
            finally:
                mp.undo()
            _, _, qos_json = c("GET", "/qos.json")
            c.close()
            out[pkg] = ([(s, b) for s, _, b in codes], qos_json["shed"],
                        qos_json["concurrency"]["inflight"])
    assert out["port"] == out["reference"]
    assert [s for s, _ in out["port"][0]] == [500, 503, 503]
    assert out["port"][0][2][1] == {"message": "overloaded: breaker"}
    assert out["port"][2] == 0


def test_blockers_sniffers_and_feedback_match_reference(text):
    sniffed = {"port": [], "reference": []}
    blocked_text = text.queries[2]["text"]

    def plugins(mod, pkg):
        class Blocker(mod.EngineServerPlugin):
            plugin_name = "no-third"
            plugin_type = mod.OUTPUT_BLOCKER

            def process(self, query, prediction):
                if query.get("text") == blocked_text:
                    raise ValueError("blocked by no-third")

        class Sniffer(mod.EngineServerPlugin):
            plugin_name = "sniff"
            plugin_type = mod.OUTPUT_SNIFFER

            def process(self, query, prediction):
                sniffed[pkg].append((query["text"], prediction["label"]))

        return Blocker(), Sniffer()

    out = {}
    try:
        for mod, pkg in ((p_plugins, "port"), (r_plugins, "reference")):
            for plugin in plugins(mod, pkg):
                mod.register_plugin(plugin)
        with query_servers(text, feedback=True,
                           feedback_app_id=True) as servers:
            for pkg, (port, _) in servers.items():
                c = Client(port)
                answers = [post_query(c, q) for q in text.queries[:4]]
                _, _, listing = c("GET", "/plugins.json")
                c.close()
                out[pkg] = (answers, listing)
    finally:
        p_plugins.clear_plugins()
        r_plugins.clear_plugins()
    got, want = out["port"], out["reference"]
    assert [a[0] for a in got[0]] == [a[0] for a in want[0]] == [
        200, 200, 400, 200]
    assert got[0][2][2] == want[0][2][2] == {"message": "blocked by no-third"}
    assert got[1] == want[1]
    assert [s[0] for s in sniffed["port"]] == [s[0] for s in
                                               sniffed["reference"]]
    events = {}
    for pkg, storage in (("port", Storage), ("reference", JaxStorage)):
        fb_id = text.ids[pkg][1]
        evs = sorted(storage.get_levents().find(fb_id),
                     key=lambda e: e.properties["query"]["text"])
        events[pkg] = evs
        answers = [a[2] for a in out[pkg][0] if a[0] == 200]
        assert len(evs) == len(answers) == 3
        assert {a["prId"] for a in answers} == {e.entity_id for e in evs}
    for g, w in zip(events["port"], events["reference"]):
        assert (g.event, g.entity_type) == (w.event, w.entity_type) == (
            "predict", "pio_pr")
        assert g.pr_id == g.entity_id and w.pr_id == w.entity_id
        gp, wp = dict(g.properties), dict(w.properties)
        assert gp["query"] == wp["query"]
        g_pred = {k: v for k, v in gp["prediction"].items() if k != "prId"}
        w_pred = {k: v for k, v in wp["prediction"].items() if k != "prId"}
        assert g_pred.keys() == w_pred.keys()
        same_answer(g_pred, w_pred)


class Clock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        return self.t


class DispatchStub:
    """A service for the batcher alone: records what it dispatches."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.batches = []

    def _predict_batch(self, queries, gen=None):
        self.batches.append(list(queries))
        return [f"ok:{q}" for q in queries]

    def _predict_one(self, query, gen=None):
        return f"solo:{query}"


@pytest.mark.parametrize("package", [p_qs, r_qs], ids=["port", "reference"])
def test_batcher_sheds_a_spent_deadline_before_the_dispatch(package):
    """A member whose deadline is spent by the drain is failed with
    DeadlineExceeded in its own thread; nothing is dispatched for it, and
    its trace gets the queue span."""
    from pio_tpu.obs import Tracer as RTracer
    from pio_tpu.qos import Deadline as RDeadline
    from pio_tpu.qos import DeadlineExceeded as RExceeded
    from pio_tpu_torch.obs import Tracer as PTracer
    from pio_tpu_torch.qos import Deadline as PDeadline
    from pio_tpu_torch.qos import DeadlineExceeded as PExceeded

    port = package is p_qs
    tracer = (PTracer if port else RTracer)("query")
    stub = DispatchStub(tracer)
    mb = package._MicroBatcher(stub, window_s=0.005, adaptive=False)
    clock = Clock()
    spent = (PDeadline if port else RDeadline)(1.0, clock=clock)
    clock.t += 1.0  # the whole budget, before the drain
    try:
        with tracer.trace("query", trace_id="late") as tr:
            with pytest.raises(PExceeded if port else RExceeded):
                mb.submit("q", span_sink=tr, deadline=spent)
        assert stub.batches == []
        assert [s["stage"] for s in tracer.find("late")["spans"]] == [
            "queue"]
    finally:
        mb.stop()


def test_microbatch_traces_link_their_members_like_reference(text,
                                                            monkeypatch):
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_US", "20000")
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE", "0")
    out = {}
    with query_servers(text) as servers:
        for pkg, (port, _) in servers.items():
            def client(k):
                c = Client(port)
                try:
                    return [post_query(c, text.queries[(k + n) % 12],
                                       {"X-Pio-Trace": f"mb-{k}-{n}"})[0]
                            for n in range(2)]
                finally:
                    c.close()

            results = {}
            threads = [threading.Thread(
                target=lambda k=k: results.setdefault(k, client(k)))
                for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(HTTP_S)
            # a request's write span lands after its client has the
            # answer (the server's post-write hook): wait for all 16
            c = Client(port)
            for _ in range(500):
                _, _, traces = c("GET", "/traces.json?n=128&order=recent")
                if sum(t["kind"] == "query" and t["spans"][-1]["stage"]
                       == "write" for t in traces["traces"]) == 16:
                    break
                threading.Event().wait(0.01)
            c.close()
            out[pkg] = (results, traces["traces"])
    for pkg, (results, traces) in out.items():
        assert all(v == [200, 200] for v in results.values()), pkg
        batches = [t for t in traces if t["kind"] == "microbatch"]
        members = {t["id"]: t for t in traces if t["kind"] == "query"}
        assert batches and len(members) == 16, pkg
        linked = [i for b in batches for i in b["links"]]
        assert sorted(linked) == sorted(members), pkg
        for b in batches:
            assert [s["stage"] for s in b["spans"]] == ["execute.device"]
            for member in b["links"]:
                assert members[member]["meta"]["microbatch"] == b["id"]
        for t in members.values():
            assert [s["stage"] for s in t["spans"]] == [
                "accept", "admit", "parse", "queue", "execute",
                "serialize", "write"], pkg


# ---------------------------------------------------------- event server
@contextlib.contextmanager
def event_servers(**kw):
    pserver = p_es.create_event_server(host="127.0.0.1", port=0, **kw)
    rserver = r_es.create_event_server(host="127.0.0.1", port=0, **kw)
    pserver.start()
    rserver.start()
    try:
        yield {"port": pserver.port, "reference": rserver.port}
    finally:
        pserver.stop()
        rserver.stop()


def rate(k, **extra):
    d = {"event": "rate", "entityType": "user", "entityId": f"u{k % 5}",
         "targetEntityType": "item", "targetEntityId": f"i{k % 3}",
         "properties": {"rating": float(1 + k % 5)},
         "eventTime": f"2026-01-01T00:00:{k % 60:02d}.000Z"}
    d.update(extra)
    return d


EVENT_ROUTES = ("/stats.json", "/traces.json", "/traces.json?slow=1",
                "/debug/hotpath.json", "/logs.json?n=2", "/slo.json",
                "/qos.json", "/storage.json", "/healthz", "/readyz",
                "/plugins.json", "/faults.json")


def test_event_server_routes_and_stages_match_reference(text):
    out = {}
    with event_servers(slos=["p99=50ms:99", "availability=99"],
                       qos="inflight=8,queue=8,key_rps=1000") as servers:
        for pkg, port in servers.items():
            c = Client(port)
            one = c("POST", f"/events.json?accessKey={KEY}", rate(1),
                    {"X-Pio-Trace": "ev-1/client"})
            batch = c("POST", f"/batch/events.json?accessKey={KEY}",
                      [rate(k) for k in range(5)],
                      {"X-Pio-Trace": "ev-2"})
            _, _, t1 = c("GET", "/traces.json?id=ev-1")
            _, _, t2 = c("GET", "/traces.json?id=ev-2")
            routes = {r: c("GET", r) for r in EVENT_ROUTES}
            _, _, metrics = c("GET", "/metrics")
            c.close()
            out[pkg] = dict(one=one, batch=batch, t1=t1, t2=t2,
                            routes=routes, metrics=metrics)
    got, want = out["port"], out["reference"]
    for k in ("one", "batch"):
        assert got[k][0] == want[k][0]
        assert got[k][1]["x-pio-trace"] == want[k][1]["x-pio-trace"]
    for k, stages in (("t1", ["accept", "admit", "parse", "validate",
                              "store", "write"]),
                      ("t2", ["accept", "admit", "validate", "store",
                              "write"])):
        g = [s["stage"] for s in got[k]["traces"][0]["spans"]]
        w = [s["stage"] for s in want[k]["traces"][0]["spans"]]
        assert g == w == stages, k
    assert got["t1"]["traces"][0]["parent"] == "client"
    for route in EVENT_ROUTES:
        g_status, _, g_payload = got["routes"][route]
        w_status, _, w_payload = want["routes"][route]
        assert g_status == w_status, route
        assert g_payload.keys() == w_payload.keys(), route
    g_fam = {n for n in family_names(got["metrics"])
             if not n.startswith(p_es.STORAGE_METRIC_PREFIXES)}
    w_fam = {n for n in family_names(want["metrics"])
             if not n.startswith(("pio_tpu_partlog_", "pio_tpu_repl_"))}
    assert g_fam == w_fam


WEBHOOKS = [
    ("/webhooks/segmentio.json", {
        "type": "track", "event": "signup", "userId": "wu1",
        "properties": {"plan": "pro"},
        "timestamp": "2026-02-01T10:00:00.000Z"}, "application/json"),
    ("/webhooks/segmentio.json", {"type": "identify", "anonymousId": "anon",
                                  "traits": {"age": 3}},
     "application/json"),
    ("/webhooks/segmentio.json", {"type": "bogus", "userId": "x"},
     "application/json"),
    ("/webhooks/example.json", {"event": "view", "entityType": "user",
                                "entityId": "wu2",
                                "eventTime": "2026-02-01T10:00:00.000Z"},
     "application/json"),
    ("/webhooks/mailchimp.form",
     "type=subscribe&fired_at=2026-02-01 10:00:00&data[email]=a@b.c"
     "&data[merges][FNAME]=Ann", "application/x-www-form-urlencoded"),
    ("/webhooks/nope.json", {"event": "x"}, "application/json"),
    ("/webhooks/nope.form", "a=b", "application/x-www-form-urlencoded"),
]


def test_webhooks_and_input_blockers_match_reference(text):
    def blocker(mod):
        class NoSpam(mod.EventServerPlugin):
            plugin_name = "no-spam"
            plugin_type = mod.INPUT_BLOCKER

            def process(self, event, app_id, channel_id):
                if event.get("event") == "spam":
                    raise ValueError("spam is blocked")

        return NoSpam()

    out = {}
    try:
        p_plugins.register_plugin(blocker(p_plugins))
        r_plugins.register_plugin(blocker(r_plugins))
        with event_servers() as servers:
            for pkg, port in servers.items():
                c = Client(port)
                statuses = []
                for path, body, ctype in WEBHOOKS:
                    s, _, payload = c("POST", f"{path}?accessKey={KEY}",
                                      body, {"Content-Type": ctype})
                    statuses.append((s, s != 201 and payload))
                spam = c("POST", f"/events.json?accessKey={KEY}",
                         rate(9, event="spam"))
                batch = c("POST", f"/batch/events.json?accessKey={KEY}",
                          [rate(1), rate(2, event="spam")])
                c.close()
                out[pkg] = (statuses, spam[0], spam[2], batch[0],
                            [r["status"] for r in batch[2]],
                            batch[2][1]["message"])
    finally:
        p_plugins.clear_plugins()
        r_plugins.clear_plugins()
    assert out["port"] == out["reference"]
    assert out["port"][1:3] == (400, {"message": "spam is blocked"})
    stored = {}
    for pkg, storage in (("port", Storage), ("reference", JaxStorage)):
        app_id = text.ids[pkg][0]
        stored[pkg] = sorted(
            (e.event, e.entity_type, e.entity_id,
             json.dumps(dict(e.properties), sort_keys=True))
            for e in storage.get_levents().find(app_id)
            if e.entity_type == "user" and e.event != "rate")
    assert stored["port"] == stored["reference"]
    assert {s[0] for s in stored["port"]} >= {"signup", "identify",
                                              "subscribe", "view"}


def test_storage_breaker_trips_like_reference(text):
    qos = "fail_window=2,fail_rate=0.5,cooldown=60s,probes=1"
    out = {}
    with event_servers(qos=qos) as servers:
        for pkg, port in servers.items():
            storage = Storage if pkg == "port" else JaxStorage
            levents = storage.get_levents()
            mp = pytest.MonkeyPatch()
            mp.setattr(levents, "insert", lambda *a, **k: (_ for _ in ()
                                                           ).throw(
                RuntimeError("disk gone")))
            try:
                c = Client(port)
                codes = [c("POST", f"/events.json?accessKey={KEY}",
                           rate(k))[0] for k in range(2)]
                shed = c("POST", f"/events.json?accessKey={KEY}", rate(5))
                _, _, qos_json = c("GET", "/qos.json")
                c.close()
            finally:
                mp.undo()
            out[pkg] = (codes, shed[0], int(shed[1]["retry-after"]) > 50,
                        shed[2], qos_json["breakers"]["storage"]["state"],
                        qos_json["shed"]["breaker"])
    assert out["port"] == out["reference"]
    assert out["port"] == ([500, 500], 503, True, {
        "message": "overloaded: storage circuit breaker open"}, "open", 1)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv,flag", [
    (["deploy", "--slo", "p99=50ms"], "--slo"),
    (["deploy", "--slo", "availability=99.9", "--slo", "p99:99"], "--slo"),
    (["deploy", "--qos", "bogus=1"], "--qos"),
    (["eventserver", "--slo", "p99=50ms:150"], "--slo"),
    (["eventserver", "--qos", "rps=-1"], "--qos"),
])
def test_bad_request_plane_spec_exits_1_in_the_port(tmp_path, capsys,
                                                    monkeypatch, argv, flag):
    """Before anything starts: no storage, no engine.json, no server."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        p_cli.main(argv)
    assert exc.value.code == 1
    assert flag in capsys.readouterr().err


def test_good_specs_are_exported(monkeypatch):
    monkeypatch.delenv("PIO_TPU_SLO", raising=False)
    monkeypatch.delenv("PIO_TPU_QOS", raising=False)
    # in a verb's scope, as cli.main runs a verb: exported while it lasts,
    # given back after (a pool the later tests of this process start must
    # not serve under inflight=2)
    with p_cli.verb_scope():
        slos, qos = p_cli._request_plane(argparse.Namespace(
            slo=["p99=50ms:99.9", "availability=99.9"], qos="inflight=2"))
        assert slos == ["p99=50ms:99.9", "availability=99.9"]
        assert os.environ["PIO_TPU_SLO"] == "p99=50ms:99.9,availability=99.9"
        assert os.environ["PIO_TPU_QOS"] == qos == "inflight=2"
    assert "PIO_TPU_SLO" not in os.environ
    assert "PIO_TPU_QOS" not in os.environ
    parser = p_cli.build_parser()
    for verb in ("deploy", "eventserver"):
        args = parser.parse_args([verb, "--slo", "a=1", "--qos", "b=2"])
        assert (args.slo, args.qos) == (["a=1"], "b=2")
    assert parser.parse_args(["deploy", "--feedback-app", "x"]
                             ).feedback_app == "x"


@contextlib.contextmanager
def pooled_query_servers(text, qos, tmp_path):
    """Two pool workers of each package in this process, each bound to
    its stripe of its package's shared metrics segment (as
    ``ServingPool`` binds them): ``{"port": [port0, port1], "reference":
    [...]}``. The log handlers' worker stamps are given back after."""
    from pio_tpu.obs import slog as r_slog
    from pio_tpu.obs.shm import PoolMetricsSegment as RSegment
    from pio_tpu_torch.obs import slog as p_slog
    from pio_tpu_torch.obs.shm import PoolMetricsSegment as PSegment

    stamps = [(m, m.install().worker) for m in (p_slog, r_slog)]
    segs = {"port": PSegment.create(str(tmp_path / "p.shm"), 2),
            "reference": RSegment.create(str(tmp_path / "r.shm"), 2)}
    stack = contextlib.ExitStack()
    ports = {"port": [], "reference": []}
    try:
        for w in range(2):
            servers = stack.enter_context(query_servers(text, qos=qos))
            for name, (port, service) in servers.items():
                service.enable_pool(w, 2, multiprocessing.Value("L", 0),
                                    threading.Event(),
                                    metrics_path=segs[name].path)
                ports[name].append(port)
        yield ports
    finally:
        stack.close()
        for seg in segs.values():
            seg.unlink()
        for mod, worker in stamps:
            mod.install().worker = worker


@pytest.mark.parametrize("qos,admitted", [
    ("rps=0.01,burst=3", 3),
    # the query server's requests carry no access key, so a key budget
    # admits everything, in the reference's pool as in one process
    ("inflight=4,key_rps=0.01,key_burst=1", 12),
])
def test_pool_enforces_one_rate_budget_like_reference(text, tmp_path, qos,
                                                     admitted):
    """Twelve queries spread over the two workers of a pool: the pool
    admits one budget (the burst, not twice it), the same answers and
    statuses as the reference's pool, and either worker's ``/metrics``
    counts the pool's admissions and requests."""
    with pooled_query_servers(text, qos, tmp_path) as ports:
        got = {name: [] for name in ports}
        for name, (p0, p1) in ports.items():
            clients = [Client(p0), Client(p1)]
            for k in range(12):
                status, _, body = post_query(clients[k % 2],
                                             text.queries[k])
                got[name].append((status, body.get("label")))
            scraped = [c("GET", "/metrics")[2] for c in clients]
            for c in clients:
                c.close()
            for body in scraped:
                lines = body.splitlines()
                assert (f'pio_tpu_queries_total{{engine_id="{APP}"}} 12'
                        in lines or 'pio_tpu_queries_total{engine_id=""} '
                        "12" in lines), name
                if admitted < 12:
                    assert ('pio_tpu_qos_admitted_total{scope="queryserver"}'
                            f" {admitted}") in lines
    assert [s for s, _ in got["port"]] == [200] * admitted + [429] * (
        12 - admitted)
    assert got["port"] == got["reference"]


def test_bad_specs_exit_1_in_the_reference(tmp_path):
    """Two processes: the reference's deploy with a bad --slo, and its
    event server with a bad PIO_TPU_QOS (it has no --qos flag)."""
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_TPU_SLO", "PIO_TPU_QOS"))}
    env.update(PIO_TPU_HOME=str(tmp_path), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    runs = [
        (["deploy", "--slo", "p99=50ms"], {}),
        (["eventserver", "--port", "0"], {"PIO_TPU_QOS": "bogus=1"}),
    ]
    for argv, extra in runs:
        proc = subprocess.run(
            [sys.executable, "-m", "pio_tpu.tools.cli", *argv],
            capture_output=True, text=True, timeout=120,
            env={**env, **extra}, cwd=str(tmp_path))
        assert proc.returncode == 1, (argv, proc.stdout, proc.stderr)
        assert "listening" not in proc.stdout
