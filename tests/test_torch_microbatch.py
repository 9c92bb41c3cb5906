"""The port's concurrent serving against the JAX package's, on the CPU.

- 16 threads of ``POST /queries.json`` through the port's server with the
  micro-batcher on (a 20 ms window, adaptive off) give the reference
  server's answers, its batcher on too, over one model (trained by the
  reference, carried across with ``convert.py``): recommendation (the
  same items, scores within 1e-5 relative, black lists that differ
  within a batch), classification (the same labels on the int8 wire) and
  text classification (the reference's predict: the same labels,
  confidences within 1e-5).
- The probe's verdict from injected latencies, and the re-probe lease.
- A poisoned query falls back to its own thread without failing its
  batch-mates (the reference's stub case, both packages; and through the
  port's server, where the poisoned query answers 400).
- The bucket ladder on the service: warmup warms every bucket, the
  steady state never retraces, batched answers equal solo ones and the
  reference service's batched ones, a hot swap evicts and re-warms.

- ``/reload`` under load: 16 threads query a stored classification
  instance with resident scorers while the server swaps generations 5
  times, each swap landing while one dispatch is held mid-flight on the
  outgoing scorer; every answer is 200 and one generation's.
"""

import concurrent.futures
import datetime as dt
import http.client
import json
import threading

import numpy as np
import pytest
import torch

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.data import Event as JaxEvent
from pio_tpu.obs import monotonic_s
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.server import query_server as jqs
from pio_tpu.storage import App as JaxApp
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.templates import textclassification as jtc
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.controller.engine import EngineParams, get_engine_factory
from pio_tpu_torch.convert import (
    als_model_from_reference,
    logreg_model_from_reference,
)
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server import query_server as tqs
from pio_tpu_torch.server.residency import ResidentLinearScorer
from pio_tpu_torch.server.query_server import (
    QueryService,
    create_query_server,
    deploy_query_server,
)
from pio_tpu_torch.templates import classification as TC
from pio_tpu_torch.templates import recommendation as TR
from pio_tpu_torch.templates import textclassification as ttc
from pio_tpu_torch.workflow.core_workflow import (
    load_models_for_instance,
    run_train,
)
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from test_torch_classification import APP, QUERIES, user_rows, variant
from test_torch_similarproduct import (  # noqa: F401  (fixture)
    memory_storage,
    seed_events,
)
from test_torch_textclassification import trained  # noqa: F401  (fixture)

#: a thread's, a request's and a join's time limits, seconds
JOIN_S = 120
HTTP_S = 30


def cls_variant(seed):
    v = variant("logreg")
    v["algorithms"][0]["params"]["seed"] = seed
    return variant_from_dict(v)


def train_cls(seed):
    """A stored logreg instance of the classification template."""
    v = cls_variant(seed)
    engine, ep = build_engine(v)
    return run_train(engine, ep, v, ctx=ComputeContext.create(
        seed=seed, device="cpu"))


def cpu_answers(iid, bodies):
    """What a fresh single-generation CPU service answers for
    ``bodies`` off instance ``iid``."""
    v = cls_variant(0)
    engine, ep = build_engine(v)
    ctx = ComputeContext.create(device="cpu")
    service = QueryService(engine, ep, load_models_for_instance(
        iid, engine, ep, ctx), device="cpu")
    try:
        return [service.query(json.dumps(b).encode()) for b in bodies]
    finally:
        service.close()


def hammer(port, bodies, n_threads, stop, per_thread_min):
    """``n_threads`` keep-alive clients posting ``bodies`` in turn until
    ``stop`` is set (and at least ``per_thread_min`` each); returns the
    threads and the list their (body index, status, answer) land in."""
    got, errors = [], []

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
        try:
            n = 0
            while not stop.is_set() or n < per_thread_min:
                i = (k + n) % len(bodies)
                conn.request("POST", "/queries.json",
                             json.dumps(bodies[i]).encode(),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                got.append((i, r.status, json.loads(r.read())))
                n += 1
        except Exception as e:  # noqa: BLE001 (reported by the test)
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_threads)]
    for t in threads:
        t.start()
    return threads, got, errors


class HeldDispatch:
    """Holds the next resident dispatch after :meth:`arm` inside the
    scorer's host encode, after the dispatch read its generation and
    scorer, until :meth:`release`: a swap then lands under a dispatch in
    flight, every time."""

    def __init__(self, monkeypatch):
        self.armed = False
        self.held = threading.Event()
        self.go = threading.Event()
        real = ResidentLinearScorer.encode

        def encode(sc, X):
            if self.armed:
                self.armed = False
                self.held.set()
                self.go.wait(HTTP_S)
            return real(sc, X)

        monkeypatch.setattr(ResidentLinearScorer, "encode", encode)

    def arm(self):
        self.held.clear()
        self.go.clear()
        self.armed = True

    def release(self):
        self.go.set()


def until(cond, limit_s=HTTP_S):
    deadline = monotonic_s() + limit_s
    while not cond() and monotonic_s() < deadline:
        threading.Event().wait(0.002)
    return cond()


def post_json(port, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
    try:
        conn.request("POST", path, json.dumps(body or {}).encode())
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


@pytest.mark.parametrize("window_us", ["0", "2000"])
def test_reload_under_load_answers_every_query(memory_storage, monkeypatch,
                                               window_us):
    """16 threads query across 5 ``/reload``s, alternating two stored
    instances: every answer is 200 and equal to one generation's CPU
    copy, and every outgoing scorer is retired once its last dispatch is
    done (a scorer retired under a dispatch in flight would answer
    500)."""
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_SERVE_WIRE", "int8")
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_US", window_us)
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE", "0")
    seed_events(user_rows(), app=APP, reference=False)
    iids = [train_cls(1)]
    held = HeldDispatch(monkeypatch)
    server = deploy_query_server(cls_variant(1), host="127.0.0.1", port=0,
                                 device="cpu")
    scorers, reloads = [], []
    with server:
        service = server.service
        stop = threading.Event()
        threads, got, errors = hammer(server.port, QUERIES, 16, stop, 4)
        for k in range(5):
            iids.append(train_cls(2 + k % 2))
            scorers += service._gen.scorers()
            n0 = len(got)
            assert until(lambda: len(got) >= n0 + 32)
            held.arm()
            assert held.held.wait(HTTP_S)
            reload = threading.Thread(target=lambda: reloads.append(
                post_json(server.port, "/reload")), daemon=True)
            reload.start()
            swapped = until(lambda: service.instance_id == iids[-1])
            held.release()
            reload.join(JOIN_S)
            assert swapped and not reload.is_alive()
            assert reloads[-1] == (200, {"engineInstanceId": iids[-1]})
        n0 = len(got)
        assert until(lambda: len(got) >= n0 + 32)
        stop.set()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
        current = service._gen.scorers()
    assert errors == []
    assert [s for _, s, _ in got if s != 200] == []
    want = {iid: cpu_answers(iid, QUERIES) for iid in set(iids)}
    for i, _, answer in got:
        assert any(answer == w[i] for w in want.values()), (i, answer)
    assert len(scorers) == 5 and all(sc.retired for sc in scorers)
    assert all(sc.retired for sc in current)  # close() retired these


@pytest.mark.parametrize("window_us", ["0", "2000"])
def test_one_generation_parses_and_predicts_a_query(memory_storage,
                                                    monkeypatch, window_us):
    """A swap that lands while a query is being parsed does not move its
    dispatch: the generation that parsed and supplemented the query
    predicts it (solo and through the batcher), and is retired only
    after."""
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_US", window_us)
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE", "0")
    seed_events(user_rows(), app=APP, reference=False)
    first = train_cls(1)
    server = deploy_query_server(cls_variant(1), host="127.0.0.1", port=0,
                                 device="cpu")
    with server:
        service = server.service
        gen_a = service._gen
        train_cls(2)
        parse, swapped, used = service._parse_query, threading.Event(), []

        def parse_across_a_swap(body, qc):
            if not swapped.is_set():
                service._load(None)  # the /reload path, mid-parse
                swapped.set()
            return parse(body, qc)

        def note(pairs):
            if swapped.is_set():  # not the load's own ladder warmup
                used.append(pairs)

        run_batch, predict_with = QueryService._run_batch, \
            QueryService._predict_with
        monkeypatch.setattr(service, "_parse_query", parse_across_a_swap)
        monkeypatch.setattr(QueryService, "_run_batch", staticmethod(
            lambda pairs, serving, qs: (note(pairs),
                                        run_batch(pairs, serving, qs))[1]))
        monkeypatch.setattr(QueryService, "_predict_with", staticmethod(
            lambda gen, q: (note(gen.pairs), predict_with(gen, q))[1]))
        got = service.query(json.dumps(QUERIES[0]).encode())
        assert service._gen is not gen_a
        assert used == [gen_a.pairs]
        assert got == cpu_answers(first, QUERIES[:1])[0]
        assert all(sc.retired for sc in gen_a.scorers())


# ------------------------------------------------- parity with the reference
#: a served score against the reference's: one rank-6 f32 dot of O(1)
#: values in another order (~1e-7); the text confidence is a softmax of
#: the same logits (1e-5 as in the text template's tests)
SCORE_RTOL = 1e-5
CONF_ATOL = 1e-5
REC_APP = "mb-rec"
REC_VARIANT = {
    "id": "mb-rec",
    "engineFactory": "templates.recommendation",
    "datasource": {"params": {"app_name": REC_APP}},
    "algorithms": [{"name": "als", "params": {
        "rank": 6, "num_iterations": 8, "lambda_": 0.05, "seed": 1}}],
}
N_USERS, N_ITEMS = 12, 10


@pytest.fixture()
def batching(monkeypatch):
    """The micro-batcher on in both packages: a 20 ms window, so 16
    concurrent clients share batches, and no probe."""
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_US", "20000")
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE", "0")


def concurrent_answers(port, bodies, n_threads=16):
    """``bodies`` posted by ``n_threads`` keep-alive clients at once,
    each its share in turn: ``[(status, answer)]`` in body order."""
    out = [None] * len(bodies)

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
        try:
            for i in range(k, len(bodies), n_threads):
                conn.request("POST", "/queries.json",
                             json.dumps(bodies[i]).encode(),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                out[i] = (r.status, json.loads(r.read()))
        finally:
            conn.close()

    with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
        for f in [ex.submit(client, k) for k in range(n_threads)]:
            f.result(timeout=JOIN_S)
    return out


def get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def reference_answers(variant_dict, bodies):
    """The reference server (JAX package) over its stored instance of
    ``variant_dict``, with the same batching knobs."""
    server, service = jqs.create_query_server(
        jax_variant_from_dict(variant_dict), host="127.0.0.1", port=0)
    server.start()
    try:
        return concurrent_answers(server.port, bodies)
    finally:
        server.stop()
        service._batcher and service._batcher.stop()


def same_top_n(got, want):
    """The same items with scores within SCORE_RTOL; items whose scores
    tie a neighbour's (within the tolerance) may trade places."""
    g, w = got["itemScores"], want["itemScores"]
    assert len(g) == len(w)
    np.testing.assert_allclose([s["score"] for s in g],
                               [s["score"] for s in w], rtol=SCORE_RTOL)
    ws = np.array([s["score"] for s in w])
    apart = np.abs(np.diff(ws)) > SCORE_RTOL * np.abs(ws[1:]) + 1e-7
    for k, s in enumerate(g):
        if (k == 0 or apart[k - 1]) and (k == len(g) - 1 or apart[k]):
            assert s["item"] == w[k]["item"], (k, got, want)
    assert {s["item"] for s in g} == {s["item"] for s in w} or not all(
        apart), (got, want)


def rec_rows(seed=3):
    """Random 1-5 star ratings of 12 users over 10 items (few exact
    score ties in the factors)."""
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    return [(f"u{u}", f"i{i}", float(rng.integers(1, 6)),
             t0 + dt.timedelta(minutes=u * 60 + i))
            for u in range(N_USERS) for i in range(N_ITEMS)
            if rng.random() < 0.8]


def rec_reference():
    """The reference's ALS instance of REC_VARIANT, trained and stored in
    the reference's memory store; returns its model."""
    app = JaxStorage.get_meta_data_apps().insert(JaxApp(0, REC_APP))
    le = JaxStorage.get_levents()
    for u, i, r, t in rec_rows():
        le.insert(JaxEvent("rate", "user", u, "item", i,
                           properties={"rating": r}, event_time=t), app)
    v = jax_variant_from_dict(REC_VARIANT)
    engine, ep = jax_build_engine(v)
    jctx = JaxContext.create(seed=0)
    iid = jax_run_train(engine, ep, v, ctx=jctx)
    return jax_load_models(iid, engine, ep, jctx)[0]


def rec_port_model(ref, device="cpu"):
    return als_model_from_reference({
        "user_factors": ref.factors.user_factors,
        "item_factors": ref.factors.item_factors,
        "user_index": ref.user_index.to_dict(),
        "item_index": ref.item_index.to_dict(),
    }, device=device)


def rec_bodies():
    """Every user at several ``num``s, black lists that differ between
    queries of one batch, an unknown user and a single-item query."""
    bodies = []
    for k in range(48):
        body = {"user": f"u{k % N_USERS}", "num": 2 + k % 5}
        if k % 3 == 1:
            body["blackList"] = [f"i{(k + j) % N_ITEMS}" for j in range(3)]
        bodies.append(body)
    return bodies + [{"user": "stranger", "num": 3},
                     {"user": "u1", "item": "i2"}]


def rec_engine():
    engine = get_engine_factory("templates.recommendation")()
    return engine, EngineParams(algorithm_params_list=(
        ("als", TR.ALSAlgorithmParams(rank=6)),))


def test_recommendation_batched_matches_reference(memory_storage, batching):
    ref = rec_reference()
    bodies = rec_bodies()
    want = reference_answers(REC_VARIANT, bodies)
    engine, ep = rec_engine()
    server = create_query_server(engine, ep, [rec_port_model(ref)], port=0,
                                 device="cpu")
    with server:
        got = concurrent_answers(server.port, bodies)
        _, stats = get_json(server.port, "/stats.json")
    for body, (gs, ga), (ws, wa) in zip(bodies, got, want):
        assert gs == ws == 200, (body, ga, wa)
        if "itemScores" in wa and wa["itemScores"]:
            same_top_n(ga, wa)
        else:
            assert ga == wa, body
    # black-listed items never leak into another row of the batch
    for body, (_, ga) in zip(bodies, got):
        assert not set(body.get("blackList", ())) & {
            s["item"] for s in ga["itemScores"]}
    mb = stats["microbatch"]
    assert mb["mode"] == "on" and mb["maxBatch"] >= 2
    assert mb["batchedQueries"] == len(bodies)
    assert stats["buckets"]["retraces"] == 0
    assert stats["buckets"]["warmed"] == [1, 2, 4, 8, 16, 32]


def test_classification_batched_matches_reference(memory_storage, batching,
                                                  monkeypatch):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_SERVE_WIRE", "int8")
    seed_events(user_rows(), app=APP, port=False)
    v = jax_variant_from_dict(variant("logreg"))
    engine, ep = jax_build_engine(v)
    jctx = JaxContext.create(seed=0)
    iid = jax_run_train(engine, ep, v, ctx=jctx)
    ref = jax_load_models(iid, engine, ep, jctx)[0]
    bodies = QUERIES * 6
    want = reference_answers(variant("logreg"), bodies)
    model = logreg_model_from_reference({
        "weights": ref.lr.weights, "bias": ref.lr.bias,
        "feature_scales": ref.lr.feature_scales,
        "labels": [ref.label_index.inverse[c]
                   for c in range(len(ref.label_index))]})
    engine = get_engine_factory("templates.classification")()
    ep = EngineParams(algorithm_params_list=(("logreg", TC.LogRegParams()),))
    server = create_query_server(engine, ep, [model], port=0, device="cpu")
    with server:
        got = concurrent_answers(server.port, bodies)
        _, stats = get_json(server.port, "/stats.json")
    assert got == want
    assert all(s == 200 for s, _ in got)
    assert stats["microbatch"]["maxBatch"] >= 2
    assert stats["buckets"]["retraces"] == 0
    (entry,) = stats["residency"]["scorers"]
    assert entry["wire"] == "int8" and entry["donation"]["misses"] == 0


def test_text_batched_matches_reference(trained, batching):  # noqa: F811
    algo, ref, port, _, queries = trained
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", ttc.MLPParams()),))
    bodies = [{"text": q} for q in queries] * 3
    with create_query_server(engine, ep, [port], port=0,
                             device="cpu") as server:
        got = concurrent_answers(server.port, bodies)
        _, stats = get_json(server.port, "/stats.json")
    for body, (status, answer) in zip(bodies, got):
        want = algo.predict(ref, jtc.Query(text=body["text"]))
        assert status == 200 and answer["label"] == want.label, body
        assert answer["confidence"] == pytest.approx(want.confidence,
                                                     abs=CONF_ATOL)
    assert stats["microbatch"]["maxBatch"] >= 2
    assert stats["buckets"]["retraces"] == 0


# -------------------------------------------------------- the batcher alone
class StubService:
    """A service whose batch dispatch always fails and whose solo
    predict fails only the query "bad"."""

    def _predict_batch(self, queries, gen=None):
        raise RuntimeError("poisoned batch")

    def _predict_one(self, query, gen=None):
        if query == "bad":
            raise ValueError("bad query")
        return f"ok:{query}"


@pytest.mark.parametrize("package", [tqs, jqs], ids=["port", "reference"])
def test_poisoned_batch_falls_back_per_query(package):
    mb = package._MicroBatcher(StubService(), window_s=0.005)
    try:
        def one(q):
            try:
                return mb.submit(q)
            except ValueError as e:
                return f"err:{e}"

        qs = [f"q{i}" for i in range(8)] + ["bad"]
        with concurrent.futures.ThreadPoolExecutor(9) as ex:
            got = list(ex.map(one, qs, timeout=JOIN_S))
        assert got[:8] == [f"ok:q{i}" for i in range(8)]
        assert got[8] == "err:bad query"
    finally:
        mb.stop()


def test_poisoned_query_answers_400_alone(memory_storage, batching,
                                          monkeypatch):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=APP, reference=False)
    iid = train_cls(1)
    want = cpu_answers(iid, QUERIES)
    bad = {"attrs": [1.0, 2.0]}  # the wrong arity fails its whole batch
    bodies = QUERIES * 2 + [bad]
    server = deploy_query_server(cls_variant(1), host="127.0.0.1", port=0,
                                 device="cpu")
    with server:
        got = concurrent_answers(server.port, bodies, n_threads=len(bodies))
    assert got[:-1] == [(200, w) for w in want * 2]
    assert got[-1][0] == 400 and "model expects 3" in got[-1][1]["message"]


@pytest.mark.parametrize("batch_ms, solo_ms, verdict", [
    (1.0, 2.0, "on"), (2.0, 1.0, "off"), (1.5, 1.5, "on")])
def test_probe_verdict_from_injected_latencies(batch_ms, solo_ms, verdict):
    """Both packages' batchers reach the same verdict from the same
    samples: the first half of each window (one-off transients, here 50
    ms) does not count; an "off" verdict re-probes after its lease."""
    for package in (tqs, jqs):
        mb = package._MicroBatcher(StubService(), window_s=0.001)
        try:
            n = mb.PROBE_QUERIES
            for k in range(n):
                mb._note_probe("batch", 0.05 if k < n // 2 else batch_ms / 1e3)
            assert mb.mode == "probe_solo"
            for k in range(n):
                mb._note_probe("solo", 0.05 if k < n // 2 else solo_ms / 1e3)
            assert mb.mode == verdict and mb.bypassed == (verdict == "off")
            assert mb.active() == (verdict == "on")
            if verdict == "off":
                mb._decided_at -= mb._reprobe_s + 1  # the lease ran out
                assert mb.active() and mb.mode == "probe_batch"
                assert mb.reprobes == 1
        finally:
            mb.stop()


# ------------------------------------------------------ the ladder, in-process
@pytest.fixture()
def ladder(monkeypatch):
    monkeypatch.setenv("PIO_TPU_BATCH_BUCKETS", "1,2,4")
    monkeypatch.setenv("PIO_TPU_BUCKET_WARMUP", "1")


def rec_services():
    """The port's and the reference's services over one stored
    recommendation model each (the port's carried across)."""
    ref = rec_reference()
    jservice = jqs.QueryServerService(jax_variant_from_dict(REC_VARIANT))
    engine, ep = rec_engine()
    return QueryService(engine, ep, [rec_port_model(ref)], device="cpu"), \
        jservice


def test_ladder_warms_and_never_retraces(memory_storage, ladder):
    service, jservice = rec_services()
    try:
        for svc in (service, jservice):
            assert svc._buckets.warmed == {1, 2, 4}
            assert svc._buckets.generation == 1
            assert svc._buckets.retraces == 0
        rng = np.random.default_rng(0)
        for k in range(60):
            n = 1 + k % 6  # 3 pads to 4, 5 and 6 chunk past the ladder
            users = rng.integers(0, N_USERS, n)
            qs = [TR.Query(user=f"u{u}", num=3) for u in users]
            jq = [jservice.query_class(user=f"u{u}", num=3) for u in users]
            got, fresh = service._predict_batch_bucketed(qs)
            want, jfresh = jservice._predict_batch_bucketed(jq)
            assert not fresh and not jfresh and len(got) == n
            for g, w, q in zip(got, want, qs):
                same_top_n(g.to_dict(), w.to_dict())
                same_top_n(g.to_dict(), service._predict_one(q).to_dict())
        assert service._buckets.retraces == jservice._buckets.retraces == 0
        assert set(service.stats()["buckets"]["dispatches"]) == {"1", "2", "4"}
    finally:
        service.close()
        jservice._batcher and jservice._batcher.stop()


def test_hot_swap_evicts_and_rewarms(memory_storage, ladder, monkeypatch):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=APP, reference=False)
    train_cls(1)
    server = deploy_query_server(cls_variant(1), host="127.0.0.1", port=0,
                                 device="cpu")
    service = server.service
    try:
        (old,) = service._gen.scorers()
        gen0 = service._buckets.generation
        assert service._buckets.warmed == {1, 2, 4}
        train_cls(2)
        service._load(None)  # the /reload path
        assert service._buckets.generation == gen0 + 1
        assert service._buckets.evictions == 3
        assert service._buckets.warmed == {1, 2, 4}
        assert old.retired and not service._gen.scorers()[0].retired
    finally:
        server.close()


def test_reload_of_models_in_memory_answers_400(memory_storage):
    seed_events(user_rows(), app=APP, reference=False)
    iid = train_cls(1)
    v = cls_variant(1)
    engine, ep = build_engine(v)
    models = load_models_for_instance(iid, engine, ep,
                                      ComputeContext.create(device="cpu"))
    with create_query_server(engine, ep, models, port=0,
                             device="cpu") as server:
        status, out = post_json(server.port, "/reload")
        assert status == 400 and "in memory" in out["message"]
        assert get_json(server.port, "/healthz")[0] == 200
        assert get_json(server.port, "/readyz")[0] == 200


@pytest.mark.cuda
def test_batched_answers_on_the_card_equal_the_cpu(memory_storage,
                                                   batching):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ref = rec_reference()
    bodies = rec_bodies()
    engine, ep = rec_engine()
    answers = []
    for device in ("cuda", "cpu"):
        with create_query_server(engine, ep, [rec_port_model(ref, device)],
                                 port=0, device=device) as server:
            answers.append(concurrent_answers(server.port, bodies))
    for (gs, ga), (ws, wa) in zip(*answers):
        assert gs == ws == 200
        if "itemScores" in wa and wa["itemScores"]:
            same_top_n(ga, wa)
        else:
            assert ga == wa
