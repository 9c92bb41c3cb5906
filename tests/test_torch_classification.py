"""The classification template and the resident linear scorer in the port
against the JAX package's, on the CPU, in memory storage.

- ``ResidentLinearScorer`` against the reference's (both forced on with
  ``PIO_TPU_DEVICE_RESIDENT=1``): the same codes on both wires, the exact
  h2d bytes of each, hit and miss accounting, retirement, the int8 round
  trip, shape checks; two threads on one bucket never share a tensor.
- The template end to end: ``$set`` users made as the reference's
  benchmark makes them (``bench.py`` ``_bench_resident``: three plans,
  each with a hot attribute), ``run_train`` of ``naivebayes`` and
  ``logreg`` (the latter from the reference's init), the query server
  with the scorers placed, ``POST /queries.json`` on both wires: the
  reference's engine, trained on the same events and serving through its
  own resident scorer on the same wire, gives the same labels. Also
  ``GET /stats.json``, a placement that fails, pickling a model that
  carries a scorer, ``batch_predict`` against the loop, the ``attr0..2``
  query fields and a query of the wrong arity.
- ``classification_evaluation`` against the reference's sweep: the same
  best smoothing and the same accuracies.
- The converters: a model of the reference and its copy give the same
  codes.
"""

import dataclasses
import datetime as dt
import http.client
import json
import threading

import numpy as np
import pytest
import torch

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.server import residency as jres
from pio_tpu.templates import classification as JC
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import run_evaluation as jax_run_evaluation
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.controller.params import params_from_dict
from pio_tpu_torch.convert import (
    logreg_model_from_reference,
    nb_classifier_from_reference,
)
from pio_tpu_torch.models import logreg as T
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server import residency
from pio_tpu_torch.server.query_server import (
    QueryService,
    create_query_server,
)
from pio_tpu_torch.server.residency import OutputBuffer, ResidentLinearScorer
from pio_tpu_torch.templates import classification as TC
from pio_tpu_torch.workflow.core_workflow import (
    deserialize_models,
    load_models_for_instance,
    run_evaluation,
    run_train,
    serialize_models,
)
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from test_torch_logreg import reference_init
from test_torch_similarproduct import (  # noqa: F401  (fixture)
    T0,
    memory_storage,
    seed_events,
)

APP = "cls-test"
PLANS = ("basic", "premium", "pro")
ALGOS = {
    "naivebayes": {"name": "naivebayes", "params": {"lambda_": 1.0}},
    "logreg": {"name": "logreg",
               "params": {"iterations": 30, "learning_rate": 0.1}},
}


def variant(algo):
    return {"id": f"cls-{algo}", "engineFactory": "templates.classification",
            "datasource": {"params": {"app_name": APP}},
            "algorithms": [ALGOS[algo]]}


def user_rows(per_plan=8, hot_boost=6, seed=7):
    """The reference benchmark's users (``bench.py`` l.489-503): three
    plans, each user's three attributes in 0-2 with the plan's own
    attribute raised by ``hot_boost``."""
    rng = np.random.default_rng(seed)
    rows, n = [], 0
    for plan, hot in zip(PLANS, range(3)):
        for _ in range(per_plan):
            attrs = rng.integers(0, 3, size=3)
            attrs[hot] += hot_boost
            props = {f"attr{j}": int(attrs[j]) for j in range(3)}
            props["plan"] = plan
            rows.append(("$set", "user", f"u{n:03d}", None, props,
                         T0 + dt.timedelta(minutes=n)))
            n += 1
    return rows


#: queries: each plan's profile, in-between points and far-off ones
QUERIES = [
    {"attr0": 8, "attr1": 1, "attr2": 0}, {"attr0": 0, "attr1": 7,
                                           "attr2": 2},
    {"attr0": 1, "attr1": 1, "attr2": 8}, {"attr0": 4, "attr1": 4,
                                           "attr2": 0},
    {"attrs": [0.5, 2.0, 5.5]}, {"attrs": [12.0, 0.0, 0.0]},
    {"attr0": 0, "attr1": 0, "attr2": 0}, {"attrs": [3.0, 3.1, 2.9]},
]


@pytest.fixture()
def reference_logreg_init(monkeypatch):
    """The port's logreg starts from the reference's initial weights."""
    monkeypatch.setattr(T, "init_params", lambda d, c, seed: {
        k: torch.from_numpy(v) for k, v in reference_init(seed, d, c).items()})


def train_port(algo, device="cpu"):
    v = variant_from_dict(variant(algo))
    engine, ep = build_engine(v)
    ctx = ComputeContext.create(seed=0, device=device)
    iid = run_train(engine, ep, v, ctx=ctx)
    return engine, ep, load_models_for_instance(iid, engine, ep, ctx)


def train_reference(algo):
    v = jax_variant_from_dict(variant(algo))
    engine, ep = jax_build_engine(v)
    jctx = JaxContext.create(seed=0)
    iid = jax_run_train(engine, ep, v, ctx=jctx)
    return engine, ep, jax_load_models(iid, engine, ep, jctx)


def post(conn, body, path="/queries.json"):
    conn.request("POST", path, json.dumps(body).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def get(conn, path):
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


# ------------------------------------------------------------ gating
def test_gating(monkeypatch):
    monkeypatch.delenv("PIO_TPU_DEVICE_RESIDENT", raising=False)
    assert residency.enabled("cpu") is False
    assert residency.enabled("cuda") is True
    assert residency.enabled(None) is torch.cuda.is_available()
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    assert residency.enabled("cpu") is True
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "0")
    assert residency.enabled("cuda") is False


@pytest.mark.parametrize("knob,scales,want", [
    (None, True, "int8"), (None, False, "float32"),
    ("float32", True, "float32"), ("int8", True, "int8"),
    ("int8", False, "float32"),
])
def test_wire_mode_matches_reference(monkeypatch, knob, scales, want):
    if knob is None:
        monkeypatch.delenv("PIO_TPU_SERVE_WIRE", raising=False)
    else:
        monkeypatch.setenv("PIO_TPU_SERVE_WIRE", knob)
    assert residency.wire_mode(scales) == jres.wire_mode(scales) == want


def test_output_buffer_is_one_shot():
    buf = torch.zeros(2, 3)
    g = OutputBuffer(buf)
    assert g.take() is buf
    with pytest.raises(RuntimeError, match="re-used"):
        g.take()


# ------------------------------------------------------------ the scorer
def scorers(monkeypatch, wire=None, d=8, c=4, seed=3):
    """The port's scorer on the CPU and the reference's, on the same
    seeded weights, bias and scales."""
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    if wire is None:
        monkeypatch.delenv("PIO_TPU_SERVE_WIRE", raising=False)
    else:
        monkeypatch.setenv("PIO_TPU_SERVE_WIRE", wire)
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, c)).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    s = (np.abs(rng.normal(size=d)) / 127.0 + 1e-3).astype(np.float32)
    port = ResidentLinearScorer(W, b, scales=s, name="t", device="cpu")
    ref = jres.ResidentLinearScorer(W, b, scales=s, name="t")
    return port, ref, W, b


def features(sc, n=64, d=8, seed=9):
    rng = np.random.default_rng(seed)
    # on the scales' dynamic range (|x| <= 127·s)
    return (rng.normal(size=(n, d)) * sc.scales * 40).astype(np.float32)


@pytest.mark.parametrize("wire", ["int8", "float32"])
def test_scorer_codes_match_reference(monkeypatch, wire):
    port, ref, W, b = scorers(monkeypatch, wire)
    assert port.wire == ref.wire == wire
    X = features(port)
    np.testing.assert_array_equal(port.encode(X), ref.encode(X))
    got = port.score_codes(X)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.score_codes(X))
    if wire == "float32":
        np.testing.assert_array_equal(got, np.argmax(X @ W + b, axis=1))


def test_scorer_h2d_bytes_exact_per_wire(monkeypatch):
    X = np.ones((4, 8), np.float32)
    for wire, per in (("int8", 1), ("float32", 4)):
        port, ref, _, _ = scorers(monkeypatch, wire)
        port.score_codes(X)
        ref.score_codes(X)
        assert port.h2d_bytes == ref.h2d_bytes == 4 * 8 * per


def test_scorer_hit_miss_accounting(monkeypatch):
    port, ref, _, _ = scorers(monkeypatch)
    seen = []
    port.bind(on_h2d=lambda n: seen.append(n), on_dispatch=seen.append)
    for sc in (port, ref):
        sc.prealloc([1, 2])
        for _ in range(5):
            sc.score_codes(np.ones((2, 8), np.float32))
        sc.score_codes(np.ones((3, 8), np.float32))  # a cold size
        sc.score_codes(np.ones((3, 8), np.float32))  # now standing
    assert (port.hits, port.misses) == (ref.donation_hits,
                                        ref.donation_misses) == (6, 1)
    assert port.dispatches == ref.dispatches == 7
    got, want = port.to_dict(), ref.to_dict()
    assert got["donation"]["hitRate"] == want["donation"]["hitRate"]
    assert got["donation"]["backendReclaims"] == 0
    for key in ("name", "wire", "inDim", "nClasses", "paramBytes", "sharded",
                "retired", "dispatches", "h2dBytes"):
        assert got[key] == want[key], key
    assert seen.count("hit") == 6 and seen.count("miss") == 1
    assert sum(x for x in seen if isinstance(x, int)) == port.h2d_bytes


def test_retired_scorer_refuses(monkeypatch):
    port, _, _, _ = scorers(monkeypatch)
    port.retire()
    with pytest.raises(RuntimeError, match="retired"):
        port.score_codes(np.ones((1, 8), np.float32))


def test_retired_mid_dispatch_refuses(monkeypatch):
    port, _, _, _ = scorers(monkeypatch)
    real = np.ascontiguousarray

    def retire_while_encoding(a, *args, **kw):
        port.retired = True  # lands after the first check
        return real(a, *args, **kw)

    monkeypatch.setattr(residency.np, "ascontiguousarray",
                        retire_while_encoding)
    with pytest.raises(RuntimeError, match="mid-dispatch"):
        port.score_wire(np.ones((1, 8), np.int8))


def test_quantize_round_trip_exact(monkeypatch):
    port, ref, _, _ = scorers(monkeypatch, d=16, seed=7)
    X = features(port, n=32, d=16, seed=11) * 1.25
    codes = port.quantize(X)
    np.testing.assert_array_equal(codes, ref.quantize(X))
    np.testing.assert_array_equal(port.quantize(port.dequantize(codes)),
                                  codes)
    no_scales = ResidentLinearScorer(np.ones((2, 2)), np.zeros(2),
                                     device="cpu")
    assert no_scales.wire == "float32"
    with pytest.raises(ValueError, match="no feature scales"):
        no_scales.quantize(np.ones((1, 2)))


def test_wrong_shapes_raise(monkeypatch):
    port, _, _, _ = scorers(monkeypatch)
    with pytest.raises(ValueError, match="wire batch"):
        port.score_wire(np.zeros((2, 5), np.int8))
    with pytest.raises(ValueError, match="weights"):
        ResidentLinearScorer(np.ones((3, 2)), np.zeros(3), device="cpu")


def test_concurrent_dispatches_never_share_a_tensor(monkeypatch):
    """Many threads on one bucket: every dispatch writes a tensor no other
    dispatch holds at the same time, and every answer is right."""
    port, _, W, b = scorers(monkeypatch, "float32")
    port.prealloc([4])
    held, clash, errors = set(), [], []
    lock = threading.Lock()
    real_addmm = torch.addmm

    def watched_addmm(bias, x, w, out):
        with lock:
            if out.data_ptr() in held:
                clash.append(out.data_ptr())
            held.add(out.data_ptr())
        try:
            return real_addmm(bias, x, w, out=out)
        finally:
            with lock:
                held.discard(out.data_ptr())

    monkeypatch.setattr(residency.torch, "addmm", watched_addmm)
    X = features(port, n=4)
    want = np.argmax(X @ W + b, axis=1)

    def worker():
        try:
            for _ in range(40):
                np.testing.assert_array_equal(port.score_codes(X), want)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and clash == []
    assert port.dispatches == 320 and port.hits + port.misses == 320
    assert port.hits >= 1


# ------------------------------------------------------ template end to end
@pytest.mark.parametrize("algo", ["naivebayes", "logreg"])
@pytest.mark.parametrize("wire", ["int8", "float32"])
def test_queries_json_match_reference(memory_storage, monkeypatch,
                                      reference_logreg_init, algo, wire):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_SERVE_WIRE", wire)
    seed_events(user_rows(), app=APP)
    engine, ep, models = train_port(algo)
    jengine, jep, jmodels = train_reference(algo)
    ((jalgo, jmodel),) = jengine.algorithms_with_models(jep, jmodels)
    jmodel._resident = jalgo.resident_scorer(jmodel)
    assert jmodel._resident.wire == wire
    server = create_query_server(engine, ep, models, port=0, device="cpu")
    with server:
        scorer = models[0]._resident
        assert scorer.wire == wire and scorer.device.type == "cpu"
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        for body in QUERIES:
            status, got = post(conn, body)
            assert status == 200, got
            want = jalgo.predict(jmodel, params_from_dict(JC.Query, body))
            assert got == want.to_dict(), body
        status, stats = get(conn, "/stats.json")
        conn.close()
    assert status == 200
    block = stats["residency"]
    assert block["enabled"] is True and block["measuredBytes"] is None
    (entry,) = block["scorers"]
    assert entry["name"] == algo and entry["wire"] == wire
    assert entry["dispatches"] == len(QUERIES)
    assert entry["donation"]["hits"] == len(QUERIES)  # bucket 1 standing
    assert entry["h2dBytes"] == len(QUERIES) * 3 * (1 if wire == "int8"
                                                     else 4)
    assert block["paramBytes"] == entry["paramBytes"] == (3 * 3 + 3) * 4
    assert block["totals"] == {"h2dBytes": entry["h2dBytes"],
                               "hit": len(QUERIES), "miss": 0}
    # close() retired the scorer and took it off the model
    assert scorer.retired and "_resident" not in vars(models[0])


@pytest.mark.parametrize("algo", ["naivebayes", "logreg"])
def test_models_match_reference(memory_storage, reference_logreg_init, algo):
    """The trained arrays: NB within 1e-6, logreg (30 f32 Adam steps from
    the reference's init) within 1e-5 of the largest weight."""
    seed_events(user_rows(), app=APP)
    _, _, (got,) = train_port(algo)
    _, _, (want,) = train_reference(algo)
    assert got.label_index.to_dict() == want.label_index.to_dict()
    assert got.dim == want.dim == 3
    if algo == "naivebayes":
        np.testing.assert_allclose(got.nb.log_theta, want.nb.log_theta,
                                   atol=1e-6)
        np.testing.assert_allclose(got.nb.log_prior, want.nb.log_prior,
                                   atol=1e-6)
        scales = (got.nb.feature_scales, want.nb.feature_scales)
    else:
        tol = 1e-5 * max(1.0, float(np.abs(want.lr.weights).max()))
        np.testing.assert_allclose(got.lr.weights, want.lr.weights, atol=tol)
        np.testing.assert_allclose(got.lr.bias, want.lr.bias, atol=tol)
        scales = (got.lr.feature_scales, want.lr.feature_scales)
    np.testing.assert_array_equal(*scales)


def test_query_fields_and_arity(memory_storage, monkeypatch):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=APP, reference=False)
    engine, ep, models = train_port("naivebayes")
    server = create_query_server(engine, ep, models, port=0, device="cpu")
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        _, by_fields = post(conn, {"attr0": 1, "attr1": 8, "attr2": 0})
        _, by_attrs = post(conn, {"attrs": [1, 8, 0]})
        assert by_fields == by_attrs == {"label": "premium"}
        for bad in ({"attr0": 1, "attr1": 2}, {"attrs": [1, 2, 3, 4]}, {}):
            status, got = post(conn, bad)
            assert status == 400 and "attrs" in got["message"], bad
        status, got = post(conn, {"attr9": 1})
        assert status == 400
        assert get(conn, "/nowhere")[0] == 404
        conn.close()


def test_residency_auto_stays_off_on_the_cpu(memory_storage, monkeypatch):
    monkeypatch.delenv("PIO_TPU_DEVICE_RESIDENT", raising=False)
    seed_events(user_rows(), app=APP, reference=False)
    engine, ep, models = train_port("logreg")
    service = QueryService(engine, ep, models, device="cpu")
    assert "_resident" not in vars(models[0])
    assert service.stats()["residency"] == {
        "enabled": False, "paramBytes": 0, "measuredBytes": None,
        "scorers": [], "totals": {"h2dBytes": 0, "hit": 0, "miss": 0}}
    assert service.query(b'{"attrs": [9, 0, 1]}') == {"label": "basic"}


def test_placement_failure_raises(memory_storage, monkeypatch):
    """A scorer that cannot be built fails the service; scorers placed
    before it are retired and taken off their models."""
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=APP, reference=False)
    engine, ep, models = train_port("naivebayes")
    placed = []
    real = TC.NaiveBayesAlgorithm.resident_scorer

    def flaky(self, model, device):
        if placed:
            raise RuntimeError("cannot place")
        placed.append(real(self, model, device))
        return placed[-1]

    monkeypatch.setattr(TC.NaiveBayesAlgorithm, "resident_scorer", flaky)
    ep2 = dataclasses.replace(
        ep, algorithm_params_list=ep.algorithm_params_list * 2)
    with pytest.raises(RuntimeError, match="cannot place"):
        QueryService(engine, ep2, models * 2, device="cpu")
    assert placed[0].retired and "_resident" not in vars(models[0])


def test_model_with_scorer_pickles(memory_storage, monkeypatch):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=APP, reference=False)
    engine, ep, models = train_port("logreg")
    service = QueryService(engine, ep, models, device="cpu")
    assert isinstance(models[0]._resident, ResidentLinearScorer)
    (back,) = deserialize_models(serialize_models(models))
    assert "_resident" not in vars(back)
    assert "_resident" in vars(models[0])  # the live model keeps it
    np.testing.assert_array_equal(back.lr.weights, models[0].lr.weights)
    algo = TC.LogisticRegressionAlgorithm()
    q = TC.Query(attrs=(0.0, 9.0, 1.0))
    assert algo.predict(back, q) == algo.predict(models[0], q)
    service.close()


@pytest.mark.parametrize("algo", ["naivebayes", "logreg"])
def test_batch_predict_equals_loop(memory_storage, monkeypatch, algo):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=APP, reference=False)
    engine, ep, models = train_port(algo)
    rng = np.random.default_rng(5)
    qs = [(k, TC.Query(attrs=tuple(float(v) for v in rng.integers(0, 9, 3))))
          for k in range(50)]
    algo_obj = engine._algorithms(ep)[0]
    host = dict(algo_obj.batch_predict(models[0], qs))
    service = QueryService(engine, ep, models, device="cpu")
    resident = dict(algo_obj.batch_predict(models[0], qs))
    loop = {k: algo_obj.predict(models[0], q) for k, q in qs}
    service.close()
    assert resident == loop
    assert sum(host[k] == loop[k] for k, _ in qs) >= 49  # int8 wire
    assert models[0].__dict__.get("_resident") is None
    with pytest.raises(ValueError, match="model expects 3"):
        algo_obj.batch_predict(models[0], qs[:2] + [(99, TC.Query(
            attrs=(1.0,)))])
    assert algo_obj.batch_predict(models[0], []) == []


def test_empty_app_fails_sanity(memory_storage):
    seed_events([], app=APP, reference=False)
    with pytest.raises(ValueError, match="TrainingData is empty"):
        train_port("naivebayes")


# ------------------------------------------------------------- evaluation
def test_read_eval_folds_match_reference(memory_storage):
    seed_events(user_rows(per_plan=5), app=APP)
    got = TC.ClassificationDataSource(TC.DataSourceParams(
        app_name=APP, eval_k=3)).read_eval(ComputeContext.local(device="cpu"))
    want = JC.ClassificationDataSource(JC.DataSourceParams(
        app_name=APP, eval_k=3)).read_eval(JaxContext.local())
    assert len(got) == len(want) == 3
    for (td, info, qa), (jtd, jinfo, jqa) in zip(got, want):
        assert info == jinfo
        np.testing.assert_array_equal(td.features, jtd.features)
        assert list(td.labels) == list(jtd.labels)
        assert [(q.attrs, a) for q, a in qa] == [(q.attrs, a) for q, a in jqa]


def test_classification_evaluation_matches_reference(memory_storage):
    """A noisy profile (hot attribute +2 over 0-2) so that the smoothing
    points score apart."""
    seed_events(user_rows(per_plan=20, hot_boost=2, seed=3), app=APP)
    ev = TC.classification_evaluation(APP, eval_k=3, lambdas=(0.1, 1.0, 50.0))
    jev = JC.classification_evaluation(APP, eval_k=3,
                                       lambdas=(0.1, 1.0, 50.0))
    got = run_evaluation(ev, ev.engine_params_generator,
                         ctx=ComputeContext.create(device="cpu"))
    want = jax_run_evaluation(jev, jev.engine_params_generator,
                              ctx=JaxContext.create())
    got_s = [s.score for s in got.engine_params_scores]
    want_s = [s.score for s in want.engine_params_scores]
    np.testing.assert_allclose(got_s, want_s, atol=1e-6)
    assert got.best_index == want.best_index
    assert len(set(got_s)) > 1, got_s
    assert got.metric_header == want.metric_header
    with pytest.raises(ValueError, match="eval_k >= 2"):
        TC.classification_evaluation(APP, eval_k=1)


# ------------------------------------------------------------- converters
def test_converters_give_the_reference_codes(memory_storage, monkeypatch):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=APP, reference=True, port=False)
    X = np.random.default_rng(4).uniform(0, 9, size=(40, 3)).astype(
        np.float32)
    for algo in ("naivebayes", "logreg"):
        jengine, jep, (ref,) = train_reference(algo)
        labels = [ref.label_index.inverse[c]
                  for c in range(len(ref.label_index))]
        if algo == "naivebayes":
            port = nb_classifier_from_reference({
                "log_prior": ref.nb.log_prior, "log_theta": ref.nb.log_theta,
                "feature_scales": ref.nb.feature_scales, "labels": labels})
            got, want = port.nb.predict(X), ref.nb.predict(X)
        else:
            port = logreg_model_from_reference({
                "weights": ref.lr.weights, "bias": ref.lr.bias,
                "feature_scales": ref.lr.feature_scales, "labels": labels})
            got, want = port.lr.predict(X), ref.lr.predict(X)
        np.testing.assert_array_equal(got, want)
        sc = TC.classification_engine().algorithm_class_map[algo]() \
            .resident_scorer(port, torch.device("cpu"))
        jalgo = jengine.algorithm_class_map[algo]()
        np.testing.assert_array_equal(
            sc.score_codes(X), jalgo.resident_scorer(ref).score_codes(X))
    with pytest.raises(ValueError, match="labels"):
        logreg_model_from_reference({"weights": np.ones((3, 2)),
                                     "bias": np.zeros(2), "labels": ["a"]})
    with pytest.raises(ValueError, match="feature_scales"):
        nb_classifier_from_reference({
            "log_prior": np.zeros(2), "log_theta": np.zeros((2, 3)),
            "feature_scales": np.ones(2), "labels": ["a", "b"]})


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "float32"])
def test_card_scorer_matches_cpu(monkeypatch, wire):
    """The scorer on the card against the same scorer on the CPU: the same
    codes (f32 products in another order, on features far from ties)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port, _, W, b = scorers(monkeypatch, wire)
    card = ResidentLinearScorer(W, b, scales=port.scales, device="cuda")
    assert card._w_dev.is_cuda
    X = features(port, n=512)
    np.testing.assert_array_equal(card.score_codes(X), port.score_codes(X))
