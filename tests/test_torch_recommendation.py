"""The recommendation template in the port against the JAX package's, on
the CPU, in memory storage.

- The host pieces it reads through (``BiMap.string_int_by_frequency``,
  ``EventFrame``, ``find_frame``, the k-fold helpers) are copies: equal
  results.
- The lifecycle of ``tests/test_recommendation_e2e.py`` runs on the port:
  ingest → ``run_train`` → ``load_models_for_instance`` → top-N, batch
  against loop, and the k-fold ``read_eval``.
- A model trained by the JAX package, carried across with
  ``als_model_from_reference``, gives the reference scorer's top-N for
  every user: the same float32 factors scored in another summation order
  (a rank-6 dot), so the same items in the same order wherever two scores
  are more than 1e-5 apart, and scores within ``rtol = 1e-5``.
- ``POST /queries.json`` through the port's query server, a JSON
  ``blackList`` array binding to the query's tuple.
"""

import datetime as dt
import http.client
import json

import numpy as np
import pytest
import torch

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.data import Event as JaxEvent
from pio_tpu.data.bimap import BiMap as JaxBiMap
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.storage import App as JaxApp
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.templates import common as jax_common
from pio_tpu.templates.recommendation import ALSAlgorithm as JaxALS
from pio_tpu.templates.recommendation import Query as JaxQuery
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.controller.params import params_from_dict
from pio_tpu_torch.convert import als_model_from_reference
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.query_server import create_query_server
from pio_tpu_torch.storage.frame import EventFrame
from pio_tpu_torch.storage.records import App, RunStatus
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates import common
from pio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSModel,
    PredictedResult,
    Query,
    RecommendationDataSource,
)
from pio_tpu_torch.workflow.core_workflow import (
    deserialize_models,
    load_models_for_instance,
    run_train,
    serialize_models,
)
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict

T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)

VARIANT = {
    "id": "rec-e2e",
    "engineFactory": "templates.recommendation",
    "datasource": {"params": {"app_name": "rec-test"}},
    "algorithms": [
        {
            "name": "als",
            "params": {"rank": 6, "num_iterations": 10, "lambda_": 0.05,
                       "seed": 1},
        }
    ],
}


@pytest.fixture()
def memory_storage(tmp_home, monkeypatch):
    """Both packages' storage in memory, empty."""
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    Storage.reset()
    JaxStorage.reset()
    yield
    Storage.reset()
    JaxStorage.reset()


def _event_rows(n_users=12, n_items=8):
    """Block structure: users u0..5 love items i0..3; u6..11 love i4..7;
    one buy event (an implicit 4.0) and one unrelated event type."""
    rows = []
    for u in range(n_users):
        for i in range(n_items):
            rating = 5.0 if (u < 6) == (i < 4) else 1.0
            rows.append(("rate", f"u{u}", f"i{i}", {"rating": rating},
                         T0 + dt.timedelta(minutes=u * 60 + i)))
    rows.append(("buy", "u0", "i3", {}, T0))
    rows.append(("view", "u0", "i7", {}, T0))
    return rows


def _seed(app_id, event_cls, levents, rows):
    for name, u, i, props, t in rows:
        levents.insert(
            event_cls(name, "user", u, "item", i, properties=props,
                      event_time=t),
            app_id,
        )


def _seed_port(app_name="rec-test"):
    app_id = Storage.get_meta_data_apps().insert(App(0, app_name))
    _seed(app_id, Event, Storage.get_levents(), _event_rows())
    return app_id


def _train_port(variant_dict=VARIANT):
    variant = variant_from_dict(variant_dict)
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(seed=0, device="cpu")
    iid = run_train(engine, ep, variant, ctx=ctx)
    return engine, ep, ctx, iid


# ------------------------------------------------------- host pieces: equal
@pytest.mark.parametrize("keys", [
    ["b", "a", "b", "c", "a", "b"],
    ["x", "y", "z"],  # all tied: lexicographic
    ["i2", "i10", "i2", "i10", "i1"],
    [],
])
def test_string_int_by_frequency_matches_reference(keys):
    assert BiMap.string_int_by_frequency(keys).to_dict() == \
        JaxBiMap.string_int_by_frequency(keys).to_dict()


def test_event_frame_matches_reference(memory_storage):
    app_id = _seed_port()
    jax_app = JaxStorage.get_meta_data_apps().insert(JaxApp(0, "rec-test"))
    _seed(jax_app, JaxEvent, JaxStorage.get_levents(), _event_rows())
    filters = dict(event_names=["rate", "buy"], entity_type="user",
                   target_entity_type="item")
    got = Storage.get_pevents().find_frame(app_id, **filters)
    want = JaxStorage.get_pevents().find_frame(jax_app, **filters)
    assert isinstance(got, EventFrame) and len(got) == len(want) == 97
    for col in ("event", "entity_type", "entity_id", "target_entity_type",
                "target_entity_id", "event_time_us"):
        assert np.array_equal(getattr(got, col), getattr(want, col)), col
    assert got.properties == want.properties
    np.testing.assert_array_equal(got.property_column("rating"),
                                  want.property_column("rating"))
    g_index, g_codes = got.codes("entity_id")
    w_index, w_codes = want.codes("entity_id")
    assert g_index.to_dict() == w_index.to_dict()
    assert np.array_equal(g_codes, w_codes)
    _, unseen = got.codes("entity_id", BiMap({"u3": 0}))
    assert set(unseen.tolist()) == {-1, 0}


def test_fold_helpers_match_reference():
    assert np.array_equal(common.fold_assignments(50, 3),
                          jax_common.fold_assignments(50, 3))
    a = ["u1", "u2", "u1", "u1", "u3"]
    b = ["i1", "i1", "i1", "i2", "i1"]
    assert np.array_equal(common.dedup_pair_indices(a, b),
                          jax_common.dedup_pair_indices(a, b))
    mq = lambda u, bl: (u, bl)  # noqa: E731
    args = (["u1", "u1", "u2"], ["i1", "i2", "i1"], ["u1", "u2", "u9"],
            ["i3", "i2", "i1"])
    assert common.seen_exclusion_holdout(*args, mq) == \
        jax_common.seen_exclusion_holdout(*args, mq)


def test_query_binds_a_json_black_list_to_a_tuple():
    q = params_from_dict(Query, json.loads(
        '{"user": "u1", "num": 3, "blackList": ["i1", "i2"]}'))
    assert q.black_list == ("i1", "i2") and isinstance(q.black_list, tuple)
    assert hash(q) == hash(Query(user="u1", num=3, black_list=("i1", "i2")))


# -------------------------------- the lifecycle of test_recommendation_e2e
def test_full_lifecycle(memory_storage):
    _seed_port()
    engine, ep, ctx, iid = _train_port()
    inst = Storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == RunStatus.COMPLETED
    assert inst.env["device"] == "cpu"
    assert "phase_train:0_als" in inst.env

    models = load_models_for_instance(iid, engine, ep, ctx)
    model = models[0]
    assert isinstance(model, ALSModel)
    assert model.factors.user_factors.device == torch.device("cpu")
    serving = engine.make_serving(ep)
    pairs = engine.algorithms_with_models(ep, models)

    def query(user, num=4, **kw):
        q = Query(user=user, num=num, **kw)
        return serving.serve(q, [algo.predict(m, q) for algo, m in pairs])

    res = query("u0")
    assert isinstance(res, PredictedResult)
    assert {s.item for s in res.item_scores} == {"i0", "i1", "i2", "i3"}
    scores = [s.score for s in res.item_scores]
    assert scores == sorted(scores, reverse=True)
    assert {s.item for s in query("u11").item_scores} == \
        {"i4", "i5", "i6", "i7"}
    assert query("stranger") == PredictedResult()
    assert json.loads(json.dumps(res.to_dict()))["itemScores"][0]["item"]
    # black_list masks items before the top-k; an exhausted catalog
    # serves only the finite scores
    bl = [s.item for s in query("u0", black_list=("i0", "i1")).item_scores]
    assert len(bl) == 4 and set(bl[:2]) == {"i2", "i3"}
    assert not {"i0", "i1"} & set(bl)
    every = tuple(f"i{i}" for i in range(7))
    assert [s.item for s in query("u0", num=4, black_list=every).item_scores] \
        == ["i7"]
    # single-item score is the pair dot
    one = query("u0", item="i2").item_scores
    assert len(one) == 1 and one[0].item == "i2"


def test_empty_app_fails_sanity(memory_storage):
    Storage.get_meta_data_apps().insert(App(0, "rec-test"))
    variant = variant_from_dict(VARIANT)
    engine, ep = build_engine(variant)
    with pytest.raises(ValueError, match="TrainingData is empty"):
        run_train(engine, ep, variant,
                  ctx=ComputeContext.local(device="cpu"))
    insts = Storage.get_meta_data_engine_instances().get_all()
    assert insts[0].status == RunStatus.FAILED


@pytest.mark.parametrize("mode", ["rating", "hitrate"])
def test_read_eval_folds(memory_storage, mode):
    """The k-fold read_eval, each fold trained and queried through the
    algorithm (Engine.eval itself: test_torch_evaluation.py): held-out
    ratings beat a constant 3, and the hitrate queries black-list the
    user's training items."""
    _seed_port()
    variant = variant_from_dict({
        **VARIANT,
        "datasource": {"params": {"app_name": "rec-test", "eval_k": 3,
                                  "eval_mode": mode}},
        "algorithms": [{"name": "als", "params": {
            "rank": 2, "num_iterations": 15, "lambda_": 0.1, "seed": 1}}],
    })
    engine, ep = build_engine(variant)
    ctx = ComputeContext.local(device="cpu")
    ds = RecommendationDataSource(ep.data_source_params)
    folds = ds.read_eval(ctx)
    assert len(folds) == 3 and [f[1] for f in folds] == [
        {"fold": k} for k in range(3)]
    prep = engine.preparator_class(ep.preparator_params)
    (name, params), = ep.algorithm_params_list
    algo = engine.algorithm_class_map[name](params)
    sq_err, sq_base, n, hits = 0.0, 0.0, 0, 0
    for td, _, qa in folds:
        model = algo.train(ctx, prep.prepare(ctx, td))
        for q, actual in qa:
            p = algo.predict(model, q)
            if mode == "rating":
                if p.item_scores:
                    sq_err += (p.item_scores[0].score - actual) ** 2
                    sq_base += (3.0 - actual) ** 2
                    n += 1
            else:
                assert not set(q.black_list) & {s.item for s in p.item_scores}
                hits += actual in {s.item for s in p.item_scores}
                n += 1
    if mode == "rating":
        assert n > 50 and sq_err / n < sq_base / n
    else:
        assert n > 50 and hits > 0


def test_read_eval_rejects_one_fold(memory_storage):
    _seed_port()
    variant = variant_from_dict({**VARIANT, "datasource": {
        "params": {"app_name": "rec-test", "eval_k": 1}}})
    _, ep = build_engine(variant)
    with pytest.raises(ValueError, match="eval_k >= 2"):
        RecommendationDataSource(ep.data_source_params).read_eval(None)


def test_batch_matches_loop(memory_storage):
    _seed_port()
    engine, ep, ctx, iid = _train_port()
    models = load_models_for_instance(iid, engine, ep, ctx)
    algo, model = engine.algorithms_with_models(ep, models)[0]
    queries = (
        [(i, Query(user=f"u{i % 10}", num=4)) for i in range(20)]
        + [(50, Query(user="u3", num=3, black_list=("i0", "i5")))]
        + [(90, Query(user="u1", num=1, item="i2"))]  # single-item
        + [(91, Query(user="ghost", num=4))]          # unknown user
    )
    loop = {i: algo.predict(model, q) for i, q in queries}
    bat = dict(algo.batch_predict(model, queries))
    assert set(loop) == set(bat)
    for i in loop:
        assert [s.item for s in loop[i].item_scores] == [
            s.item for s in bat[i].item_scores], i


def test_persisted_model_holds_no_scorer(memory_storage):
    """The blob carries host arrays and no scorer; it loads on the device
    the caller names, and the scorer follows."""
    _seed_port()
    engine, ep, ctx, iid = _train_port()
    model = load_models_for_instance(iid, engine, ep, ctx)[0]
    model.scorer(warmup=True)
    blob = serialize_models([model])
    back = deserialize_models(blob, "cpu")[0]
    assert "_scorer" not in back.__dict__
    assert isinstance(back.factors.user_factors, torch.Tensor)
    assert torch.equal(back.factors.item_factors, model.factors.item_factors)
    assert back.scorer().device == torch.device("cpu")


# ----------------------------------------------- the reference's model, here
def test_interchange_with_the_reference_scorer(memory_storage):
    """Train with the JAX package, carry the model across, and compare the
    scorers' top-N for every user of the fixture (module docstring)."""
    jax_app = JaxStorage.get_meta_data_apps().insert(JaxApp(0, "rec-test"))
    _seed(jax_app, JaxEvent, JaxStorage.get_levents(), _event_rows())
    variant = jax_variant_from_dict(VARIANT)
    engine, ep = jax_build_engine(variant)
    jctx = JaxContext.create(seed=0)
    iid = jax_run_train(engine, ep, variant, ctx=jctx)
    ref = jax_load_models(iid, engine, ep, jctx)[0]
    model = als_model_from_reference({
        "user_factors": ref.factors.user_factors,
        "item_factors": ref.factors.item_factors,
        "user_index": ref.user_index.to_dict(),
        "item_index": ref.item_index.to_dict(),
    }, device="cpu")
    assert model.item_index.to_dict() == ref.item_index.to_dict()
    algo, jalgo = ALSAlgorithm(None), JaxALS(None)
    users = sorted(model.user_index.keys())
    assert len(users) == 12
    n_items = len(model.item_index)
    for u in users:
        got = algo.predict(model, Query(user=u, num=n_items)).item_scores
        want = jalgo.predict(ref, JaxQuery(user=u, num=n_items)).item_scores
        np.testing.assert_allclose([s.score for s in got],
                                   [s.score for s in want], rtol=1e-5)
        w_scores = np.array([s.score for s in want])
        distinct = np.diff(w_scores) < -1e-5
        for k, item in enumerate(s.item for s in got):
            # the same item at k unless its score ties a neighbour's
            if (k == 0 or distinct[k - 1]) and (
                    k == len(got) - 1 or distinct[k]):
                assert item == want[k].item, (u, k)
    # batch scoring agrees with the reference's batch too
    qs = [(k, Query(user=u, num=3)) for k, u in enumerate(users)]
    jqs = [(k, JaxQuery(user=u, num=3)) for k, u in enumerate(users)]
    got = dict(algo.batch_predict(model, qs))
    want = dict(jalgo.batch_predict(ref, jqs))
    for k in got:
        assert [s.item for s in got[k].item_scores] == [
            s.item for s in want[k].item_scores]


def test_als_model_from_reference_checks_its_input():
    ok = {"user_factors": np.zeros((2, 3)), "item_factors": np.zeros((4, 3)),
          "user_index": {"a": 0, "b": 1},
          "item_index": {f"i{k}": k for k in range(4)}}
    assert als_model_from_reference(ok, "cpu").factors.user_factors.dtype \
        == torch.float32
    with pytest.raises(ValueError, match="user_index"):
        als_model_from_reference({**ok, "user_index": {"a": 0, "b": 2}}, "cpu")
    with pytest.raises(ValueError, match="not \\[n, rank\\]"):
        als_model_from_reference({**ok, "item_factors": np.zeros((4, 2))},
                                 "cpu")


# --------------------------------------------------------- the query server
def test_queries_json_through_the_query_server(memory_storage):
    _seed_port()
    engine, ep, ctx, iid = _train_port()
    models = load_models_for_instance(iid, engine, ep, ctx)
    algo = engine.algorithm_class_map["als"](ep.algorithm_params_list[0][1])
    server = create_query_server(engine, ep, models, port=0)
    with server:
        assert "_scorer" in models[0].__dict__  # prepared at deploy
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        bodies = [
            {"user": "u0", "num": 4},
            {"user": "u7", "num": 2, "blackList": ["i4", "i5"]},
            {"user": "u2", "item": "i1"},
            {"user": "stranger"},
            {"user": "u1", "num": 0},
        ]
        for body in bodies:
            conn.request("POST", "/queries.json", json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            got = json.loads(resp.read())
            assert resp.status == 200, got
            q = params_from_dict(Query, body)
            assert got == algo.predict(models[0], q).to_dict(), body
        conn.request("POST", "/queries.json", b'{"user": "u0", "bogus": 1}')
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 400
        conn.close()
