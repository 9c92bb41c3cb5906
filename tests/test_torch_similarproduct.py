"""The similar-product template and the shared item-scoring rules in the
port against the JAX package's, on the CPU, in memory storage.

- ``l2_normalize_rows``, ``business_rule_mask`` and ``top_item_scores``
  are copies: the same bits on seeded inputs, zero rows, all-masked and
  tied scores included.
- The lifecycle of ``tests/test_similarproduct.py`` runs on the port:
  ingest → ``run_train`` → ``load_models_for_instance`` → queries with
  every business rule, and ``POST /queries.json``.
- A model trained by the JAX package, carried across with
  ``similarproduct_model_from_reference``, answers every query as the
  reference does: both score with the same numpy on the same float32
  factors, so the same items and the same scores, exactly.
- Implicit ALS through the template from the reference's initial factors,
  with items that only a ``$set`` names (no views, so rows with no
  blocks at the end of the popularity order): normalized factors within
  the ALS tests' 1e-4 at a well-conditioned reg (the test says why), and
  exactly zero rows for those items on both.
- ``read_eval`` gives the reference's folds, queries and actuals.
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
from pio_tpu.templates import similarproduct as JS
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.controller.params import params_from_dict
from pio_tpu_torch.convert import similarproduct_model_from_reference
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.models import als as T
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.query_server import create_query_server
from pio_tpu_torch.storage.records import App, RunStatus
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates import common
from pio_tpu_torch.templates import similarproduct as TS
from pio_tpu_torch.workflow.core_workflow import (
    load_models_for_instance,
    run_train,
)
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from test_torch_als import _reference_init as reference_init

T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
APP = "sp-test"
ALGO = {"name": "als",
        "params": {"rank": 6, "num_iterations": 10, "lambda_": 0.05,
                   "seed": 1}}
VARIANT = {"id": "sp-e2e", "engineFactory": "templates.similarproduct",
           "datasource": {"params": {"app_name": APP}}, "algorithms": [ALGO]}
#: items named only by a $set: no views, factor rows with no blocks
UNVIEWED = ("x0", "x1", "x2")


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


def view_rows(n_users=12, n_items=8, unviewed=UNVIEWED):
    """Two view blocks: u0-5 view i0-3 ('tech'), u6-11 view i4-7 ('food');
    every item $set with its category, ``unviewed`` items too ('toys')."""
    rows = [("$set", "item", f"i{i}", None,
             {"categories": ["tech" if i < 4 else "food"]}, T0)
            for i in range(n_items)]
    rows += [("$set", "item", x, None, {"categories": ["toys"]}, T0)
             for x in unviewed]
    k = 0
    for u in range(n_users):
        for i in range(n_items):
            if (u < 6) == (i < 4):
                rows.append(("view", "user", f"u{u}", f"i{i}", {},
                             T0 + dt.timedelta(minutes=k)))
                k += 1
    return rows


def seed_events(rows, app=APP, port=True, reference=True):
    """Insert ``rows`` into an app of that name in each package's store;
    returns the app ids (port, reference)."""
    ids = []
    for ok, apps, app_cls, levents, ev_cls in (
            (port, Storage.get_meta_data_apps, App, Storage.get_levents,
             Event),
            (reference, JaxStorage.get_meta_data_apps, JaxApp,
             JaxStorage.get_levents, JaxEvent)):
        if not ok:
            ids.append(None)
            continue
        app_id = apps().get_by_name(app)
        app_id = app_id.id if app_id else apps().insert(app_cls(0, app))
        for name, etype, eid, target, props, t in rows:
            levents().insert(ev_cls(
                name, etype, eid,
                "item" if target else None, target,
                properties=props, event_time=t), app_id)
        ids.append(app_id)
    return tuple(ids)


def train_port(variant_dict=VARIANT, device="cpu"):
    variant = variant_from_dict(variant_dict)
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(seed=0, device=device)
    iid = run_train(engine, ep, variant, ctx=ctx)
    return engine, ep, ctx, iid


def train_reference(variant_dict=VARIANT):
    """The JAX package's model of the same variant, trained and loaded."""
    variant = jax_variant_from_dict(variant_dict)
    engine, ep = jax_build_engine(variant)
    jctx = JaxContext.create(seed=0)
    iid = jax_run_train(engine, ep, variant, ctx=jctx)
    return jax_load_models(iid, engine, ep, jctx)[0]


def swap_init(monkeypatch, seed, n_users, n_items, rank):
    """Make the port's train_als start from the reference's factors."""
    inits = iter(torch.from_numpy(np.array(f)) for f in
                 reference_init(seed, n_users, n_items, rank))
    monkeypatch.setattr(T, "_init_factors", lambda *a: next(inits))


def results(res):
    return [(s.item, s.score) for s in res.item_scores]


# ------------------------------------------- shared rules: the same bits
@pytest.mark.parametrize("seed,zero_rows", [(0, ()), (1, (0, 3)),
                                            (2, tuple(range(6)))])
def test_l2_normalize_rows_bitwise(seed, zero_rows):
    f = np.random.default_rng(seed).normal(size=(6, 5)).astype(np.float32)
    f[list(zero_rows)] = 0.0
    got = common.l2_normalize_rows(f)
    want = jax_common.l2_normalize_rows(f)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[list(zero_rows)].any()


def _catalog(n=20, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"i{k}" for k in range(n)]
    cats = [frozenset(rng.choice(["a", "b", "c", "d"],
                                 size=int(rng.integers(0, 3)),
                                 replace=False).tolist()) for _ in names]
    return names, cats


@pytest.mark.parametrize("rules", [
    {},
    {"categories": ("a",)},
    {"categories": ("a", "d"), "black_list": ("i3", "ghost")},
    {"white_list": ("i1", "i5", "ghost"), "black_list": ("i5",)},
    {"categories": ("zz",)},  # masks every item
    {"categories": ("b",), "white_list": ("i2", "i7", "i9"),
     "black_list": ("i9", "i0")},
])
def test_business_rule_mask_bitwise(rules):
    names, cats = _catalog()
    got = common.business_rule_mask(
        len(names), BiMap.string_int(names), cats, **rules)
    want = jax_common.business_rule_mask(
        len(names), JaxBiMap.string_int(names), cats, **rules)
    assert got.dtype == want.dtype == np.bool_
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["plain", "masked", "all_masked", "num_0",
                                  "num_over", "ties", "zero_scores"])
def test_top_item_scores_bitwise(case):
    names, _ = _catalog()
    rng = np.random.default_rng(3)
    scores = rng.normal(size=len(names)).astype(np.float32)
    mask = np.ones(len(names), bool)
    num = 5
    if case == "masked":
        mask[rng.choice(len(names), 12, replace=False)] = False
    elif case == "all_masked":
        mask[:] = False
    elif case == "num_0":
        num = 0
    elif case == "num_over":
        mask[:15] = False
        num = 10
    elif case == "ties":
        scores = np.round(scores).astype(np.float32)
    elif case == "zero_scores":  # the cosine of an item with a zero factor
        scores[::3] = 0.0
        scores = -np.abs(scores)
        num = 12
    got = common.top_item_scores(scores, mask, num, BiMap.string_int(names))
    want = jax_common.top_item_scores(scores, mask, num,
                                      JaxBiMap.string_int(names))
    assert results(got) == results(want)
    assert len(got.item_scores) == min(num, int(mask.sum()))


# ------------------------------------------------------------- lifecycle
def test_full_lifecycle(memory_storage):
    """The queries of tests/test_similarproduct.py on the port."""
    seed_events(view_rows(), reference=False)
    engine, ep, ctx, iid = train_port()
    inst = Storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == RunStatus.COMPLETED and inst.env["device"] == "cpu"
    (model,) = load_models_for_instance(iid, engine, ep, ctx)
    assert isinstance(model, TS.SimilarProductModel)
    assert model.norm_factors.dtype == np.float32
    assert len(model.item_index) == 11  # the unviewed $set items included
    serving = engine.make_serving(ep)
    pairs = engine.algorithms_with_models(ep, [model])

    def query(**kw):
        q = TS.Query(**kw)
        return serving.serve(q, [a.predict(m, q) for a, m in pairs])

    res = query(items=("i0",), num=3)
    assert {s.item for s in res.item_scores} == {"i1", "i2", "i3"}
    scores = [s.score for s in res.item_scores]
    assert scores == sorted(scores, reverse=True)
    assert {s.item for s in query(items=("i0",), num=8, categories=("food",))
            .item_scores} <= {"i4", "i5", "i6", "i7"}
    assert {s.item for s in query(items=("i0",), num=8,
                                  white_list=("i1", "i2"),
                                  black_list=("i2",)).item_scores} == {"i1"}
    assert query(items=("nope",)).item_scores == ()
    assert {s.item for s in query(items=("i4", "i5"), num=2).item_scores} \
        == {"i6", "i7"}
    # an unviewed item has a zero factor: cosine 0.0, finite, servable
    toys = query(items=("i0",), num=5, categories=("toys",)).item_scores
    assert sorted(s.item for s in toys) == list(UNVIEWED)
    assert all(s.score == 0.0 for s in toys)


def test_empty_app_fails_sanity(memory_storage):
    Storage.get_meta_data_apps().insert(App(0, APP))
    variant = variant_from_dict(VARIANT)
    engine, ep = build_engine(variant)
    with pytest.raises(ValueError, match="TrainingData is empty"):
        run_train(engine, ep, variant, ctx=ComputeContext.local(device="cpu"))


def test_run_train_defaults_to_the_card(memory_storage):
    """Without a context, run_train trains on CUDA, and raises where there
    is none (never a quiet CPU run)."""
    seed_events(view_rows(), reference=False)
    variant = variant_from_dict(VARIANT)
    engine, ep = build_engine(variant)
    if torch.cuda.is_available():
        iid = run_train(engine, ep, variant)
        env = Storage.get_meta_data_engine_instances().get(iid).env
        assert env["device"].startswith("cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            run_train(engine, ep, variant)


# ------------------------------------------- the reference's model, here
def _queries():
    items = [f"i{i}" for i in range(8)] + list(UNVIEWED)
    qs = [TS.Query(items=(it,), num=n) for it in items for n in (3, 11)]
    qs += [
        TS.Query(items=("i0", "i5"), num=4),
        TS.Query(items=("i1", "i2", "i3"), num=6, categories=("tech",)),
        TS.Query(items=("i4",), num=8, categories=("tech", "toys")),
        TS.Query(items=("i0",), num=8, white_list=("i1", "i6", "x1", "q"),
                 black_list=("i6",)),
        TS.Query(items=("i7", "nope"), num=5, black_list=("i6", "i5")),
        TS.Query(items=("nope",), num=5),
        TS.Query(items=(), num=5),
        TS.Query(items=("i2",), num=0),
    ]
    return qs


def _jax_query(q):
    return JS.Query(items=q.items, num=q.num, categories=q.categories,
                    white_list=q.white_list, black_list=q.black_list)


def test_interchange_with_the_reference(memory_storage):
    """Every query answered as the reference answers it, bit for bit."""
    seed_events(view_rows(), port=False)
    ref = train_reference()
    model = similarproduct_model_from_reference({
        "norm_factors": ref.norm_factors,
        "item_index": ref.item_index.to_dict(),
        "categories": ref.categories,
    })
    assert model.item_index.to_dict() == ref.item_index.to_dict()
    algo, jalgo = TS.SimilarProductAlgorithm(), JS.SimilarProductAlgorithm()
    qs = _queries()
    for q in qs:
        assert results(algo.predict(model, q)) == \
            results(jalgo.predict(ref, _jax_query(q))), q
    got = dict(algo.batch_predict(model, list(enumerate(qs))))
    want = dict(jalgo.batch_predict(
        ref, [(k, _jax_query(q)) for k, q in enumerate(qs)]))
    assert {k: results(v) for k, v in got.items()} == \
        {k: results(v) for k, v in want.items()}


def test_model_from_reference_checks_its_input():
    ok = {"norm_factors": np.zeros((3, 2)),
          "item_index": {"a": 0, "b": 1, "c": 2},
          "categories": [["x"], [], ("y", "z")]}
    m = similarproduct_model_from_reference(ok)
    assert m.norm_factors.dtype == np.float32
    assert m.categories == [frozenset({"x"}), frozenset(),
                            frozenset({"y", "z"})]
    with pytest.raises(ValueError, match="item_index"):
        similarproduct_model_from_reference(
            {**ok, "item_index": {"a": 0, "b": 1, "c": 3}})
    with pytest.raises(ValueError, match="category sets"):
        similarproduct_model_from_reference({**ok, "categories": [["x"]]})
    with pytest.raises(ValueError, match="not \\[n, rank\\]"):
        similarproduct_model_from_reference({**ok, "norm_factors": np.zeros(3)})


# ------------------------------------------- implicit ALS, unviewed items
@pytest.mark.parametrize("n_unviewed", [0, 3])
def test_implicit_training_matches_the_reference(memory_storage, monkeypatch,
                                                 n_unviewed):
    """The port's template trains the reference's factors from the
    reference's init; unviewed items' rows are exactly zero on both.

    reg 0.5: the two blocks' items have identical view columns, so at the
    template's reg 0.05 the rank-4 systems are near-singular and amplify
    the f32 summation-order difference of the two packages to 9.7e-5
    after one iteration and 2.4e-4 after five (measured on the CPU);
    at reg 0.5 the two stay within 5e-6."""
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    seed_events(view_rows(unviewed=UNVIEWED[:n_unviewed]))
    params = dict(rank=4, num_iterations=5, lambda_=0.5, alpha=2.0, seed=7)
    ctx = ComputeContext.local(device="cpu")
    td = TS.SimilarProductDataSource(
        TS.DataSourceParams(app_name=APP)).read_training(ctx)
    pd = TS.SimilarProductPreparator().prepare(ctx, td)
    jctx = JaxContext.local()
    jtd = JS.SimilarProductDataSource(
        JS.DataSourceParams(app_name=APP)).read_training(jctx)
    jpd = JS.SimilarProductPreparator().prepare(jctx, jtd)
    assert pd.item_index.to_dict() == jpd.item_index.to_dict()
    assert np.array_equal(pd.item_codes, jpd.item_codes)
    assert pd.categories == jpd.categories
    n_items = len(pd.item_index)
    swap_init(monkeypatch, 7, len(pd.user_index), n_items, 4)
    got = TS.SimilarProductAlgorithm(TS.ALSAlgorithmParams(**params)).train(
        ctx, pd)
    want = JS.SimilarProductAlgorithm(JS.ALSAlgorithmParams(**params)).train(
        jctx, jpd)
    np.testing.assert_allclose(got.norm_factors, want.norm_factors,
                               atol=1e-4)
    trailing = [pd.item_index[x] for x in UNVIEWED[:n_unviewed]]
    assert sorted(trailing) == list(range(8, n_items))  # last in the order
    assert not got.norm_factors[trailing].any()
    assert not want.norm_factors[trailing].any()
    q = TS.Query(items=("i1",), num=n_items)
    a = TS.SimilarProductAlgorithm().predict(got, q)
    b = JS.SimilarProductAlgorithm().predict(want, _jax_query(q))
    np.testing.assert_allclose([s.score for s in a.item_scores],
                               [s.score for s in b.item_scores], atol=1e-4)
    assert len(a.item_scores) == len(b.item_scores) == n_items - 1


# ------------------------------------------------------------ evaluation
def test_read_eval_folds_match_reference(memory_storage):
    rows = view_rows()
    rng = np.random.default_rng(0)
    k = 0
    for _ in range(40):  # cross-block views and repeats, so folds differ
        rows.append(("view", "user", f"u{rng.integers(12)}",
                     f"i{rng.integers(8)}", {},
                     T0 + dt.timedelta(hours=1, minutes=k)))
        k += 1
    seed_events(rows)
    got = TS.SimilarProductDataSource(TS.DataSourceParams(
        app_name=APP, eval_k=3, eval_num=4)).read_eval(
        ComputeContext.local(device="cpu"))
    want = JS.SimilarProductDataSource(JS.DataSourceParams(
        app_name=APP, eval_k=3, eval_num=4)).read_eval(JaxContext.local())
    assert len(got) == len(want) == 3
    for (td, info, qa), (jtd, jinfo, jqa) in zip(got, want):
        assert info == jinfo
        assert np.array_equal(td.user_ids, jtd.user_ids)
        assert np.array_equal(td.item_ids, jtd.item_ids)
        assert td.item_categories == jtd.item_categories
        assert len(qa) == len(jqa) > 0
        for (q, a), (jq, ja) in zip(qa, jqa):
            assert (q.items, q.num) == (jq.items, jq.num) and a == ja


def test_read_eval_rejects_one_fold(memory_storage):
    ds = TS.SimilarProductDataSource(TS.DataSourceParams(app_name=APP,
                                                         eval_k=1))
    with pytest.raises(ValueError, match="eval_k >= 2"):
        ds.read_eval(ComputeContext.local(device="cpu"))
    assert TS.SimilarProductDataSource(TS.DataSourceParams(
        app_name=APP)).read_eval(ComputeContext.local(device="cpu")) == []


# --------------------------------------------------------- the query server
def test_queries_json_through_the_query_server(memory_storage):
    seed_events(view_rows(), reference=False)
    engine, ep, ctx, iid = train_port()
    models = load_models_for_instance(iid, engine, ep, ctx)
    algo = TS.SimilarProductAlgorithm(ep.algorithm_params_list[0][1])
    bodies = [
        {"items": ["i0"], "num": 3},
        {"items": ["i4", "i5"], "num": 4, "categories": ["food"]},
        {"items": ["i1"], "num": 5, "whiteList": ["i2", "i3", "i6"],
         "blackList": ["i3"]},
        {"items": ["nobody-viewed-this"]},
    ]
    server = create_query_server(engine, ep, models, port=0)
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        for body in bodies:
            conn.request("POST", "/queries.json", json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            got = json.loads(resp.read())
            assert resp.status == 200, got
            q = params_from_dict(TS.Query, body)
            assert got == algo.predict(models[0], q).to_dict(), body
        conn.close()
    assert [s["item"] for s in got["itemScores"]] == []


@pytest.mark.cuda
def test_card_training_matches_cpu(memory_storage):
    """run_train on the card against the CPU: the same items for every
    single-item query where neighbouring scores differ by more than the
    tolerance, scores within 1e-4 (f32 ALS in another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed_events(view_rows(), reference=False)
    answers = {}
    for dev in ("cuda", "cpu"):
        engine, ep, ctx, iid = train_port(device=dev)
        (model,) = load_models_for_instance(iid, engine, ep, ctx)
        answers[dev] = [TS.SimilarProductAlgorithm().predict(
            model, TS.Query(items=(f"i{i}",), num=10)) for i in range(8)]
    for card, cpu in zip(answers["cuda"], answers["cpu"]):
        c = np.array([s.score for s in cpu.item_scores])
        np.testing.assert_allclose([s.score for s in card.item_scores], c,
                                   atol=1e-4)
        apart = np.abs(np.diff(c)) > 1e-4
        for k, (a, b) in enumerate(zip(card.item_scores, cpu.item_scores)):
            if (k == 0 or apart[k - 1]) and (k == len(c) - 1 or apart[k]):
                assert a.item == b.item
