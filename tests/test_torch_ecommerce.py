"""The e-commerce template in the port against the JAX package's, on the
CPU, in memory storage.

- The lifecycle of ``tests/test_similarproduct.py``'s ``TestECommerce``
  runs on the port: a known user, a cold user answered from the live
  store's recent views, a user with no history, the unavailable-items
  constraint set after training, ``unseen_only`` and a black list.
- A model trained by the JAX package, carried across with
  ``ecomm_model_from_reference``, answers as the reference does when both
  stores hold the same live events: the same numpy on the same factors,
  so the same items and scores, exactly, for ``predict`` and
  ``batch_predict``, through every rule, and after the constraint
  changes between two identical queries.
- ``batch_predict`` against the ``predict`` loop, and ``read_eval`` (the
  seen-exclusion holdout) against the reference's folds.
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.templates import ecommerce as JE
from pio_tpu_torch.convert import ecomm_model_from_reference
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import App
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates import ecommerce as TE
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from test_torch_similarproduct import (  # noqa: F401  (fixture)
    T0,
    memory_storage,
    results,
    seed_events,
    train_port,
    train_reference,
    view_rows,
)

APP = "ec-test"
ALGO = {"name": "ecomm",
        "params": {"app_name": APP, "rank": 6, "num_iterations": 10,
                   "lambda_": 0.05, "seed": 1}}
VARIANT = {"id": "ec-e2e", "engineFactory": "templates.ecommerce",
           "datasource": {"params": {"app_name": APP}}, "algorithms": [ALGO]}


def with_params(**over):
    return {**VARIANT, "algorithms": [
        {**ALGO, "params": {**ALGO["params"], **over}}]}


def constraint_row(items, minutes):
    return ("$set", "constraint", "unavailableItems", None,
            {"items": list(items)},
            T0 + dt.timedelta(days=2, minutes=minutes))


def view_row(user, item, minutes, name="view"):
    return (name, "user", user, item, {},
            T0 + dt.timedelta(days=1, minutes=minutes))


def serve_port(variant=VARIANT):
    engine, ep, ctx, iid = train_port(variant)
    models = load_models_for_instance(iid, engine, ep, ctx)
    serving = engine.make_serving(ep)
    pairs = engine.algorithms_with_models(ep, models)

    def serve(**kw):
        q = TE.Query(**kw)
        return serving.serve(q, [a.predict(m, q) for a, m in pairs])

    return serve, pairs[0]


# ------------------------------------------------------------- lifecycle
def test_full_lifecycle(memory_storage):
    """The queries of tests/test_similarproduct.py's TestECommerce."""
    seed_events(view_rows(), app=APP, reference=False)
    serve, (algo, model) = serve_port()
    assert isinstance(model, TE.ECommModel) and model.app_id == 1
    assert {s.item for s in serve(user="u0", num=4).item_scores} == \
        {"i0", "i1", "i2", "i3"}
    assert "i1" not in {s.item for s in serve(user="u0", num=4,
                                              black_list=("i1",)).item_scores}
    assert serve(user="ghost").item_scores == ()
    # a user unknown to the model, with views since training
    seed_events([view_row("newbie", "i4", 0), view_row("newbie", "i5", 1)],
                 app=APP, reference=False)
    res = serve(user="newbie", num=8)
    assert {s.item for s in res.item_scores[:2]} <= {"i4", "i5", "i6", "i7"}
    # the constraint, set after training, holds at once
    assert "i0" in {s.item for s in serve(user="u0", num=4).item_scores}
    seed_events([constraint_row(["i0"], 0)], app=APP, reference=False)
    assert "i0" not in {s.item for s in serve(user="u0", num=4).item_scores}


def test_unseen_only_excludes_seen(memory_storage):
    seed_events(view_rows(), app=APP, reference=False)
    serve, _ = serve_port(with_params(unseen_only=True,
                                      num_recent_events=50))
    got = {s.item for s in serve(user="u0", num=8).item_scores}
    assert len(got) == 7  # 11 items, u0's 4 seen ones left out
    assert not got & {"i0", "i1", "i2", "i3"}


def test_train_needs_the_app(memory_storage):
    seed_events(view_rows(), app=APP, reference=False)
    with pytest.raises(ValueError, match="app_name"):
        train_port(with_params(app_name="no-such-app"))


# ------------------------------------------- the reference's model, here
def _queries():
    users = [f"u{u}" for u in range(12)]
    qs = [TE.Query(user=u, num=n) for u in users for n in (3, 11)]
    qs += [
        TE.Query(user="u1", num=5, categories=("food", "toys")),
        TE.Query(user="u7", num=6, white_list=("i0", "i5", "x2", "q"),
                 black_list=("i5",)),
        TE.Query(user="u2", num=4, black_list=("i0", "i1")),
        TE.Query(user="cold", num=5),  # recent views only
        TE.Query(user="cold", num=5, categories=("tech",)),
        TE.Query(user="ghost", num=5),  # no history at all
        TE.Query(user="u3", num=0),
    ]
    return qs


def _jax_query(q):
    return JE.Query(**dataclasses.asdict(q))


@pytest.mark.parametrize("unseen_only", [False, True])
def test_interchange_with_the_reference(memory_storage, unseen_only):
    """Both packages' stores hold the same events; the reference's model
    answers through the port as through the reference, bit for bit,
    including after the constraint changes between two queries."""
    rows = view_rows() + [view_row("cold", "i5", 0), view_row("cold", "i6", 1),
                          view_row("u0", "i6", 2, "buy"),
                          constraint_row(["i5", "x1"], 0)]
    port_app, ref_app = seed_events(rows, app=APP)
    assert port_app == ref_app
    variant = with_params(unseen_only=unseen_only, num_recent_events=50)
    ref = train_reference(variant)
    model = ecomm_model_from_reference({
        "user_factors": ref.user_factors,
        "item_factors": ref.item_factors,
        "norm_item_factors": ref.norm_item_factors,
        "user_index": ref.user_index.to_dict(),
        "item_index": ref.item_index.to_dict(),
        "categories": ref.categories,
        "app_id": ref.app_id,
    })
    params = variant["algorithms"][0]["params"]
    algo = TE.ECommAlgorithm(TE.ECommAlgorithmParams(**params))
    jalgo = JE.ECommAlgorithm(JE.ECommAlgorithmParams(**params))

    def both(qs):
        loop = [(results(algo.predict(model, q)),
                 results(jalgo.predict(ref, _jax_query(q)))) for q in qs]
        got = dict(algo.batch_predict(model, list(enumerate(qs))))
        want = dict(jalgo.batch_predict(
            ref, [(k, _jax_query(q)) for k, q in enumerate(qs)]))
        return loop, ({k: results(v) for k, v in got.items()},
                      {k: results(v) for k, v in want.items()})

    loop, (got, want) = both(_queries())
    for k, (a, b) in enumerate(loop):
        assert a == b, _queries()[k]
    assert got == want
    whole = TE.Query(user="u0", num=11)
    before = results(algo.predict(model, whole))
    assert "i5" not in {item for item, _ in before}
    seed_events([constraint_row(["i4"], 5)], app=APP)
    loop, (got, want) = both([whole])
    assert loop[0][0] == loop[0][1] and got == want
    after = {item for item, _ in loop[0][0]}
    assert "i5" in after and "i4" not in after


def test_model_from_reference_checks_its_input():
    ok = {"user_factors": np.zeros((2, 3)), "item_factors": np.ones((4, 3)),
          "norm_item_factors": np.ones((4, 3)),
          "user_index": {"a": 0, "b": 1},
          "item_index": {f"i{k}": k for k in range(4)},
          "categories": [["c"]] * 4, "app_id": 3}
    m = ecomm_model_from_reference(ok)
    assert m.app_id == 3 and m.item_factors.dtype == np.float32
    with pytest.raises(ValueError, match="do not agree"):
        ecomm_model_from_reference({**ok, "item_factors": np.ones((4, 2))})
    with pytest.raises(ValueError, match="user_index"):
        ecomm_model_from_reference({**ok, "user_index": {"a": 0}})


# ------------------------------------------------- batch, loop, read_eval
def test_batch_matches_loop(memory_storage):
    rows = view_rows() + [view_row("cold", "i2", 0),
                          constraint_row(["i0"], 0)]
    seed_events(rows, app=APP, reference=False)
    _, (algo, model) = serve_port(with_params(unseen_only=True))
    qs = ([(i, TE.Query(user=f"u{i % 12}", num=3)) for i in range(16)]
          + [(90, TE.Query(user="u1", num=3, categories=("food",))),
             (91, TE.Query(user="cold", num=3)),
             (92, TE.Query(user="ghost", num=3))])
    loop = {i: results(algo.predict(model, q)) for i, q in qs}
    bat = {i: results(r) for i, r in algo.batch_predict(model, qs)}
    assert loop == bat
    assert all(item != "i0" for res in bat.values() for item, _ in res)
    assert bat[91] and bat[92] == []


def test_read_eval_folds_match_reference(memory_storage):
    rows = view_rows()
    rng = np.random.default_rng(1)
    rows += [view_row(f"u{rng.integers(12)}", f"i{rng.integers(8)}", k)
             for k in range(40)]
    seed_events(rows, app=APP)
    got = TE.ECommerceDataSource(TE.DataSourceParams(
        app_name=APP, eval_k=3, eval_num=4)).read_eval(
        ComputeContext.local(device="cpu"))
    want = JE.ECommerceDataSource(JE.DataSourceParams(
        app_name=APP, eval_k=3, eval_num=4)).read_eval(JaxContext.local())
    assert len(got) == len(want) == 3
    for (td, info, qa), (jtd, jinfo, jqa) in zip(got, want):
        assert info == jinfo
        assert np.array_equal(td.user_ids, jtd.user_ids)
        assert np.array_equal(td.item_ids, jtd.item_ids)
        assert len(qa) == len(jqa) > 0
        for (q, a), (jq, ja) in zip(qa, jqa):
            assert dataclasses.asdict(q) == dataclasses.asdict(jq)
            assert a == ja
    with pytest.raises(ValueError, match="eval_k >= 2"):
        TE.ECommerceDataSource(TE.DataSourceParams(
            app_name=APP, eval_k=1)).read_eval(
            ComputeContext.local(device="cpu"))


@pytest.mark.cuda
def test_card_model_answers_like_cpu(memory_storage):
    """run_train on the card against the CPU: scores within 1e-4 (f32 ALS
    in another summation order), the same items where neighbouring
    scores differ by more than that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed_events(view_rows(), app=APP, reference=False)
    answers = {}
    for dev in ("cuda", "cpu"):
        engine, ep, ctx, iid = train_port(VARIANT, device=dev)
        (model,) = load_models_for_instance(iid, engine, ep, ctx)
        algo = TE.ECommAlgorithm(ep.algorithm_params_list[0][1])
        answers[dev] = [algo.predict(model, TE.Query(user=f"u{u}", num=8))
                        for u in range(12)]
    for card, cpu in zip(answers["cuda"], answers["cpu"]):
        c = np.array([s.score for s in cpu.item_scores])
        np.testing.assert_allclose([s.score for s in card.item_scores], c,
                                   atol=1e-4)
        apart = np.abs(np.diff(c)) > 1e-4
        for k, (a, b) in enumerate(zip(card.item_scores, cpu.item_scores)):
            if (k == 0 or apart[k - 1]) and (k == len(c) - 1 or apart[k]):
                assert a.item == b.item
