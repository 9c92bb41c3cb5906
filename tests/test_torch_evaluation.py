"""Evaluation in the port against the JAX package's, on the CPU, in memory
storage.

- The recommendation template's k-fold ``read_eval``: the same events in
  both stores give the same folds, bitwise (training columns, queries,
  actuals), in both eval modes; ``split_data`` gives the same folds.
- The metrics, ``MetricEvaluator`` and ``Engine.eval`` of both packages
  on the same predictions (a toy engine whose model is a number, no
  training randomness): the same scores, exactly, and the same best
  params and result JSON.
- ``run_evaluation(recommendation_evaluation(...))`` on the port: the
  same result twice, an evaluation instance recorded COMPLETED (FAILED
  with the error when the run fails).
"""

import dataclasses
import datetime as dt
import json

import numpy as np
import pytest

import pio_tpu.controller as J
from pio_tpu.controller.cross_validation import split_data as jax_split_data
from pio_tpu.controller.evaluation import MetricEvaluator as JaxEvaluator
from pio_tpu.controller.metrics import AverageMetric as JaxAverage
from pio_tpu.controller.metrics import OptionAverageMetric as JaxOptionAverage
from pio_tpu.controller.metrics import StdevMetric as JaxStdev
from pio_tpu.controller.metrics import SumMetric as JaxSum
from pio_tpu.data import Event as JaxEvent
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.storage import App as JaxApp
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.templates import recommendation as JR
from pio_tpu_torch.controller import components as C
from pio_tpu_torch.controller.cross_validation import split_data
from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
)
from pio_tpu_torch.controller.metrics import (
    AverageMetric,
    OptionAverageMetric,
    StdevMetric,
    SumMetric,
)
from pio_tpu_torch.controller.params import Params
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import App, RunStatus
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates import recommendation as TR
from pio_tpu_torch.workflow.core_workflow import run_evaluation

T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
APP = "eval-test"


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


def _rows(n=300, seed=0):
    """n integer-star ratings of 30 users over 20 skewed items, repeats
    of a (user, item) pair included, and a buy event."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 30, n)
    i = (rng.random(n) ** 2 * 20).astype(int)
    r = rng.integers(1, 6, n)
    rows = [("rate", f"u{a}", f"i{b}", {"rating": float(c)},
             T0 + dt.timedelta(seconds=k))
            for k, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(),
                                              r.tolist()))]
    rows.append(("buy", "u1", "i2", {}, T0))
    return rows


def _seed(rows, port=True, reference=True):
    for ok, apps, app_cls, events, ev_cls in (
            (port, Storage.get_meta_data_apps, App, Storage.get_pevents,
             Event),
            (reference, JaxStorage.get_meta_data_apps, JaxApp,
             JaxStorage.get_pevents, JaxEvent)):
        if not ok:
            continue
        app_id = apps().insert(app_cls(0, APP))
        events().write([
            ev_cls(name, "user", u, "item", i, properties=p, event_time=t)
            for name, u, i, p, t in rows], app_id)


# ----------------------------------------------------------- folds: bitwise
@pytest.mark.parametrize("mode", ["rating", "hitrate"])
def test_read_eval_folds_match_reference(memory_storage, mode):
    _seed(_rows())
    got = TR.RecommendationDataSource(TR.DataSourceParams(
        app_name=APP, eval_k=3, eval_mode=mode, eval_num=5)).read_eval(
        ComputeContext.local(device="cpu"))
    want = JR.RecommendationDataSource(JR.DataSourceParams(
        app_name=APP, eval_k=3, eval_mode=mode, eval_num=5)).read_eval(
        JaxContext.local())
    assert len(got) == len(want) == 3
    for (td, info, qa), (jtd, jinfo, jqa) in zip(got, want):
        assert info == jinfo
        for col in ("user_ids", "item_ids", "ratings"):
            g, w = getattr(td, col), getattr(jtd, col)
            assert g.dtype == w.dtype and np.array_equal(g, w), col
        assert len(qa) == len(jqa) > 0
        for (q, a), (jq, ja) in zip(qa, jqa):
            assert (q.user, q.num, q.item, q.black_list) == (
                jq.user, jq.num, jq.item, jq.black_list)
            assert a == ja and type(a) is type(ja)


def test_split_data_matches_reference():
    data = list(range(11))
    args = (lambda xs: sum(xs), lambda d: (d, d * d))
    assert split_data(3, data, *args) == jax_split_data(3, data, *args)
    with pytest.raises(ValueError):
        split_data(1, data, *args)


# ------------------------------------------ metrics on the same predictions
def _metric_pair(base, jbase, one):
    port = type("M", (base,), {"calculate_one": lambda s, q, p, a: one(q, p, a)})
    ref = type("M", (jbase,), {"calculate_one": lambda s, q, p, a: one(q, p, a)})
    return port(), ref()


def _eval_set(seed=1):
    rng = np.random.default_rng(seed)
    return [({"fold": k}, [(q, float(p), float(a)) for q, p, a in zip(
        range(7 * k, 7 * k + 7), rng.normal(3, 1, 7), rng.integers(1, 6, 7))])
            for k in range(3)]


@pytest.mark.parametrize("base,jbase", [
    (AverageMetric, JaxAverage), (SumMetric, JaxSum),
    (StdevMetric, JaxStdev), (OptionAverageMetric, JaxOptionAverage),
])
def test_metrics_match_reference(base, jbase):
    def sq(q, p, a):
        return None if (base is OptionAverageMetric and q % 3 == 0) \
            else (p - a) ** 2

    port, ref = _metric_pair(base, jbase, sq)
    data = _eval_set()
    assert port.calculate(data) == ref.calculate(data)
    assert port.header == ref.header
    assert port.compare(1.0, 2.0) == ref.compare(1.0, 2.0) == -1


def test_squared_error_metric_matches_reference():
    port, ref = TR.SquaredErrorMetric(), JR.SquaredErrorMetric()
    assert port.higher_is_better is ref.higher_is_better is False
    data = [({"fold": 0}, [
        (None, TR.PredictedResult((TR.ItemScore("i1", 3.5),)), 4.0),
        (None, TR.PredictedResult(), 2.0),  # a cold user: skipped
        (None, TR.PredictedResult((TR.ItemScore("i2", 1.25),)), 1.0),
    ])]
    jdata = [({"fold": 0}, [
        (None, JR.PredictedResult(tuple(JR.ItemScore(s.item, s.score)
                                        for s in p.item_scores)), a)
        for _, p, a in data[0][1]])]
    assert port.calculate(data) == ref.calculate(jdata) == \
        (0.5 ** 2 + 0.25 ** 2) / 2
    assert np.isnan(port.calculate([({}, [(None, TR.PredictedResult(), 1)])]))


# --------------------------- Engine.eval and MetricEvaluator, a toy engine
def _toy(pkg):
    """One toy engine for each package: the data source's folds are fixed
    numbers, the model is the algorithm's ``scale``, a prediction is
    ``query * scale``."""

    @dataclasses.dataclass(frozen=True)
    class ScaleParams(pkg["Params"]):
        scale: float = 1.0

    class DS(pkg["DataSource"]):
        def read_training(self, ctx):
            return [1.0, 2.0]

        def read_eval(self, ctx):
            return [([1.0, float(k)], {"fold": k},
                     [(float(q), 2.0 * q + k) for q in range(1, 6)])
                    for k in range(3)]

    class Prep(pkg["Preparator"]):
        def prepare(self, ctx, td):
            return td

    class Algo(pkg["Algorithm"]):
        params_class = ScaleParams

        def train(self, ctx, pd):
            return self.params.scale + 0.0 * sum(pd)

        def predict(self, model, query):
            return query * model

    class SqErr(pkg["AverageMetric"]):
        higher_is_better = False

        def calculate_one(self, q, p, a):
            return (p - a) ** 2

    engine = pkg["Engine"](DS, Prep, {"algo": Algo}, pkg["FirstServing"])
    grid = [pkg["EngineParams"](algorithm_params_list=(("algo", ScaleParams(
        scale=s)),)) for s in (1.0, 2.5, 2.0, 3.0)]
    return engine, grid, SqErr()


PORT = dict(Params=Params, DataSource=C.DataSource, Preparator=C.Preparator,
            Algorithm=C.Algorithm, AverageMetric=AverageMetric,
            Engine=Engine, FirstServing=C.FirstServing,
            EngineParams=EngineParams)
REF = dict(Params=J.Params, DataSource=J.DataSource,
           Preparator=J.Preparator, Algorithm=J.Algorithm,
           AverageMetric=JaxAverage, Engine=J.Engine,
           FirstServing=J.FirstServing, EngineParams=J.EngineParams)


def test_engine_eval_matches_reference():
    engine, grid, _ = _toy(PORT)
    jengine, jgrid, _ = _toy(REF)
    got = engine.eval(ComputeContext.local(device="cpu"), grid[1])
    want = jengine.eval(JaxContext.local(), jgrid[1])
    assert got == want and len(got) == 3 and len(got[0][1]) == 5


@pytest.mark.parametrize("fast_eval", [True, False])
def test_metric_evaluator_matches_reference(fast_eval):
    engine, grid, metric = _toy(PORT)
    jengine, jgrid, jmetric = _toy(REF)
    got = MetricEvaluator(metric).evaluate(
        ComputeContext.local(device="cpu"), engine, grid, fast_eval=fast_eval)
    want = JaxEvaluator(jmetric).evaluate(
        JaxContext.local(), jengine, jgrid, fast_eval=fast_eval)
    assert [s.score for s in got.engine_params_scores] == [
        s.score for s in want.engine_params_scores]
    scores = [s.score for s in got.engine_params_scores]
    assert got.best_index == want.best_index == int(np.argmin(scores))
    assert got.best_score == want.best_score
    assert got.to_json() == want.to_json()


def test_metric_evaluator_rejects_all_nan():
    engine, grid, _ = _toy(PORT)
    nan = type("N", (AverageMetric,), {
        "calculate_one": lambda s, q, p, a: float("nan")})()
    with pytest.raises(ValueError, match="NaN"):
        MetricEvaluator(nan).evaluate(ComputeContext.local(device="cpu"),
                                      engine, grid)


# --------------------------------------- run_evaluation of the template
def test_run_evaluation_recommendation(memory_storage):
    """300 ratings, 2 folds, a 2×2 grid of 2 iterations each: the same
    result twice, each run recorded as a COMPLETED evaluation instance
    holding the result's JSON."""
    _seed(_rows(), reference=False)
    ev = TR.recommendation_evaluation(APP, eval_k=2, ranks=(2, 4),
                                      lambdas=(0.05, 0.5), num_iterations=2)
    ctx = ComputeContext.local(device="cpu")
    results = [run_evaluation(ev, ev.engine_params_generator, ctx=ctx)
               for _ in range(2)]
    scores = [[s.score for s in r.engine_params_scores] for r in results]
    assert scores[0] == scores[1] and len(scores[0]) == 4
    assert all(np.isfinite(scores[0]))
    assert results[0].best_index == results[1].best_index
    assert results[0].metric_header == "SquaredErrorMetric"
    done = Storage.get_meta_data_evaluation_instances().get_completed()
    assert len(done) == 2
    for inst in done:
        assert inst.status == RunStatus.COMPLETED
        assert inst.evaluation_class == "Evaluation"
        assert inst.engine_params_generator_class == "EngineParamsGenerator"
        body = json.loads(inst.evaluator_results_json)
        assert body["bestIndex"] == results[0].best_index
        assert inst.evaluator_results.startswith("SquaredErrorMetric: ")


def test_run_evaluation_records_failure(memory_storage):
    ev = TR.recommendation_evaluation("no-such-app", eval_k=2,
                                      num_iterations=1)
    with pytest.raises(ValueError, match="no-such-app"):
        run_evaluation(ev, ev.engine_params_generator,
                       ctx=ComputeContext.local(device="cpu"))
    (inst,) = Storage.get_meta_data_evaluation_instances().get_all()
    assert inst.status == RunStatus.FAILED
    assert "no-such-app" in inst.evaluator_results
    assert Storage.get_meta_data_evaluation_instances().get_completed() == []


def test_recommendation_evaluation_grid():
    ev = TR.recommendation_evaluation("some-app", eval_k=3, ranks=(8, 16),
                                      lambdas=(0.05, 0.1))
    assert isinstance(ev, Evaluation)
    assert isinstance(ev.engine_params_generator, EngineParamsGenerator)
    grid = ev.engine_params_generator.engine_params_list
    assert [(p.rank, p.lambda_) for (_, p), in
            (ep.algorithm_params_list for ep in grid)] == [
        (8, 0.05), (8, 0.1), (16, 0.05), (16, 0.1)]
    assert grid[0].data_source_params.eval_k == 3
    with pytest.raises(ValueError):
        TR.recommendation_evaluation("some-app", eval_k=1)


@pytest.mark.cuda
def test_card_run_evaluation_matches_cpu(memory_storage):
    """The sweep with the folds trained on the card against the CPU: the
    same best params, MSE within relative 1e-3 (ALS in another summation
    order; chip_smoke.py phase 17 states the limit)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _seed(_rows(), reference=False)
    ev = TR.recommendation_evaluation(APP, eval_k=2, ranks=(2, 4),
                                      lambdas=(0.05, 0.5), num_iterations=2)
    card, cpu = (run_evaluation(ev, ev.engine_params_generator,
                                ctx=ComputeContext.local(device=d))
                 for d in ("cuda", "cpu"))
    assert card.best_index == cpu.best_index
    np.testing.assert_allclose(
        [s.score for s in card.engine_params_scores],
        [s.score for s in cpu.engine_params_scores], rtol=1e-3)
