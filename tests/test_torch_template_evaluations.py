"""The ``pio eval`` sweeps of the similar-product, e-commerce and
text-classification templates in the port against the JAX package's, on
the CPU, in memory storage.

- The metrics (``HitRateMetric``, ``TextAccuracyMetric``) give the
  reference's scores on the same predictions, exactly.
- The text template's ``read_eval`` gives the reference's folds.
- Each sweep runs through ``run_evaluation`` in both packages on
  block-structured data with a grid whose points differ by far more than
  the two packages' training differences (rank 1 against 4 on two item
  blocks; hidden width 1 against 16 on four labels): the same best params.
- The text sweep prepares each fold once for every width (FastEval).
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.templates import ecommerce as JE
from pio_tpu.templates import similarproduct as JS
from pio_tpu.templates import textclassification as JT
from pio_tpu.workflow import run_evaluation as jax_run_evaluation
from pio_tpu_torch.controller.evaluation import EngineParamsGenerator
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import RunStatus
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates import ecommerce as TE
from pio_tpu_torch.templates import similarproduct as TS
from pio_tpu_torch.templates import textclassification as TT
from pio_tpu_torch.workflow.core_workflow import run_evaluation
from test_torch_similarproduct import (  # noqa: F401  (fixture)
    T0,
    memory_storage,
    seed_events,
)

APP = "eval-app"


def grouped_views(n_users=12, n_items=8, per_user=8):
    """tests/test_template_evaluations.py's data: user u views items of
    group u % 2 (i0-3 'tech', i4-7 'food'), repeatedly."""
    rows = [("$set", "item", f"i{i}", None,
             {"categories": ["tech" if i < 4 else "food"]}, T0)
            for i in range(n_items)]
    rng = np.random.default_rng(0)
    k = 0
    for u in range(n_users):
        lo = 0 if u % 2 == 0 else 4
        for _ in range(per_user):
            rows.append(("view", "user", f"u{u}", f"i{lo + rng.integers(4)}",
                         {}, T0 + dt.timedelta(minutes=k)))
            k += 1
    return rows


LABELS = ("sport", "tech", "food", "art")


def documents(n=60, seed=0):
    """n $set documents over four labels: three words of the label's own
    eight and six of 30 shared words each."""
    rng = np.random.default_rng(seed)
    shared = [f"w{k}" for k in range(30)]
    rows = []
    for d in range(n):
        label = LABELS[d % len(LABELS)]
        words = list(rng.choice([f"{label}{k}" for k in range(8)], 3)) \
            + list(rng.choice(shared, 6))
        rows.append(("$set", "content", f"doc{d}", None,
                     {"text": " ".join(words), "label": label},
                     T0 + dt.timedelta(minutes=d)))
    return rows


def scores(result):
    return [s.score for s in result.engine_params_scores]


# ------------------------------------------------------------- metrics
def test_hit_rate_matches_reference():
    preds = [("a", "b"), ("c",), (), ("a",)]
    actual = ["b", "a", "a", "a"]

    def data(pkg):
        return [({"fold": 0}, [
            (None, pkg.PredictedResult(tuple(pkg.ItemScore(i, 1.0)
                                             for i in p)), a)
            for p, a in zip(preds, actual)])]

    from pio_tpu.templates import common as jax_common
    from pio_tpu_torch.templates import common

    got = TS.HitRateMetric().calculate(data(common))
    assert got == JS.HitRateMetric().calculate(data(jax_common)) == 0.5


def test_text_accuracy_matches_reference():
    labels = [("a", "a"), ("b", "a"), ("c", "c")]

    def data(pkg):
        return [({"fold": 0}, [(None, pkg.PredictedResult(label=p), a)
                               for p, a in labels])]

    assert TT.TextAccuracyMetric().calculate(data(TT)) == \
        JT.TextAccuracyMetric().calculate(data(JT)) == 2 / 3
    assert TT.TextAccuracyMetric().header == JT.TextAccuracyMetric().header


# --------------------------------------------------------- text folds
def test_text_read_eval_folds_match_reference(memory_storage):
    seed_events(documents(n=20), app=APP)
    got = TT.TextDataSource(TT.DataSourceParams(
        app_name=APP, eval_k=3)).read_eval(ComputeContext.local(device="cpu"))
    want = JT.TextDataSource(JT.DataSourceParams(
        app_name=APP, eval_k=3)).read_eval(JaxContext.local())
    assert len(got) == len(want) == 3
    for (td, info, qa), (jtd, jinfo, jqa) in zip(got, want):
        assert info == jinfo
        assert (td.texts, td.labels) == (jtd.texts, jtd.labels)
        assert [(q.text, a) for q, a in qa] == [(q.text, a) for q, a in jqa]
    assert TT.TextDataSource(TT.DataSourceParams(app_name=APP)).read_eval(
        ComputeContext.local(device="cpu")) == []


# ------------------------------------------------- sweeps, both packages
SWEEPS = {
    "similarproduct": (
        grouped_views,
        lambda: TS.similarproduct_evaluation(
            APP, eval_k=3, ranks=(1, 4), num_iterations=8, eval_num=2),
        lambda: JS.similarproduct_evaluation(
            APP, eval_k=3, ranks=(1, 4), num_iterations=8, eval_num=2)),
    "ecommerce": (
        grouped_views,
        lambda: TE.ecommerce_evaluation(
            APP, eval_k=3, ranks=(1, 4), num_iterations=8, eval_num=2),
        lambda: JE.ecommerce_evaluation(
            APP, eval_k=3, ranks=(1, 4), num_iterations=8, eval_num=2)),
    "textclassification": (
        documents,
        lambda: TT.textclassification_evaluation(APP, eval_k=3,
                                                 hiddens=(1, 16)),
        lambda: JT.textclassification_evaluation(APP, eval_k=3,
                                                 hiddens=(1, 16))),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_best_params_match_reference(memory_storage, name):
    """Both packages pick the same grid point, by a clear margin (the
    losing point scores at least 0.2 below on both)."""
    rows, port_ev, ref_ev = SWEEPS[name]
    seed_events(rows(), app=APP)
    ev, jev = port_ev(), ref_ev()
    got = run_evaluation(ev, ev.engine_params_generator,
                         ctx=ComputeContext.create(device="cpu"))
    want = jax_run_evaluation(jev, jev.engine_params_generator,
                              ctx=JaxContext.create())
    assert got.best_index == want.best_index == 1
    for s in (scores(got), scores(want)):
        assert s[1] - s[0] > 0.2, s
    assert got.metric_header == want.metric_header
    (inst,) = Storage.get_meta_data_evaluation_instances().get_completed()
    assert inst.status == RunStatus.COMPLETED


def test_text_sweep_prepares_once_a_fold(memory_storage, monkeypatch):
    """Two widths, three folds: three prepares, six trainings."""
    seed_events(documents(n=24), app=APP)
    calls = {"prepare": 0, "train": 0}
    for cls, meth in ((TT.TextPreparator, "prepare"),
                      (TT.MLPAlgorithm, "train")):
        orig = getattr(cls, meth)

        def counted(self, *a, _orig=orig, _name=meth):
            calls[_name] += 1
            return _orig(self, *a)

        monkeypatch.setattr(cls, meth, counted)
    ev = TT.textclassification_evaluation(APP, eval_k=3, hiddens=(4, 8))
    res = run_evaluation(ev, ev.engine_params_generator,
                         ctx=ComputeContext.local(device="cpu"))
    assert calls == {"prepare": 3, "train": 6}
    assert all(0.0 <= s <= 1.0 for s in scores(res))


@pytest.mark.parametrize("factory,param,field", [
    (TS.similarproduct_evaluation, "ranks", "rank"),
    (TE.ecommerce_evaluation, "ranks", "rank"),
    (TT.textclassification_evaluation, "hiddens", "hidden"),
])
def test_evaluation_grids(factory, param, field, monkeypatch):
    ev = factory("some-app", eval_k=4, **{param: (3, 5)})
    assert isinstance(ev.engine_params_generator, EngineParamsGenerator)
    grid = ev.engine_params_generator.engine_params_list
    assert [getattr(ep.algorithm_params_list[0][1], field)
            for ep in grid] == [3, 5]
    ds = grid[0].data_source_params
    assert (ds.app_name, ds.eval_k) == ("some-app", 4)
    if factory is TE.ecommerce_evaluation:  # the live reads need the app
        assert grid[0].algorithm_params_list[0][1].app_name == "some-app"
    with pytest.raises(ValueError, match="eval_k >= 2"):
        factory("some-app", eval_k=1)
    # zero-arg CLI use reads the app from PIO_TPU_EVAL_APP, as in the
    # reference (pio_tpu/templates/common.py:eval_app_name)
    monkeypatch.setenv("PIO_TPU_EVAL_APP", "env-app")
    grid = factory().engine_params_generator.engine_params_list
    assert grid[0].data_source_params.app_name == "env-app"
    if factory is TE.ecommerce_evaluation:
        assert grid[0].algorithm_params_list[0][1].app_name == "env-app"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_card_sweep_matches_cpu(memory_storage, name):
    """Each sweep trained on the card against the CPU: the same best
    params; HitRate and accuracy within 0.1 (a near-tie may flip one
    held-out answer in 30-60)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, port_ev, _ = SWEEPS[name]
    seed_events(rows(), app=APP, reference=False)
    ev = port_ev()
    card, cpu = (run_evaluation(ev, ev.engine_params_generator,
                                ctx=ComputeContext.local(device=d))
                 for d in ("cuda", "cpu"))
    assert card.best_index == cpu.best_index
    np.testing.assert_allclose(scores(card), scores(cpu), atol=0.1)
    assert dataclasses.asdict(card.best_engine_params.data_source_params) \
        == dataclasses.asdict(cpu.best_engine_params.data_source_params)
