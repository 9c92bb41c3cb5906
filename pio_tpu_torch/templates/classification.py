"""Classification template — label prediction from entity attributes.

Counterpart of ``pio_tpu/templates/classification.py`` (the reference's
``scala-parallel-classification``): the data source reads ``$set`` user
properties ``attr0..attr2`` and the ``plan`` label through
``aggregate_properties``; two algorithms, selectable in engine.json:

- ``naivebayes`` — multinomial NB (:func:`~pio_tpu_torch.models.
  naive_bayes.train_multinomial_nb`), its per-class sums one product on
  the context's device;
- ``logreg`` — softmax regression, full-batch Adam on the context's device
  (:func:`~pio_tpu_torch.models.logreg.train_logreg`).

Both serve ``argmax(x·W + b)``. Deployed through the query server with
residency enabled (:mod:`pio_tpu_torch.server.residency`), a model's
``W`` and ``b`` stay on the serving device and each query ships its
features there, as int8 codes when the model carries training scales;
otherwise the model scores on the host in numpy.

Evaluation (``pio eval``): :func:`classification_evaluation`, k-fold
accuracy (:class:`AccuracyMetric`) over NB's smoothing.

engine.json:

    {
      "id": "classification",
      "engineFactory": "templates.classification",
      "datasource": {"params": {"app_name": "myapp"}},
      "algorithms": [{"name": "naivebayes", "params": {"lambda_": 1.0}}]
    }

Query ``{"attr0": 2, "attr1": 0, "attr2": 0}`` → ``{"label": "..."}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from pio_tpu_torch.controller.components import (
    Algorithm,
    DataSource,
    FirstServing,
    Preparator,
    SanityCheck,
)
from pio_tpu_torch.controller.cross_validation import split_data
from pio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    register_engine,
)
from pio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from pio_tpu_torch.controller.metrics import AverageMetric
from pio_tpu_torch.controller.params import Params
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.logreg import LogRegConfig, LogRegModel, train_logreg
from pio_tpu_torch.models.naive_bayes import (
    MultinomialNBModel,
    train_multinomial_nb,
)
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.residency import ResidentLinearScorer
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.common import eval_app_name, resolve_app


# --------------------------------------------------------------- data source
@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    app_id: int = 0
    channel: str = ""
    entity_type: str = "user"
    #: numeric feature attributes read off each entity's PropertyMap
    attrs: Tuple[str, ...] = ("attr0", "attr1", "attr2")
    #: label attribute (reference template's "plan")
    label_attr: str = "plan"
    eval_k: int = 0


@dataclasses.dataclass
class TrainingData(SanityCheck):
    features: np.ndarray  # [n, d] float32
    labels: np.ndarray  # [n] str objects

    def sanity_check(self) -> None:
        if len(self.labels) == 0:
            raise ValueError(
                "TrainingData is empty - no entities with the required "
                "attributes. Did you $set properties for this app?"
            )

    def __len__(self):
        return len(self.labels)


class ClassificationDataSource(DataSource):
    """aggregateProperties → dense feature matrix + label column, in
    entity-id order."""

    params_class = DataSourceParams

    def _read(self) -> TrainingData:
        p: DataSourceParams = self.params
        app_id, channel_id = resolve_app(p)
        props = Storage.get_pevents().aggregate_properties(
            app_id,
            entity_type=p.entity_type,
            channel_id=channel_id,
            required=list(p.attrs) + [p.label_attr],
        )
        feats = np.zeros((len(props), len(p.attrs)), np.float32)
        labels = np.empty(len(props), object)
        for i, (_eid, pm) in enumerate(sorted(props.items())):
            for j, a in enumerate(p.attrs):
                feats[i, j] = float(pm.get(a))
            labels[i] = str(pm.get(p.label_attr))
        return TrainingData(features=feats, labels=labels)

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        return self._read()

    def read_eval(self, ctx: ComputeContext):
        """k-fold split by entity index (``split_data``): each held-out
        entity's attributes are a query, its label the actual."""
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            return []
        td = self._read()
        rows = list(zip(td.features, td.labels))
        return split_data(
            p.eval_k,
            rows,
            to_training_data=lambda rs: TrainingData(
                features=np.array([f for f, _ in rs], np.float32).reshape(
                    len(rs), td.features.shape[1]
                ),
                labels=np.array([label for _, label in rs], object),
            ),
            to_query_actual=lambda r: (
                Query(attrs=tuple(float(x) for x in r[0])),
                str(r[1]),
            ),
        )


# --------------------------------------------------------------- preparator
@dataclasses.dataclass
class PreparedData:
    features: np.ndarray  # [n, d] float32
    label_codes: np.ndarray  # [n] int32
    label_index: BiMap


class ClassificationPreparator(Preparator):
    """String labels → dense codes (BiMap); features pass through."""

    def prepare(self, ctx: ComputeContext, td: TrainingData) -> PreparedData:
        label_index = BiMap.string_int(td.labels.tolist())
        fwd = label_index.to_dict()
        codes = np.fromiter(
            (fwd[label] for label in td.labels.tolist()), np.int32, len(td)
        )
        return PreparedData(td.features, codes, label_index)


# ----------------------------------------------------------------- algorithm
@dataclasses.dataclass(frozen=True)
class Query:
    attrs: Tuple[float, ...] = ()
    # individual attr fields for engine.json-style queries
    attr0: Optional[float] = None
    attr1: Optional[float] = None
    attr2: Optional[float] = None

    def vector(self, dim: int) -> np.ndarray:
        if self.attrs:
            vals = self.attrs
        else:
            vals = tuple(
                v for v in (self.attr0, self.attr1, self.attr2)
                if v is not None
            )
        if len(vals) != dim:
            raise ValueError(
                f"query has {len(vals)} attrs, model expects {dim}"
            )
        return np.asarray(vals, np.float32)[None, :]


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: str = ""

    def to_dict(self) -> dict:
        return {"label": self.label}


class _ResidentModel:
    """A classifier model the query server may attach a resident scorer
    to (``_resident``); pickling drops the scorer, which holds device
    tensors and a lock."""

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_resident", None)
        return d


@dataclasses.dataclass(frozen=True)
class NaiveBayesParams(Params):
    lambda_: float = 1.0  # Laplace smoothing (reference param "lambda")


@dataclasses.dataclass
class NBClassifierModel(_ResidentModel):
    nb: MultinomialNBModel
    label_index: BiMap
    dim: int


class NaiveBayesAlgorithm(Algorithm):
    """Multinomial NB (≙ reference NaiveBayesAlgorithm → MLlib NaiveBayes)."""

    params_class = NaiveBayesParams
    query_class = Query

    def train(self, ctx: ComputeContext, pd: PreparedData) -> NBClassifierModel:
        p: NaiveBayesParams = self.params
        nb = train_multinomial_nb(
            pd.features,
            pd.label_codes,
            n_classes=len(pd.label_index),
            lambda_=p.lambda_,
            device=ctx.device,
        )
        return NBClassifierModel(nb, pd.label_index, pd.features.shape[1])

    def predict(self, model: NBClassifierModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: NBClassifierModel, queries):
        """One scoring call for the whole batch: the resident scorer's
        dispatch, or the host model's ``[B, d]`` predict."""
        return _batch_label_results(model, queries, model.nb.predict)

    def warmup_query(self, model: NBClassifierModel) -> Query:
        return Query(attrs=(0.0,) * model.dim)

    def resident_scorer(self, model: NBClassifierModel, device):
        return _linear_resident(
            "naivebayes", model, model.nb.log_theta.T, model.nb.log_prior,
            model.nb.feature_scales, device,
        )


@dataclasses.dataclass(frozen=True)
class LogRegParams(Params):
    iterations: int = 200
    learning_rate: float = 0.1
    reg: float = 0.0
    seed: int = 0
    #: feature wire type — "float32" (default, exact), "bfloat16" (half
    #: the host→device bytes) or "int8" (a quarter: per-column scales
    #: fold into the weights, so the model still serves raw features)
    input_dtype: str = "float32"


@dataclasses.dataclass
class LogRegClassifierModel(_ResidentModel):
    lr: LogRegModel
    label_index: BiMap
    dim: int


class LogisticRegressionAlgorithm(Algorithm):
    """Softmax regression (≙ the LogisticRegressionWithLBFGS variant)."""

    params_class = LogRegParams
    splits_over_group = True
    query_class = Query

    def train(
        self, ctx: ComputeContext, pd: PreparedData
    ) -> LogRegClassifierModel:
        p: LogRegParams = self.params
        lr = train_logreg(
            ctx,
            pd.features,
            pd.label_codes,
            n_classes=len(pd.label_index),
            config=LogRegConfig(
                iterations=p.iterations,
                learning_rate=p.learning_rate,
                reg=p.reg,
                seed=p.seed,
                input_dtype=p.input_dtype,
            ),
        )
        return LogRegClassifierModel(lr, pd.label_index, pd.features.shape[1])

    def predict(
        self, model: LogRegClassifierModel, query: Query
    ) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: LogRegClassifierModel, queries):
        """One scoring call for the whole batch."""
        return _batch_label_results(model, queries, model.lr.predict)

    def warmup_query(self, model: LogRegClassifierModel) -> Query:
        return Query(attrs=(0.0,) * model.dim)

    def resident_scorer(self, model: LogRegClassifierModel, device):
        return _linear_resident(
            "logreg", model, model.lr.weights, model.lr.bias,
            model.lr.feature_scales, device,
        )


def _linear_resident(name, model, weights, bias, scales, device):
    """The resident scorer of either linear classifier, with the
    template's factories: a Query from a dequantized feature row, and a
    class code straight to its label (both classifiers serve through
    FirstServing, whose supplement is the identity, so a wire-codes
    dispatch answers as the full path would). Over the query server's
    serving mesh (``model._serve_mesh``, reference l.354) the scorer
    row-shards its weights."""
    inv = model.label_index.inverse
    return ResidentLinearScorer(
        weights, bias, scales=scales, name=name, device=device,
        mesh=model.__dict__.get("_serve_mesh"),
        query_factory=lambda x: Query(
            attrs=tuple(float(v) for v in np.asarray(x).reshape(-1))
        ),
        result_factory=lambda c: PredictedResult(label=inv[int(c)]),
    )


def _batch_label_results(model, queries, host_predict):
    """Shared tail of the attribute classifiers: stack the query vectors,
    one scoring call — the model's resident scorer where the query server
    attached one, else ``host_predict`` — and map codes back to labels. A
    query of the wrong arity raises, as a single one would."""
    if not queries:
        return []
    # vector() yields [1, d] rows; concatenate → [B, d]
    X = np.concatenate([q.vector(model.dim) for _, q in queries])
    scorer = getattr(model, "_resident", None)
    codes = scorer.score_codes(X) if scorer is not None else host_predict(X)
    inv = model.label_index.inverse
    return [
        (i, PredictedResult(label=inv[int(c)]))
        for (i, _), c in zip(queries, codes)
    ]


class ClassificationServing(FirstServing):
    pass


@register_engine("templates.classification")
def classification_engine() -> Engine:
    return Engine(
        ClassificationDataSource,
        ClassificationPreparator,
        {
            "naivebayes": NaiveBayesAlgorithm,
            "logreg": LogisticRegressionAlgorithm,
        },
        ClassificationServing,
    )


# -------------------------------------------------------------- evaluation
class AccuracyMetric(AverageMetric):
    """Fraction of held-out entities whose predicted label matches
    (the reference classification template's Evaluation.scala metric)."""

    def calculate_one(self, query, prediction, actual):
        return 1.0 if prediction.label == actual else 0.0


def classification_evaluation(
    app_name: str = "",
    eval_k: int = 3,
    lambdas=(0.5, 1.0, 2.0),
):
    """Ready-made ``pio eval`` sweep over the app ``app_name``
    (``$PIO_TPU_EVAL_APP`` when empty): k-fold
    accuracy over the naive-Bayes smoothing grid (the reference template's
    quickstart evaluation). Run it with ``run_evaluation(ev,
    ev.engine_params_generator)``."""
    if eval_k < 2:
        raise ValueError("k-fold evaluation needs eval_k >= 2")
    app_name = eval_app_name(app_name)
    ds = DataSourceParams(app_name=app_name, eval_k=eval_k)
    grid = [
        EngineParams(
            data_source_params=ds,
            algorithm_params_list=(
                ("naivebayes", NaiveBayesParams(lambda_=lam)),
            ),
        )
        for lam in lambdas
    ]
    return Evaluation(
        classification_engine(), AccuracyMetric(),
        engine_params_generator=EngineParamsGenerator(grid),
    )
