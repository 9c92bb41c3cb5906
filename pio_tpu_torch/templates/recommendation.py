"""Recommendation template — ALS on rate/buy events.

Counterpart of ``pio_tpu/templates/recommendation.py``: read ``rate`` and
``buy`` events, index string ids densely (items by descending
popularity), factorize with ALS on the context's device
(:mod:`pio_tpu_torch.models.als`), serve top-N item scores per user from a
scorer resident on the model's device (:mod:`pio_tpu_torch.ops.topn`).

engine.json:

    {
      "id": "recommendation",
      "engineFactory": "templates.recommendation",
      "datasource": {"params": {"app_name": "myapp"}},
      "algorithms": [{"name": "als", "params":
          {"rank": 10, "num_iterations": 10, "lambda_": 0.01, "seed": 3}}]
    }

Query ``{"user": "u1", "num": 4}`` →
``{"itemScores": [{"item": "i5", "score": 3.2}, ...]}``.

Evaluation (``pio eval``): :func:`recommendation_evaluation` is a k-fold
sweep over a rank × lambda grid scored by :class:`SquaredErrorMetric`,
run by ``pio_tpu_torch.workflow.core_workflow.run_evaluation``.
:class:`ALSModel` is a ``ShardableModel``: under
``PIO_TPU_SHARDED_PERSIST=1`` its factor tables persist as per-shard
records and a shard manifest (``workflow/shard_store.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.controller.components import (
    Algorithm,
    DataSource,
    FirstServing,
    Preparator,
    SanityCheck,
)
from pio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    register_engine,
)
from pio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from pio_tpu_torch.controller.metrics import OptionAverageMetric
from pio_tpu_torch.controller.params import Params
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.als import ALSConfig, ALSFactors, train_als
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.frame import EventFrame
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.workflow.shard_store import ShardableModel
from pio_tpu_torch.templates.common import (
    DeviceScorerModel,
    ItemScore,
    PredictedResult,
    dedup_pair_indices,
    eval_app_name,
    fold_assignments,
    resolve_app,
    seen_exclusion_holdout,
)


# --------------------------------------------------------------- data source
@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    app_id: int = 0  # alternative to app_name
    channel: str = ""  # optional named channel
    #: events read as ratings; ``buy`` is an implicit ``buy_rating``
    rate_event: str = "rate"
    buy_event: str = "buy"
    buy_rating: float = 4.0
    eval_k: int = 0  # >0 enables k-fold read_eval
    #: eval protocol: "rating" scores held-out ratings; "hitrate" asks
    #: top-``eval_num`` recommendations and scores held-out item hits
    eval_mode: str = "rating"
    eval_num: int = 10


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_ids: np.ndarray  # [n] str objects
    item_ids: np.ndarray  # [n] str objects
    ratings: np.ndarray  # [n] float32

    def sanity_check(self) -> None:
        if len(self.ratings) == 0:
            raise ValueError(
                "TrainingData is empty - no rate/buy events found. "
                "Did you import events for this app?"
            )

    def __len__(self):
        return len(self.ratings)


class RecommendationDataSource(DataSource):
    """Bulk columnar read (``find_frame``) → ratings."""

    params_class = DataSourceParams

    def _read_frame(self) -> EventFrame:
        p: DataSourceParams = self.params
        app_id, channel_id = resolve_app(p)
        return Storage.get_pevents().find_frame(
            app_id,
            channel_id=channel_id,
            event_names=[p.rate_event, p.buy_event],
            entity_type="user",
            target_entity_type="item",
        )

    def _to_training_data(self, frame: EventFrame) -> TrainingData:
        p: DataSourceParams = self.params
        ratings = frame.property_column("rating", default=np.nan)
        is_buy = frame.event == p.buy_event
        ratings = np.where(is_buy, np.float32(p.buy_rating), ratings)
        # drop rate events with no rating property
        keep = ~np.isnan(ratings)
        return TrainingData(
            user_ids=frame.entity_id[keep],
            item_ids=frame.target_entity_id[keep],
            ratings=ratings[keep].astype(np.float32),
        )

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        return self._to_training_data(self._read_frame())

    def read_eval(self, ctx: ComputeContext):
        """k-fold split by rating index: ``[(training data, fold info,
        [(query, actual)])]`` per fold."""
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            return []
        if p.eval_k == 1:
            # k=1 would leave every training fold empty
            raise ValueError("k-fold cross-validation needs eval_k >= 2")
        if p.eval_mode not in ("rating", "hitrate"):
            raise ValueError(
                f"eval_mode must be 'rating' or 'hitrate', got {p.eval_mode!r}"
            )
        td_all = self._to_training_data(self._read_frame())
        if p.eval_mode == "hitrate":
            # a repeated (user, item) pair split across folds would leak
            # the held-out pair into training
            keep = dedup_pair_indices(td_all.user_ids, td_all.item_ids)
            td_all = TrainingData(
                user_ids=td_all.user_ids[keep],
                item_ids=td_all.item_ids[keep],
                ratings=td_all.ratings[keep],
            )
        fold_of = fold_assignments(len(td_all), p.eval_k)
        folds = []
        for k in range(p.eval_k):
            train = fold_of != k
            test = ~train
            td = TrainingData(
                user_ids=td_all.user_ids[train],
                item_ids=td_all.item_ids[train],
                ratings=td_all.ratings[train],
            )
            if p.eval_mode == "hitrate":
                qa = seen_exclusion_holdout(
                    td.user_ids, td.item_ids,
                    td_all.user_ids[test], td_all.item_ids[test],
                    lambda u, bl: Query(
                        user=u, num=p.eval_num, black_list=bl
                    ),
                )
            else:
                qa = [
                    (Query(user=str(u), num=1, item=str(i)), float(r))
                    for u, i, r in zip(
                        td_all.user_ids[test],
                        td_all.item_ids[test],
                        td_all.ratings[test],
                    )
                ]
            folds.append((td, {"fold": k}, qa))
        return folds


# --------------------------------------------------------------- preparator
@dataclasses.dataclass
class PreparedData:
    user_index: BiMap
    item_index: BiMap
    user_codes: np.ndarray  # [n] int32
    item_codes: np.ndarray  # [n] int32
    ratings: np.ndarray  # [n] float32


class RecommendationPreparator(Preparator):
    """String ids → dense codes; items by descending popularity (hot rows
    cluster at the low end of the factor table, and the delta item wire
    gets smaller gaps)."""

    def prepare(self, ctx: ComputeContext, td: TrainingData) -> PreparedData:
        user_index = BiMap.string_int(td.user_ids.tolist())
        item_index = BiMap.string_int_by_frequency(td.item_ids.tolist())
        ufwd, ifwd = user_index.to_dict(), item_index.to_dict()
        user_codes = np.fromiter(
            (ufwd[u] for u in td.user_ids.tolist()), np.int32, len(td)
        )
        item_codes = np.fromiter(
            (ifwd[i] for i in td.item_ids.tolist()), np.int32, len(td)
        )
        return PreparedData(
            user_index, item_index, user_codes, item_codes, td.ratings
        )


# --------------------------------------------------------------- algorithm
@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = 10
    item: str = ""  # when set, score just this item (used by eval)
    #: items to exclude from the top-N, masked on the device before the
    #: top-k (not filtered afterwards)
    black_list: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01  # engine.json key "lambda_" (lambda is reserved)
    seed: int = 3
    implicit_prefs: bool = False
    alpha: float = 1.0


@dataclasses.dataclass
class ALSModel(DeviceScorerModel, ShardableModel):
    """Factors as float32 tensors on the serving device, with the id maps.

    Persisted as host arrays; ``load_models_for_instance`` puts the
    tensors back on its context's device, and the scorer follows them.
    With ``PIO_TPU_SHARDED_PERSIST=1`` both factor tables persist as
    row shards (``workflow/shard_store.py``, the ``als`` partition rules;
    reference l.249-270). Served over a serving mesh (``_serve_mesh``),
    the sharded scorer holds the device copy and the model keeps the
    host tables.
    """

    factors: ALSFactors  # user_factors, item_factors: tensors, one device
    user_index: BiMap
    item_index: BiMap

    shard_template = "als"

    def shard_arrays(self):
        return {
            "user_factors": self.factors.user_factors,
            "item_factors": self.factors.item_factors,
        }

    def replace_shard_arrays(self, arrays):
        return dataclasses.replace(self, factors=ALSFactors(
            user_factors=arrays["user_factors"],
            item_factors=arrays["item_factors"],
        ))

    def _release_device_tables(self, rows, cols) -> None:
        self.factors = ALSFactors(user_factors=torch.from_numpy(rows),
                                  item_factors=torch.from_numpy(cols))

    @staticmethod
    def from_factors(factors: ALSFactors, user_index: BiMap,
                     item_index: BiMap, device: DeviceLike = None
                     ) -> "ALSModel":
        """The model of host (or any-device) factors, placed on ``device``."""
        dev = resolve_device(device)

        def placed(table):
            if isinstance(table, torch.Tensor):
                return table.detach().to(dev, torch.float32)
            return torch.from_numpy(np.array(table, np.float32)).to(dev)

        return ALSModel(
            ALSFactors(user_factors=placed(factors.user_factors),
                       item_factors=placed(factors.item_factors)),
            user_index, item_index,
        )

    def _scorer_factors(self):
        return self.factors.user_factors, self.factors.item_factors


class ALSAlgorithm(Algorithm):
    """ALS on the context's device (≙ reference ALSAlgorithm.train →
    MLlib ALS.train)."""

    params_class = ALSAlgorithmParams
    splits_over_group = True
    query_class = Query

    def train(self, ctx: ComputeContext, pd: PreparedData) -> ALSModel:
        p: ALSAlgorithmParams = self.params
        factors = train_als(
            ctx,
            pd.user_codes,
            pd.item_codes,
            pd.ratings,
            n_users=len(pd.user_index),
            n_items=len(pd.item_index),
            config=ALSConfig(
                rank=p.rank,
                iterations=p.num_iterations,
                reg=p.lambda_,
                implicit=p.implicit_prefs,
                alpha=p.alpha,
                seed=p.seed,
            ),
        )
        return ALSModel.from_factors(
            factors, pd.user_index, pd.item_index, ctx.device
        )

    def prepare_for_serving(self, model: ALSModel) -> ALSModel:
        """Build the scorer on the model's device at deploy, and pay its
        first-call costs there rather than in the first request."""
        model.scorer(warmup=True)
        return model

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return predict_user_topn(
            model, query, model.user_index, model.item_index
        )

    def warmup_query(self, model: ALSModel) -> Optional[Query]:
        """Any known user exercises the top-N path."""
        if len(model.user_index) == 0:
            return None
        return Query(user=model.user_index.inverse[0])

    def batch_predict(self, model: ALSModel, queries):
        """Known-user top-N queries batch into one device call per chunk;
        unknown users and single-item queries take the per-query path."""
        return batched_user_topn(
            self, model, queries, model.user_index, model.item_index,
            model.scorer,
        )


def _result_from_topn(idx, vals, item_index: BiMap) -> PredictedResult:
    """(top-n indices, scores) → PredictedResult. Non-finite scores are
    dropped: when a black_list leaves fewer than n items, the excluded
    slots surface at -inf and are not served."""
    inv = item_index.inverse
    return PredictedResult(
        tuple(
            ItemScore(inv[int(i)], float(v))
            for i, v in zip(idx, vals)
            if np.isfinite(v)
        )
    )


def predict_user_topn(model, query, user_index: BiMap,
                      item_index: BiMap) -> PredictedResult:
    """Online predict of a user → top-N recommender: the unknown-user
    guard, the single-item pair branch, the num <= 0 guard and the scorer
    call, in one place for the online and batched paths."""
    code = user_index.get(query.user)
    if code is None:
        return PredictedResult()  # unknown user: empty result
    if query.item:
        icode = item_index.get(query.item)
        if icode is None:
            return PredictedResult()
        score = model.scorer().score_pairs([code], [icode])[0]
        return PredictedResult((ItemScore(query.item, float(score)),))
    if query.num <= 0:
        return PredictedResult()
    scorer = model.scorer()
    idx, vals = scorer.top_n_batch(
        np.asarray([code], np.int32), query.num,
        exclude=_exclude_rows([query], item_index, scorer.n_cols),
    )
    return _result_from_topn(idx[0], vals[0], item_index)


def _exclude_rows(queries, item_index: BiMap, sentinel: int):
    """Per-query black_list item ids → padded ``[B, E]`` exclusion codes
    (sentinel-filled; None when no query excludes anything)."""
    lists = [
        [
            c for c in (item_index.get(i) for i in q.black_list)
            if c is not None
        ]
        for q in queries
    ]
    width = max((len(ls) for ls in lists), default=0)
    if width == 0:
        return None
    out = np.full((len(lists), width), sentinel, np.int32)
    for r, ls in enumerate(lists):
        out[r, : len(ls)] = ls
    return out


def batched_user_topn(algo, model, queries, user_index, item_index, scorer):
    """batch_predict routing of a user → top-N recommender: known-user
    top-N queries go through the scorer together, and so do the
    single-item queries of a known user and item (one ``score_pairs``
    call, an evaluation fold's whole query set); unknown users, unknown
    items and ``num <= 0`` take ``algo.predict``. ``scorer`` may be a
    zero-argument callable (``model.scorer``), then resolved only when a
    batchable query exists."""
    out = []
    bidx, bcodes, bq = [], [], []
    pidx, prow, pcol, pq = [], [], [], []
    for i, q in queries:
        code = user_index.get(q.user)
        icode = item_index.get(q.item) if q.item else None
        if code is not None and icode is not None:
            pidx.append(i)
            prow.append(code)
            pcol.append(icode)
            pq.append(q)
        elif code is None or q.item or q.num <= 0:
            out.append((i, algo.predict(model, q)))
        else:
            bidx.append(i)
            bcodes.append(code)
            bq.append(q)
    if (bcodes or prow) and callable(scorer):
        scorer = scorer()
    if prow:
        scores = scorer.score_pairs(np.asarray(prow, np.int32),
                                    np.asarray(pcol, np.int32))
        for i, q, v in zip(pidx, pq, scores):
            out.append((i, PredictedResult((ItemScore(q.item, float(v)),))))
    if bcodes:
        kmax = max(q.num for q in bq)
        idx, vals = scorer.top_n_batch(
            np.asarray(bcodes, np.int32), kmax,
            exclude=_exclude_rows(bq, item_index, scorer.n_cols),
        )
        for i, q, ri, rv in zip(bidx, bq, idx, vals):
            out.append(
                (i, _result_from_topn(ri[:q.num], rv[:q.num], item_index))
            )
    return out


class RecommendationServing(FirstServing):
    pass


@register_engine("templates.recommendation")
def recommendation_engine() -> Engine:
    return Engine(
        RecommendationDataSource,
        RecommendationPreparator,
        {"als": ALSAlgorithm},
        RecommendationServing,
    )


# -------------------------------------------------------------- evaluation
class SquaredErrorMetric(OptionAverageMetric):
    """MSE on held-out (user, item) ratings; queries whose user or item
    the training fold has not seen are skipped (the reference template's
    Evaluation.scala RMSE analog). Lower is better."""

    higher_is_better = False

    def calculate_one(self, query, prediction, actual):
        if not prediction.item_scores:
            return None
        return (prediction.item_scores[0].score - float(actual)) ** 2


def recommendation_evaluation(
    app_name: str = "",
    eval_k: int = 3,
    rate_event: str = "rate",
    ranks=(8, 16),
    lambdas=(0.05, 0.1),
    num_iterations: int = 10,
):
    """Ready-made ``pio eval`` sweep: k-fold MSE over a rank × lambda
    grid over the app ``app_name`` (``$PIO_TPU_EVAL_APP`` when empty, for
    zero-arg CLI use). Run it with ``run_evaluation(ev,
    ev.engine_params_generator)``, or from the CLI:

        PIO_TPU_EVAL_APP=myapp python -m pio_tpu_torch eval \\
            pio_tpu_torch.templates.recommendation:recommendation_evaluation
    """
    if eval_k < 2:
        raise ValueError("k-fold evaluation needs eval_k >= 2")
    ds = DataSourceParams(
        app_name=eval_app_name(app_name), rate_event=rate_event,
        eval_k=eval_k,
    )
    grid = [
        EngineParams(
            data_source_params=ds,
            algorithm_params_list=(
                ("als", ALSAlgorithmParams(
                    rank=r, lambda_=lam, num_iterations=num_iterations
                )),
            ),
        )
        for r in ranks
        for lam in lambdas
    ]
    return Evaluation(
        recommendation_engine(), SquaredErrorMetric(),
        engine_params_generator=EngineParamsGenerator(grid),
    )
