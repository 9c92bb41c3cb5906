"""Similar-product template — items similar to a basket of query items.

Counterpart of ``pio_tpu/templates/similarproduct.py``: the data source
reads user ``view`` edges and the ``categories`` of ``$set item``
entities; the algorithm trains implicit ALS (one view is r = 1) on the
context's device (:mod:`pio_tpu_torch.models.als`) and keeps the item
factors L2-normalized on the host. A query scores the mean normalized
factor of its basket against every item with a numpy matvec on the host,
as the reference's code does, then masks the business rules (categories,
white and black lists, the basket itself) and takes the top N
(:func:`~pio_tpu_torch.templates.common.top_item_scores`).

engine.json:

    {
      "id": "similarproduct",
      "engineFactory": "templates.similarproduct",
      "datasource": {"params": {"app_name": "myapp"}},
      "algorithms": [{"name": "als", "params":
          {"rank": 10, "num_iterations": 10, "lambda_": 0.01, "seed": 3}}]
    }

Query ``{"items": ["i1"], "num": 4, "categories": ["c"], "whiteList": [],
"blackList": []}`` → ``{"itemScores": [{"item": "i5", "score": 0.9}, ...]}``.

Evaluation (``pio eval``): :func:`similarproduct_evaluation`, a k-fold
co-view holdout scored by :class:`HitRateMetric` over a rank grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Tuple

import numpy as np

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
from pio_tpu_torch.controller.metrics import AverageMetric
from pio_tpu_torch.controller.params import Params
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.als import ALSConfig, train_als
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.common import (
    PredictedResult,
    business_rule_mask,
    dedup_pair_indices,
    eval_app_name,
    fold_assignments,
    l2_normalize_rows,
    resolve_app,
    top_item_scores,
)


# --------------------------------------------------------------- data source
@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    app_id: int = 0
    channel: str = ""
    view_event: str = "view"
    eval_k: int = 0  # >0 enables k-fold read_eval
    #: eval: context items per query / top-k window scored by HitRate
    eval_query_items: int = 3
    eval_num: int = 10


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_ids: np.ndarray  # [n] str objects (view edge sources)
    item_ids: np.ndarray  # [n] str objects (view edge targets)
    #: item entity id → categories (from $set item events)
    item_categories: Dict[str, FrozenSet[str]] = dataclasses.field(
        default_factory=dict
    )

    def sanity_check(self) -> None:
        if len(self.item_ids) == 0:
            raise ValueError(
                "TrainingData is empty - no view events found. "
                "Did you import events for this app?"
            )

    def __len__(self):
        return len(self.item_ids)


class SimilarProductDataSource(DataSource):
    """View edges (``find_frame``) and item categories
    (``aggregate_properties``)."""

    params_class = DataSourceParams

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        p: DataSourceParams = self.params
        app_id, channel_id = resolve_app(p)
        pe = Storage.get_pevents()
        frame = pe.find_frame(
            app_id,
            channel_id=channel_id,
            event_names=[p.view_event],
            entity_type="user",
            target_entity_type="item",
        )
        props = pe.aggregate_properties(
            app_id, entity_type="item", channel_id=channel_id
        )
        cats = {
            eid: frozenset(pm.get_opt("categories") or [])
            for eid, pm in props.items()
        }
        return TrainingData(
            user_ids=frame.entity_id,
            item_ids=frame.target_entity_id,
            item_categories=cats,
        )

    def read_eval(self, ctx: ComputeContext):
        """k-fold co-view holdout: the query carries a few items the user
        viewed in the training fold, the actual is a held-out co-viewed
        item — scored by HitRate@eval_num."""
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            return []
        if p.eval_k == 1:
            raise ValueError("k-fold cross-validation needs eval_k >= 2")
        td = self.read_training(ctx)
        keep = dedup_pair_indices(td.user_ids, td.item_ids)
        td = TrainingData(
            user_ids=td.user_ids[keep],
            item_ids=td.item_ids[keep],
            item_categories=td.item_categories,
        )
        fold_of = fold_assignments(len(td), p.eval_k)
        folds = []
        for k in range(p.eval_k):
            train = fold_of != k
            td_k = TrainingData(
                user_ids=td.user_ids[train],
                item_ids=td.item_ids[train],
                item_categories=td.item_categories,
            )
            by_user: Dict[str, List[str]] = {}
            for u, i in zip(td_k.user_ids, td_k.item_ids):
                by_user.setdefault(u, []).append(i)
            qa = []
            for u, i in zip(td.user_ids[~train], td.item_ids[~train]):
                ctx_items = [
                    x for x in by_user.get(u, ()) if x != i
                ][: p.eval_query_items]
                if not ctx_items:
                    continue  # cold user in this fold — unanswerable
                qa.append(
                    (Query(items=tuple(ctx_items), num=p.eval_num), str(i))
                )
            folds.append((td_k, {"fold": k}, qa))
        return folds


# --------------------------------------------------------------- preparator
@dataclasses.dataclass
class PreparedData:
    user_index: BiMap
    item_index: BiMap
    user_codes: np.ndarray  # [n] int32
    item_codes: np.ndarray  # [n] int32
    #: per item code, the item's categories
    categories: List[FrozenSet[str]] = dataclasses.field(default_factory=list)


class SimilarProductPreparator(Preparator):
    def prepare(self, ctx: ComputeContext, td: TrainingData) -> PreparedData:
        user_index = BiMap.string_int(td.user_ids.tolist())
        # items that appear only as $set entities get factor rows too (cold
        # but filterable); they sort last in the popularity order
        all_items = td.item_ids.tolist() + sorted(td.item_categories)
        item_index = BiMap.string_int_by_frequency(all_items)
        ufwd, ifwd = user_index.to_dict(), item_index.to_dict()
        user_codes = np.fromiter(
            (ufwd[u] for u in td.user_ids.tolist()), np.int32, len(td)
        )
        item_codes = np.fromiter(
            (ifwd[i] for i in td.item_ids.tolist()), np.int32, len(td)
        )
        inv = item_index.inverse
        categories = [
            td.item_categories.get(inv[c], frozenset())
            for c in range(len(item_index))
        ]
        return PreparedData(
            user_index, item_index, user_codes, item_codes, categories
        )


# ----------------------------------------------------------------- algorithm
@dataclasses.dataclass(frozen=True)
class Query:
    items: Tuple[str, ...] = ()
    num: int = 10
    categories: Tuple[str, ...] = ()
    white_list: Tuple[str, ...] = ()
    black_list: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3


@dataclasses.dataclass
class SimilarProductModel:
    #: L2-normalized item factors [n_items, rank], host float32
    norm_factors: np.ndarray
    item_index: BiMap
    categories: List[FrozenSet[str]]


def implicit_views_factors(ctx: ComputeContext, pd: PreparedData, p):
    """Implicit ALS over the view edges (r = 1 a view) on ``ctx.device``,
    shared by this template and the e-commerce one; ``p`` carries rank,
    num_iterations, lambda_, alpha and seed."""
    return train_als(
        ctx,
        pd.user_codes,
        pd.item_codes,
        np.ones(len(pd.item_codes), np.float32),
        n_users=len(pd.user_index),
        n_items=len(pd.item_index),
        config=ALSConfig(
            rank=p.rank,
            iterations=p.num_iterations,
            reg=p.lambda_,
            implicit=True,
            alpha=p.alpha,
            seed=p.seed,
        ),
    )


class SimilarProductAlgorithm(Algorithm):
    """Implicit ALS + cosine over item factors
    (≙ reference ALSAlgorithm.train → MLlib ALS.trainImplicit)."""

    params_class = ALSAlgorithmParams
    splits_over_group = True
    query_class = Query

    def train(
        self, ctx: ComputeContext, pd: PreparedData
    ) -> SimilarProductModel:
        factors = implicit_views_factors(ctx, pd, self.params)
        return SimilarProductModel(
            l2_normalize_rows(factors.item_factors),
            pd.item_index,
            pd.categories,
        )

    def predict(
        self, model: SimilarProductModel, query: Query
    ) -> PredictedResult:
        codes = known_codes(model.item_index, query.items)
        if not codes:
            return PredictedResult()  # all query items unknown
        basket = model.norm_factors[np.asarray(codes, np.int32)]
        scores = model.norm_factors @ basket.mean(axis=0)
        return _masked_top_result(model, codes, scores, query)

    def batch_predict(self, model: SimilarProductModel, queries):
        """One ``[B, K] @ [K, N]`` product over every resolvable basket;
        the business-rule masks stay per query."""
        out = []
        bidx, bq, bcodes = [], [], []
        for i, q in queries:
            codes = known_codes(model.item_index, q.items)
            if not codes:
                out.append((i, PredictedResult()))
                continue
            bidx.append(i)
            bq.append(q)
            bcodes.append(codes)
        if bidx:
            baskets = np.stack([
                model.norm_factors[np.asarray(c, np.int32)].mean(axis=0)
                for c in bcodes
            ])
            scores = baskets @ model.norm_factors.T  # [B, n_items]
            for i, q, codes, row in zip(bidx, bq, bcodes, scores):
                out.append((i, _masked_top_result(model, codes, row, q)))
        return out


def known_codes(item_index: BiMap, items) -> List[int]:
    """The codes of the items the index knows, in query order."""
    return [c for c in (item_index.get(i) for i in items) if c is not None]


def _masked_top_result(
    model: SimilarProductModel, codes, scores, query: Query
) -> PredictedResult:
    """The business-rule mask and top-N tail of predict and batch_predict
    (one home, so online and offline scoring cannot diverge)."""
    mask = business_rule_mask(
        len(scores),
        model.item_index,
        model.categories,
        categories=query.categories,
        white_list=query.white_list,
        black_list=query.black_list,
    )
    mask[np.asarray(codes, np.int32)] = False  # never return the basket
    return top_item_scores(scores, mask, query.num, model.item_index)


class SimilarProductServing(FirstServing):
    pass


@register_engine("templates.similarproduct")
def similarproduct_engine() -> Engine:
    return Engine(
        SimilarProductDataSource,
        SimilarProductPreparator,
        {"als": SimilarProductAlgorithm},
        SimilarProductServing,
    )


# -------------------------------------------------------------- evaluation
class HitRateMetric(AverageMetric):
    """Fraction of held-out items that appear in the top-k answer
    (HitRate@k)."""

    def calculate_one(self, query, prediction, actual):
        return 1.0 if any(
            s.item == actual for s in prediction.item_scores
        ) else 0.0


def similarproduct_evaluation(
    app_name: str = "",
    eval_k: int = 3,
    ranks=(8, 16),
    num_iterations: int = 10,
    eval_num: int = 10,
):
    """Ready-made ``pio eval`` sweep over the app ``app_name``
    (``$PIO_TPU_EVAL_APP`` when empty): k-fold
    HitRate@``eval_num`` over the rank grid. Keep ``eval_num`` well below
    the catalog size or the metric saturates. Run it with
    ``run_evaluation(ev, ev.engine_params_generator)``."""
    if eval_k < 2:
        raise ValueError("k-fold evaluation needs eval_k >= 2")
    app_name = eval_app_name(app_name)
    ds = DataSourceParams(app_name=app_name, eval_k=eval_k, eval_num=eval_num)
    grid = [
        EngineParams(
            data_source_params=ds,
            algorithm_params_list=(
                ("als", ALSAlgorithmParams(
                    rank=r, num_iterations=num_iterations
                )),
            ),
        )
        for r in ranks
    ]
    return Evaluation(
        similarproduct_engine(), HitRateMetric(),
        engine_params_generator=EngineParamsGenerator(grid),
    )
