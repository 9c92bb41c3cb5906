"""E-commerce recommendation template — personalized items with business rules.

Counterpart of ``pio_tpu/templates/ecommerce.py``: implicit ALS on the
view edges (trained on the context's device, as the similar-product
template does), and at serve time, on the host in numpy:

- a known user → the user's factor against every item's;
- an unknown user → the mean normalized factor of the user's most recent
  views, read from the live event store at query time, by cosine;
- ``unseen_only`` → items the user recently viewed or bought (a live read)
  are left out;
- the latest ``$set`` of ``constraint/unavailableItems`` (property
  ``items``) is read at query time, so items can be pulled without a
  retrain;
- categories, white and black lists as in the similar-product template.

Every live read goes through ``Storage.get_levents()`` on each query.

Query ``{"user": "u1", "num": 4, "categories": [...], "whiteList": [...],
"blackList": [...]}`` → ``{"itemScores": [...]}``.

Evaluation (``pio eval``): :func:`ecommerce_evaluation`, a k-fold
held-out-view sweep with the seen-exclusion protocol, scored by
HitRate@``eval_num`` over a rank grid.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Set, Tuple

import numpy as np

from pio_tpu_torch.controller.components import Algorithm, FirstServing
from pio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    register_engine,
)
from pio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from pio_tpu_torch.controller.params import Params
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.common import (
    PredictedResult,
    business_rule_mask,
    dedup_pair_indices,
    eval_app_name,
    fold_assignments,
    l2_normalize_rows,
    seen_exclusion_holdout,
    top_item_scores,
)
from pio_tpu_torch.templates.similarproduct import (
    HitRateMetric,
    PreparedData,
    SimilarProductDataSource,
    SimilarProductPreparator,
    implicit_views_factors,
    known_codes,
)


# ------------------------------------------------- data source / preparator
# The same training inputs as the similar-product template (view edges and
# item categories); buys and seen items are read at serve time from the
# live event store.
@dataclasses.dataclass(frozen=True)
class DataSourceParams(
    SimilarProductDataSource.params_class  # type: ignore[misc]
):
    pass


class ECommerceDataSource(SimilarProductDataSource):
    params_class = DataSourceParams

    def read_eval(self, ctx: ComputeContext):
        """k-fold held-out-view protocol, personalized: the query asks
        top-``eval_num`` items for the user, the actual is a held-out
        viewed item, and the query black-lists the user's training-fold
        items (``seen_exclusion_holdout``)."""
        p = self.params
        if p.eval_k <= 0:
            return []
        if p.eval_k == 1:
            raise ValueError("k-fold cross-validation needs eval_k >= 2")
        td = self.read_training(ctx)
        keep = dedup_pair_indices(td.user_ids, td.item_ids)
        users, items = td.user_ids[keep], td.item_ids[keep]
        fold_of = fold_assignments(len(users), p.eval_k)
        folds = []
        for k in range(p.eval_k):
            train = fold_of != k
            td_k = type(td)(
                user_ids=users[train],
                item_ids=items[train],
                item_categories=td.item_categories,
            )
            qa = seen_exclusion_holdout(
                users[train], items[train],
                users[~train], items[~train],
                lambda u, bl: Query(
                    user=u, num=p.eval_num, black_list=bl
                ),
            )
            folds.append((td_k, {"fold": k}, qa))
        return folds


class ECommercePreparator(SimilarProductPreparator):
    pass


# ----------------------------------------------------------------- algorithm
@dataclasses.dataclass(frozen=True)
class Query:
    user: str = ""
    num: int = 10
    categories: Tuple[str, ...] = ()
    white_list: Tuple[str, ...] = ()
    black_list: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    app_name: str = ""  # live event-store lookups at serve time
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    #: exclude items the user has recently seen (view/buy)
    unseen_only: bool = False
    seen_events: Tuple[str, ...] = ("buy", "view")
    #: events used for the cold-user fallback basket
    similar_events: Tuple[str, ...] = ("view",)
    #: how many recent events the serve-time lookups read
    num_recent_events: int = 10


@dataclasses.dataclass
class ECommModel:
    user_factors: np.ndarray  # [n_users, rank], host float32
    norm_item_factors: np.ndarray  # [n_items, rank], L2-normalized
    item_factors: np.ndarray  # [n_items, rank], raw (personalized scores)
    user_index: BiMap
    item_index: BiMap
    categories: List[FrozenSet[str]]
    app_id: int


class ECommAlgorithm(Algorithm):
    """Implicit ALS + serve-time business rules
    (≙ reference ECommAlgorithm)."""

    params_class = ECommAlgorithmParams
    splits_over_group = True
    query_class = Query

    def train(self, ctx: ComputeContext, pd: PreparedData) -> ECommModel:
        p: ECommAlgorithmParams = self.params
        app = Storage.get_meta_data_apps().get_by_name(p.app_name)
        if app is None:
            raise ValueError(
                f"ECommAlgorithm params need app_name (got {p.app_name!r})"
            )
        factors = implicit_views_factors(ctx, pd, p)
        f = factors.item_factors
        return ECommModel(
            user_factors=factors.user_factors,
            norm_item_factors=l2_normalize_rows(f),
            item_factors=f.astype(np.float32),
            user_index=pd.user_index,
            item_index=pd.item_index,
            categories=pd.categories,
            app_id=app.id,
        )

    # ------------------------------------------------ live event-store reads
    def _recent_items(
        self, model: ECommModel, user: str, event_names: Tuple[str, ...],
        limit: int,
    ) -> List[str]:
        events = Storage.get_levents().find(
            model.app_id,
            entity_type="user",
            entity_id=user,
            event_names=list(event_names),
            limit=limit,
            reversed_order=True,
        )
        return [
            e.target_entity_id for e in events if e.target_entity_id
        ]

    def _unavailable_items(self, model: ECommModel) -> Set[str]:
        props = Storage.get_levents().aggregate_properties(
            model.app_id, entity_type="constraint"
        )
        pm = props.get("unavailableItems")
        if pm is None:
            return set()
        return set(pm.get_opt("items") or [])

    def _cold_scores(
        self, model: ECommModel, query: Query
    ) -> Optional[np.ndarray]:
        """Cold user: basket = recent views from the live event store."""
        p: ECommAlgorithmParams = self.params
        recent = self._recent_items(
            model, query.user, p.similar_events, p.num_recent_events
        )
        codes = known_codes(model.item_index, recent)
        if not codes:
            return None
        basket = model.norm_item_factors[np.asarray(codes, np.int32)]
        return model.norm_item_factors @ basket.mean(axis=0)

    def _apply_rules(
        self,
        model: ECommModel,
        query: Query,
        scores: np.ndarray,
        unavailable: Set[str],
    ) -> PredictedResult:
        """Business-rule masks + top-N tail, shared by predict and
        batch_predict so online and offline scoring cannot diverge.
        ``unavailable`` is the constraint snapshot (fresh per predict,
        one snapshot per batch_predict call)."""
        p: ECommAlgorithmParams = self.params
        mask = business_rule_mask(
            len(scores),
            model.item_index,
            model.categories,
            categories=query.categories,
            white_list=query.white_list,
            black_list=query.black_list,
        )
        for i in unavailable:
            c = model.item_index.get(i)
            if c is not None:
                mask[c] = False
        if p.unseen_only:
            # a live read per query: serve-time freshness is the point
            for i in self._recent_items(
                model, query.user, p.seen_events, p.num_recent_events
            ):
                c = model.item_index.get(i)
                if c is not None:
                    mask[c] = False
        return top_item_scores(scores, mask, query.num, model.item_index)

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        ucode = model.user_index.get(query.user)
        if ucode is not None:
            scores = model.item_factors @ model.user_factors[ucode]
        else:
            scores = self._cold_scores(model, query)
            if scores is None:
                return PredictedResult()
        return self._apply_rules(
            model, query, scores, self._unavailable_items(model)
        )

    def batch_predict(self, model: ECommModel, queries):
        """Known users' queries in one ``[B, K] @ [K, N]`` product and one
        constraint snapshot a call; the cold-user baskets and
        ``unseen_only`` stay live reads per query."""
        unavailable = self._unavailable_items(model)
        out = []
        bidx, bq, bcodes = [], [], []
        for i, q in queries:
            code = model.user_index.get(q.user)
            if code is None:
                scores = self._cold_scores(model, q)
                out.append((
                    i,
                    PredictedResult() if scores is None
                    else self._apply_rules(model, q, scores, unavailable),
                ))
            else:
                bidx.append(i)
                bq.append(q)
                bcodes.append(code)
        if bidx:
            mat = (
                model.user_factors[np.asarray(bcodes, np.int32)]
                @ model.item_factors.T
            )  # [B, n_items]
            for i, q, scores in zip(bidx, bq, mat):
                out.append(
                    (i, self._apply_rules(model, q, scores, unavailable))
                )
        return out


class ECommerceServing(FirstServing):
    pass


@register_engine("templates.ecommerce")
def ecommerce_engine() -> Engine:
    return Engine(
        ECommerceDataSource,
        ECommercePreparator,
        {"ecomm": ECommAlgorithm},
        ECommerceServing,
    )


# -------------------------------------------------------------- evaluation
def ecommerce_evaluation(
    app_name: str = "",
    eval_k: int = 3,
    eval_num: int = 10,
    ranks=(8, 16),
    num_iterations: int = 10,
):
    """Ready-made ``pio eval`` sweep over the app ``app_name``
    (``$PIO_TPU_EVAL_APP`` when empty): k-fold
    HitRate@``eval_num`` on held-out views, personalized queries, over the
    rank grid. Each query black-lists the user's training-fold items; the
    other business rules run as in serving, the unavailable-items
    constraint included. Run it with
    ``run_evaluation(ev, ev.engine_params_generator)``."""
    if eval_k < 2:
        raise ValueError("k-fold evaluation needs eval_k >= 2")
    app_name = eval_app_name(app_name)
    ds = DataSourceParams(
        app_name=app_name, eval_k=eval_k, eval_num=eval_num
    )
    grid = [
        EngineParams(
            data_source_params=ds,
            algorithm_params_list=(
                ("ecomm", ECommAlgorithmParams(
                    app_name=app_name, rank=r, num_iterations=num_iterations,
                )),
            ),
        )
        for r in ranks
    ]
    return Evaluation(
        ecommerce_engine(), HitRateMetric(),
        engine_params_generator=EngineParamsGenerator(grid),
    )
