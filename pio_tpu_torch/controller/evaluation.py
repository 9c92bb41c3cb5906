"""Evaluation framework: Evaluation, EngineParamsGenerator, MetricEvaluator,
FastEval memoization.

Rebuild of the reference's ``controller/Evaluation.scala``,
``EngineParamsGenerator.scala``, ``MetricEvaluator.scala`` and
``FastEvalEngine.scala`` (UNVERIFIED paths; see SURVEY.md).

The reference's FastEvalEngine memoizes DataSource/Preparator/Algorithm
outputs across engine-params sharing a prefix so a hyper-parameter sweep
doesn't re-read or re-prepare identical stages. :class:`FastEvalCache`
replicates that: stage outputs are cached keyed by the serialized params
prefix — change only algorithm params and the sweep reuses TD/PD; change
only serving params and it reuses trained models too.

The port's copy of ``pio_tpu/controller/evaluation.py`` (the port imports
nothing of ``pio_tpu``): each fold's models train on the context's device.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from typing import Any, Dict, List, Optional, Sequence

from pio_tpu_torch.controller.engine import Engine, EngineParams, serve_fold
from pio_tpu_torch.controller.metrics import Metric
from pio_tpu_torch.controller.params import params_to_dict
from pio_tpu_torch.parallel.context import ComputeContext

log = logging.getLogger("pio_tpu_torch.evaluation")


class EngineParamsGenerator:
    """Declares the params list a sweep evaluates
    (reference ``EngineParamsGenerator``)."""

    def __init__(self, engine_params_list: Sequence[EngineParams]):
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        self.engine_params_list = list(engine_params_list)


class Evaluation:
    """Binds an engine + metric(s) (reference ``trait Evaluation``).

    ``engine_params_generator`` pairs the sweep definition with the
    evaluation (reference ``Evaluation with EngineParamsGenerator``
    mix-in); the CLI ``eval`` verb reads it when no generator is passed
    explicitly.
    """

    def __init__(
        self,
        engine: Engine,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        engine_params_generator: Optional[EngineParamsGenerator] = None,
    ):
        self.engine = engine
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.engine_params_generator = engine_params_generator


@dataclasses.dataclass
class MetricScores:
    """Scores for one engine-params candidate
    (reference ``MetricScores`` in MetricEvaluator)."""

    engine_params: EngineParams
    score: float
    other_scores: List[float]


@dataclasses.dataclass
class MetricEvaluatorResult:
    """Sweep outcome (reference ``MetricEvaluatorResult``)."""

    best_engine_params: EngineParams
    best_score: float
    best_index: int
    metric_header: str
    other_metric_headers: List[str]
    engine_params_scores: List[MetricScores]

    def to_json(self) -> str:
        def ep_dict(ep: EngineParams) -> dict:
            return {
                "dataSourceParams": params_to_dict(ep.data_source_params),
                "preparatorParams": params_to_dict(ep.preparator_params),
                "algorithmParamsList": [
                    {"name": n, "params": params_to_dict(p)}
                    for n, p in ep.algorithm_params_list
                ],
                "servingParams": params_to_dict(ep.serving_params),
            }

        def safe(x: float):
            # json.dumps would emit the invalid literal `NaN` otherwise
            return x if math.isfinite(x) else None

        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "otherMetricHeaders": self.other_metric_headers,
                "bestScore": safe(self.best_score),
                "bestIndex": self.best_index,
                "bestEngineParams": ep_dict(self.best_engine_params),
                "engineParamsScores": [
                    {
                        "engineParams": ep_dict(s.engine_params),
                        "score": safe(s.score),
                        "otherScores": [safe(x) for x in s.other_scores],
                    }
                    for s in self.engine_params_scores
                ],
            },
            indent=2,
        )


class FastEvalCache:
    """Prefix-memoized stage outputs (reference ``FastEvalEngineWorkflow``).

    Keys (mirroring the reference's ``DataSourcePrefix`` /
    ``PreparatorPrefix`` / ``AlgorithmsPrefix``):
      - data-source stage:   serialized data_source_params
      - preparator stage:    + preparator_params
      - algorithms stage:    + algorithm_params_list
    """

    def __init__(self):
        self.data_source: Dict[str, Any] = {}
        self.preparator: Dict[str, Any] = {}
        self.algorithms: Dict[str, Any] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def ds_key(ep: EngineParams) -> str:
        return json.dumps(params_to_dict(ep.data_source_params), sort_keys=True)

    @classmethod
    def prep_key(cls, ep: EngineParams) -> str:
        return cls.ds_key(ep) + "|" + json.dumps(
            params_to_dict(ep.preparator_params), sort_keys=True
        )

    @classmethod
    def algo_key(cls, ep: EngineParams) -> str:
        return cls.prep_key(ep) + "|" + json.dumps(
            [(n, params_to_dict(p)) for n, p in ep.algorithm_params_list],
            sort_keys=True,
        )

    def get_or(self, cache: Dict[str, Any], key: str, compute):
        if key in cache:
            self.hits += 1
            return cache[key]
        self.misses += 1
        cache[key] = compute()
        return cache[key]


def _fast_eval(
    engine: Engine, ctx: ComputeContext, ep: EngineParams, cache: FastEvalCache
):
    """Engine.eval with FastEval stage memoization."""
    data_source = engine.data_source_class(ep.data_source_params)

    eval_folds = cache.get_or(
        cache.data_source, cache.ds_key(ep), lambda: data_source.read_eval(ctx)
    )

    def compute_prepared():
        preparator = engine.preparator_class(ep.preparator_params)
        return [
            (preparator.prepare(ctx, td), eval_info, qa)
            for td, eval_info, qa in eval_folds
        ]

    prepared = cache.get_or(cache.preparator, cache.prep_key(ep), compute_prepared)

    def compute_models():
        algorithms = [
            engine.algorithm_class_map[name](params)
            for name, params in ep.algorithm_params_list
        ]
        return [
            (algorithms, [algo.train(ctx, pd) for algo in algorithms], eval_info, qa)
            for pd, eval_info, qa in prepared
        ]

    trained = cache.get_or(cache.algorithms, cache.algo_key(ep), compute_models)

    serving = engine.serving_class(ep.serving_params)
    return [
        (eval_info, serve_fold(serving, algorithms, models, qa))
        for algorithms, models, eval_info, qa in trained
    ]


class MetricEvaluator:
    """Scores each candidate params, picks the best
    (reference ``MetricEvaluator.evaluateBase``)."""

    def __init__(self, metric: Metric, other_metrics: Sequence[Metric] = ()):
        self.metric = metric
        self.other_metrics = list(other_metrics)

    def evaluate(
        self,
        ctx: ComputeContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
        fast_eval: bool = True,
    ) -> MetricEvaluatorResult:
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        cache = FastEvalCache() if fast_eval else None
        scores: List[MetricScores] = []
        for i, ep in enumerate(engine_params_list):
            if cache is not None:
                eval_data = _fast_eval(engine, ctx, ep, cache)
            else:
                eval_data = engine.eval(ctx, ep)
            score = self.metric.calculate(eval_data)
            others = [m.calculate(eval_data) for m in self.other_metrics]
            log.info(
                "params[%d]: %s = %s", i, self.metric.header, score
            )
            scores.append(MetricScores(ep, score, others))

        # NaN scores (empty/unscorable folds) can never win: a NaN at index
        # 0 would otherwise stick because compare() returns 0 for NaN.
        best_i = None
        for i in range(len(scores)):
            if math.isnan(scores[i].score):
                continue
            if best_i is None or self.metric.compare(
                scores[i].score, scores[best_i].score
            ) > 0:
                best_i = i
        if best_i is None:
            raise ValueError(
                "every candidate scored NaN - no fold produced a scorable "
                "(query, prediction, actual) triple"
            )
        if cache is not None:
            log.info(
                "FastEval cache: %d hits / %d misses", cache.hits, cache.misses
            )
        return MetricEvaluatorResult(
            best_engine_params=scores[best_i].engine_params,
            best_score=scores[best_i].score,
            best_index=best_i,
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            engine_params_scores=scores,
        )
