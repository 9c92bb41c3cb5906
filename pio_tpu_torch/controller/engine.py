"""Engine — binds the DASE components and their params; runs training.

Counterpart of ``pio_tpu/controller/engine.py``: an engine names its data
source, preparator, algorithms and serving class, binds an engine.json
variant to :class:`EngineParams`, trains (``Engine.train``: read →
prepare → each algorithm, with per-phase seconds), evaluates
(``Engine.eval``: per fold of ``read_eval``, prepare, train and serve the
fold's queries) and turns trained models into ``(algorithm, model)`` pairs
for the query server. With a context that names a checkpoint directory,
``train`` gives each algorithm its own ``CheckpointManager``. The trace
and trainwatch hooks of the reference's ``train`` come with later slices.
Engine factories register by name (``@register_engine``) or resolve as
``"module.path:attribute"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import torch

from pio_tpu_torch.controller.components import (
    Algorithm,
    DataSource,
    Preparator,
    SanityCheck,
    Serving,
)
from pio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsError,
    params_from_dict,
)
from pio_tpu_torch.obs import trainwatch
from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.obs.tracing import active_trace
from pio_tpu_torch.parallel.context import ComputeContext

log = logging.getLogger("pio_tpu_torch.engine")


def serve_fold(serving, algorithms, models, qa):
    """One eval fold's query loop: supplement → per-algorithm
    ``batch_predict`` → serve. Shared by :meth:`Engine.eval` and the
    FastEval path (``controller/evaluation.py``), so an algorithm with a
    batched ``batch_predict`` uses it during evaluation too.
    Returns ``[(query, prediction, actual)]``."""
    supplemented = [(serving.supplement(q), actual) for q, actual in qa]
    indexed = [(i, q) for i, (q, _a) in enumerate(supplemented)]
    per_algo = [
        dict(algo.batch_predict(model, indexed))
        for algo, model in zip(algorithms, models)
    ]
    return [
        (q, serving.serve(q, [preds[i] for preds in per_algo]), actual)
        for i, (q, actual) in enumerate(supplemented)
    ]


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Per-run parameter bundle."""

    data_source_params: Params = EmptyParams()
    preparator_params: Params = EmptyParams()
    algorithm_params_list: Tuple[Tuple[str, Params], ...] = ()
    serving_params: Params = EmptyParams()


class Engine:
    """Binds DASE component classes; ``algorithm_class_map`` maps the
    names engine.json's ``algorithms[].name`` uses to Algorithm classes."""

    def __init__(
        self,
        data_source_class: Type[DataSource],
        preparator_class: Type[Preparator],
        algorithm_class_map: Dict[str, Type[Algorithm]],
        serving_class: Type[Serving],
    ):
        self.data_source_class = data_source_class
        self.preparator_class = preparator_class
        self.algorithm_class_map = dict(algorithm_class_map)
        self.serving_class = serving_class

    def params_from_variant(self, variant: Dict[str, Any]) -> EngineParams:
        """Bind an engine.json variant dict to typed EngineParams."""

        def section(name: str) -> Optional[dict]:
            v = variant.get(name)
            if v is None:
                return None
            if not isinstance(v, dict):
                raise ParamsError(f"engine.json {name!r} must be an object")
            return v.get("params", {})

        ds = params_from_dict(
            self.data_source_class.params_class, section("datasource")
        )
        prep = params_from_dict(
            self.preparator_class.params_class, section("preparator")
        )
        serv = params_from_dict(self.serving_class.params_class, section("serving"))

        algos: List[Tuple[str, Params]] = []
        for entry in variant.get("algorithms", []):
            name = entry.get("name")
            if name not in self.algorithm_class_map:
                raise ParamsError(
                    f"unknown algorithm {name!r}; engine declares "
                    f"{sorted(self.algorithm_class_map)}"
                )
            algos.append((name, params_from_dict(
                self.algorithm_class_map[name].params_class,
                entry.get("params", {}),
            )))
        if not algos:
            # default: every declared algorithm with default params
            algos = [
                (name, cls.params_class())
                for name, cls in self.algorithm_class_map.items()
            ]
        return EngineParams(
            data_source_params=ds,
            preparator_params=prep,
            algorithm_params_list=tuple(algos),
            serving_params=serv,
        )

    def _algorithms(self, engine_params: EngineParams) -> List[Algorithm]:
        return [
            self.algorithm_class_map[name](params)
            for name, params in engine_params.algorithm_params_list
        ]

    def train(
        self,
        ctx: ComputeContext,
        engine_params: EngineParams,
        skip_sanity_check: bool = False,
        stop_after_read: bool = False,
        stop_after_prepare: bool = False,
        timings: Optional[dict] = None,
    ) -> List[Any]:
        """Run DataSource -> Preparator -> each Algorithm; return models.

        ``timings``, when given, is filled with per-phase wall seconds
        (``read``, ``prepare``, ``train:<i>_<algo>``), as the reference's;
        an active trainwatch recorder follows each phase by name
        (``train.<i>_<algo>``) and its seconds (``/train.json``), and
        each phase is a span of that name on the active trace, if any, so
        its log records carry ``(trace_id, span)``.
        With ``ctx.checkpoint_base`` and ``ctx.checkpoint_every`` set, each
        algorithm trains with a ``CheckpointManager`` of its own under
        ``<checkpoint_base>/algo<i>_<name>``, closed when it returns.
        """

        def _phase(name, fn):
            # the recorder's phase (/train.json) takes the dot form; the
            # timings keys keep the reference's colon form
            span_name = name.replace(":", ".")
            trainwatch.set_phase(span_name)
            tr = active_trace()
            t0 = monotonic_s()
            with (tr.span(span_name) if tr is not None
                  else contextlib.nullcontext()):
                out = fn()
                if ctx.device.type == "cuda":
                    # the card runs behind the host: a phase ends with
                    # its work
                    torch.cuda.synchronize(ctx.device)
            dur = round(monotonic_s() - t0, 3)
            if timings is not None:
                timings[name] = dur
            rec = trainwatch.active_recorder()
            if rec is not None:
                rec.set_phase_seconds(span_name, dur)
            return out

        data_source = self.data_source_class(engine_params.data_source_params)
        td = _phase("read", lambda: data_source.read_training(ctx))
        if not skip_sanity_check and isinstance(td, SanityCheck):
            td.sanity_check()
        if stop_after_read:
            log.info("stopping after read_training (stop_after_read)")
            return []
        preparator = self.preparator_class(engine_params.preparator_params)
        pd = _phase("prepare", lambda: preparator.prepare(ctx, td))
        if not skip_sanity_check and isinstance(pd, SanityCheck):
            pd.sanity_check()
        if stop_after_prepare:
            log.info("stopping after prepare (stop_after_prepare)")
            return []
        names = [n for n, _ in engine_params.algorithm_params_list]
        models = []
        for i, algo in enumerate(self._algorithms(engine_params)):
            algo_ctx, manager = ctx, None
            if ctx.checkpoint_base and ctx.checkpoint_every > 0:
                from pio_tpu_torch.workflow.checkpoint import CheckpointManager

                # per-algorithm subdir: two algorithms in one engine must
                # never restore each other's snapshots
                manager = CheckpointManager(os.path.join(
                    ctx.checkpoint_base, f"algo{i}_{names[i]}"))
                algo_ctx = dataclasses.replace(ctx, checkpoint=manager)
            try:
                # index-prefixed: two algorithms of one name keep their
                # own phase
                models.append(_phase(f"train:{i}_{names[i]}",
                                     lambda: algo.train(algo_ctx, pd)))
            finally:
                if manager is not None:
                    manager.close()
        return models

    def eval(
        self, ctx: ComputeContext, engine_params: EngineParams
    ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """Per fold of the data source's ``read_eval``: ``(eval_info,
        [(query, prediction, actual)])``, the fold's models trained on
        ``ctx.device``."""
        data_source = self.data_source_class(engine_params.data_source_params)
        preparator = self.preparator_class(engine_params.preparator_params)
        serving = self.serving_class(engine_params.serving_params)
        algorithms = self._algorithms(engine_params)
        results = []
        for td, eval_info, qa in data_source.read_eval(ctx):
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for algo in algorithms]
            results.append(
                (eval_info, serve_fold(serving, algorithms, models, qa)))
        return results

    def make_serving(self, engine_params: EngineParams) -> Serving:
        return self.serving_class(engine_params.serving_params)

    def algorithms_with_models(
        self, engine_params: EngineParams, models: Sequence[Any]
    ) -> List[Tuple[Algorithm, Any]]:
        algos = self._algorithms(engine_params)
        if len(algos) != len(models):
            raise ValueError(
                f"{len(algos)} algorithms but {len(models)} models"
            )
        # serving preparation (reference Engine.prepareDeploy), once per
        # (algorithm, model) pair
        return [
            (a, a.prepare_for_serving(m)) for a, m in zip(algos, models)
        ]


# -------------------------------------------------------------- registry
EngineFactory = Callable[[], Engine]

_ENGINE_REGISTRY: Dict[str, EngineFactory] = {}


def register_engine(name: str):
    """Decorator registering an engine factory under a stable name."""

    def deco(factory: EngineFactory) -> EngineFactory:
        _ENGINE_REGISTRY[name] = factory
        return factory

    return deco


def engine_factory_names() -> List[str]:
    """The registered factory names, sorted."""
    return sorted(_ENGINE_REGISTRY)


def get_engine_factory(name: str) -> EngineFactory:
    """Resolve a factory: registry name, then ``module:attr`` import, then
    the port's module of that name (``templates.textclassification`` is
    registered by importing ``pio_tpu_torch.templates.textclassification``).
    """
    if name in _ENGINE_REGISTRY:
        return _ENGINE_REGISTRY[name]
    if ":" in name:
        mod_name, _, attr = name.partition(":")
        try:
            mod = importlib.import_module(mod_name)
        except ImportError as e:
            raise ParamsError(f"cannot import engine factory {name!r}: {e}") from None
        fn = getattr(mod, attr, None)
        if fn is None:
            raise ParamsError(f"{mod_name!r} has no attribute {attr!r}")
        return fn
    try:
        importlib.import_module(f"pio_tpu_torch.{name}")
    except ImportError:
        pass
    if name in _ENGINE_REGISTRY:
        return _ENGINE_REGISTRY[name]
    raise ParamsError(
        f"engine factory {name!r} not registered; known: "
        f"{sorted(_ENGINE_REGISTRY)}"
    )
