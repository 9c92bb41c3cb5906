"""DASE component bases: DataSource, Preparator, Algorithm, Serving.

Counterpart of ``pio_tpu/controller/components.py``. A component receives
a :class:`~pio_tpu_torch.parallel.context.ComputeContext` (the device and
seed) where the reference's receive the mesh. Every component is
constructed with its Params instance: ``cls(params)``. A model persists
as a pickled blob of host values
(:mod:`pio_tpu_torch.workflow.core_workflow`) unless it is a
:class:`PersistentModel` whose ``save`` handles it.
"""

from __future__ import annotations

import abc
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar

import torch

from pio_tpu_torch.controller.params import EmptyParams, Params
from pio_tpu_torch.parallel.context import ComputeContext

TD = TypeVar("TD")  # training data
PD = TypeVar("PD")  # prepared data
Q = TypeVar("Q")  # query
P = TypeVar("P")  # prediction
M = TypeVar("M")  # model


class Component(abc.ABC):
    """Base: holds the params it was constructed with."""

    params_class: type = EmptyParams

    def __init__(self, params: Optional[Params] = None):
        self.params = params if params is not None else self.params_class()


class SanityCheck(abc.ABC):
    """Opt-in hook called on the training and prepared data after
    read/prepare."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise if the data is unusable (e.g. empty training set)."""


class DataSource(Component, Generic[TD]):
    """Reads training data from the event store."""

    @abc.abstractmethod
    def read_training(self, ctx: ComputeContext) -> TD: ...

    def read_eval(self, ctx: ComputeContext) -> List[Tuple[TD, Any, list]]:
        """Eval folds: ``(training data, eval info, [(query, actual)])``.
        Default: none, so ``Engine.eval`` is a no-op."""
        return []


class Preparator(Component, Generic[TD, PD]):
    """Training data → prepared data (features)."""

    @abc.abstractmethod
    def prepare(self, ctx: ComputeContext, training_data: TD) -> PD: ...


class Algorithm(Component, Generic[PD, M, Q, P]):
    """Trains a model on the context's device; answers queries with it."""

    #: the dataclass a query JSON object binds to (None: raw dict queries)
    query_class: Optional[type] = None
    #: True where ``train`` splits its work over ``ctx.group``; under a
    #: process group any other algorithm trains a whole copy on every
    #: rank, of which only rank 0's is kept (``run_train`` logs which)
    splits_over_group: bool = False

    @abc.abstractmethod
    def train(self, ctx: ComputeContext, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def batch_predict(
        self, model: M, queries: Sequence[Tuple[int, Q]]
    ) -> List[Tuple[int, P]]:
        """Default: loop predict. Override with one batched device call."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def prepare_for_serving(self, model: M) -> M:
        """One-time serving preparation at deploy or load (the model side
        of the reference's ``Engine.prepareDeploy``): for example, build
        a scorer on the model's device. Runs for the query server and for
        batch prediction (``Engine.algorithms_with_models``). Default:
        the model unchanged."""
        return model

    def warmup_query(self, model: M) -> Optional[Q]:
        """A representative query to warm the serving path with, or None."""
        return None

    def resident_scorer(self, model: M, device: torch.device):
        """A :class:`~pio_tpu_torch.server.residency.ResidentLinearScorer`
        of ``model``'s serving parameters on ``device`` (the query server's
        serving device), or None: the model serves as it is. The query
        server places it when it is built, where residency is enabled."""
        return None


class PersistentModel(abc.ABC):
    """Opt-in custom model persistence (reference ``PersistentModel`` /
    ``PersistentModelLoader``). ``run_train`` calls :meth:`save`; a model
    that handles itself returns True and the Models store's blob keeps
    None in its place, False falls back to the blob. A load calls the
    algorithm's ``model_class.load`` with the same instance id."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Params,
             ctx: ComputeContext) -> bool:
        """Persist; return True if handled (False -> fall back to blob)."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Params,
             ctx: ComputeContext) -> "PersistentModel":
        ...


class Serving(Component, Generic[Q, P]):
    """Combine per-algorithm predictions into one response."""

    @abc.abstractmethod
    def serve(self, query: Q, predictions: List[P]) -> P: ...

    def supplement(self, query: Q) -> Q:
        """Hook to enrich the query before the algorithms see it
        (reference ``LServing.supplementBase``)."""
        return query


class FirstServing(Serving[Q, P]):
    """Returns the first algorithm's prediction."""

    def serve(self, query: Q, predictions: List[P]) -> P:
        return predictions[0]
