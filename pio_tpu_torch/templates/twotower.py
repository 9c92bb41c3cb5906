"""Two-tower retrieval template — neural personalized recommendation.

Counterpart of ``pio_tpu/templates/twotower.py``: the recommendation
template's data source and preparator (``rate`` and ``buy`` events, dense
codes), a two-tower model trained on the context's device
(:mod:`pio_tpu_torch.models.two_tower`), and top-N serving from the user
and item vector tables through the scorer resident on the model's
device, with the recommendation template's routing
(``predict_user_topn``, ``batched_user_topn``).

Under a process group the model trains over a mesh of the group's ranks,
``model_parallel`` of them on the model axis and the rest on data
(reference l.109-118). The engine model is a ``ShardableModel``
(``PIO_TPU_SHARDED_PERSIST=1`` persists the vector tables as row shards;
``PIO_TPU_MESH_SERVE=1`` shards the scorer over the serving mesh).

engine.json:

    {
      "id": "twotower",
      "engineFactory": "templates.twotower",
      "datasource": {"params": {"app_name": "myapp"}},
      "algorithms": [{"name": "twotower", "params":
          {"out_dim": 64, "steps": 500}}]
    }

Query ``{"user": "u1", "num": 4}`` →
``{"itemScores": [{"item": "i5", "score": 0.93}, ...]}``, the
recommendation template's wire shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
from pio_tpu_torch.models.two_tower import (
    TwoTowerConfig,
    TwoTowerModel,
    train_two_tower,
)
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.parallel.mesh import MeshSpec
from pio_tpu_torch.templates.common import (
    DeviceScorerModel,
    PredictedResult,
    eval_app_name,
)
from pio_tpu_torch.templates.recommendation import (
    DataSourceParams,
    PreparedData,
    Query,
    RecommendationDataSource,
    RecommendationPreparator,
    batched_user_topn,
    predict_user_topn,
)
from pio_tpu_torch.templates.similarproduct import HitRateMetric
from pio_tpu_torch.workflow.shard_store import ShardableModel


@dataclasses.dataclass(frozen=True)
class TwoTowerParams(Params):
    embed_dim: int = 64
    hidden: int = 128
    out_dim: int = 64
    temperature: float = 20.0
    learning_rate: float = 1e-3
    steps: int = 500
    batch_size: int = 256
    seed: int = 0
    #: epoch feed: "off" and "auto" stage the batches on the device;
    #: "on" (the streamed feed) is ROADMAP §A.3
    stream: str = "auto"
    #: mesh split: model axis size (tp/ep); the other ranks ride data (dp)
    model_parallel: int = 1


@dataclasses.dataclass
class TwoTowerEngineModel(DeviceScorerModel, ShardableModel):
    """The vector tables with the id maps (reference l.76-95). Served over
    a serving mesh, the sharded scorer holds the device copy and the
    model keeps the host tables."""

    model: TwoTowerModel  # vector tables: tensors on the serving device
    user_index: BiMap
    item_index: BiMap

    shard_template = "two_tower"

    def _scorer_factors(self):
        return self.model.user_vectors, self.model.item_vectors

    def _release_device_tables(self, rows, cols) -> None:
        self.model = dataclasses.replace(
            self.model, user_vectors=torch.from_numpy(rows),
            item_vectors=torch.from_numpy(cols))

    def shard_arrays(self):
        return {
            "user_vectors": self.model.user_vectors,
            "item_vectors": self.model.item_vectors,
        }

    def replace_shard_arrays(self, arrays):
        return dataclasses.replace(
            self,
            model=dataclasses.replace(
                self.model,
                user_vectors=arrays["user_vectors"],
                item_vectors=arrays["item_vectors"],
            ),
        )


class TwoTowerAlgorithm(Algorithm):
    """Contrastive two-tower training on the interaction pairs."""

    params_class = TwoTowerParams
    query_class = Query
    splits_over_group = True

    def _mesh(self, ctx: ComputeContext):
        """The training mesh over the context's ranks: ``model_parallel``
        (clipped to the world) on model, the rest on data; None without
        a group."""
        if ctx.mesh is None:
            return None
        mp = max(1, min(self.params.model_parallel, ctx.num_devices))
        return ctx.mesh_for(MeshSpec(data=-1, model=mp))

    def train(
        self, ctx: ComputeContext, pd: PreparedData
    ) -> TwoTowerEngineModel:
        p: TwoTowerParams = self.params
        model = train_two_tower(
            self._mesh(ctx),
            pd.user_codes,
            pd.item_codes,
            n_users=len(pd.user_index),
            n_items=len(pd.item_index),
            config=TwoTowerConfig(
                embed_dim=p.embed_dim,
                hidden=p.hidden,
                out_dim=p.out_dim,
                temperature=p.temperature,
                learning_rate=p.learning_rate,
                steps=p.steps,
                batch_size=p.batch_size,
                seed=p.seed,
                stream=p.stream,
            ),
            checkpoint=ctx.checkpoint,
            checkpoint_every=ctx.checkpoint_every,
            device=ctx.device,
        )
        return TwoTowerEngineModel(model, pd.user_index, pd.item_index)

    def prepare_for_serving(
        self, model: TwoTowerEngineModel
    ) -> TwoTowerEngineModel:
        """Build the scorer on the model's device at deploy, and pay its
        first-call costs there rather than in the first request."""
        model.scorer(warmup=True)
        return model

    def predict(
        self, model: TwoTowerEngineModel, query: Query
    ) -> PredictedResult:
        return predict_user_topn(
            model, query, model.user_index, model.item_index
        )

    def warmup_query(self, model: TwoTowerEngineModel) -> Optional[Query]:
        """Any known user exercises the top-N path."""
        if len(model.user_index) == 0:
            return None
        return Query(user=model.user_index.inverse[0])

    def batch_predict(self, model: TwoTowerEngineModel, queries):
        """Known-user top-N queries batch into one device call per chunk
        (the recommendation template's routing)."""
        return batched_user_topn(
            self, model, queries, model.user_index, model.item_index,
            model.scorer,
        )


class TwoTowerServing(FirstServing):
    pass


@register_engine("templates.twotower")
def twotower_engine() -> Engine:
    return Engine(
        RecommendationDataSource,
        RecommendationPreparator,
        {"twotower": TwoTowerAlgorithm},
        TwoTowerServing,
    )


# -------------------------------------------------------------- evaluation
def twotower_evaluation(
    app_name: str = "",
    eval_k: int = 3,
    eval_num: int = 10,
    out_dims=(32, 64),
    steps: int = 300,
    batch_size: int = 256,
):
    """Ready-made ``pio eval`` sweep: k-fold HitRate@``eval_num`` on
    held-out interactions over an output-dimension grid, over the app
    ``app_name`` (``$PIO_TPU_EVAL_APP`` when empty). Run it with
    ``run_evaluation(ev, ev.engine_params_generator)``, or from the CLI:

        PIO_TPU_EVAL_APP=myapp python -m pio_tpu_torch eval \\
            pio_tpu_torch.templates.twotower:twotower_evaluation
    """
    if eval_k < 2:
        raise ValueError("k-fold evaluation needs eval_k >= 2")
    ds = DataSourceParams(
        app_name=eval_app_name(app_name), eval_k=eval_k,
        eval_mode="hitrate", eval_num=eval_num,
    )
    grid = [
        EngineParams(
            data_source_params=ds,
            algorithm_params_list=(
                ("twotower", TwoTowerParams(
                    out_dim=d, steps=steps, batch_size=batch_size,
                )),
            ),
        )
        for d in out_dims
    ]
    return Evaluation(
        twotower_engine(), HitRateMetric(),
        engine_params_generator=EngineParamsGenerator(grid),
    )
