"""Sequence-recommendation template — next-item prediction over histories.

Counterpart of ``pio_tpu/templates/sequence.py``: the data
source assembles each user's time-ordered event stream (view, buy and
rate events sorted by event time), the preparator packs the histories
into a right-padded code matrix (code 0 is the pad), and the algorithm
trains the causal transformer of :mod:`pio_tpu_torch.models.seqrec` on
the context's device; a query scores the next item from the user's
training-time history or from the history it carries.

engine.json:

    {
      "id": "seqrec",
      "engineFactory": "templates.sequence",
      "datasource": {"params": {"app_name": "myapp"}},
      "algorithms": [{"name": "seqrec", "params":
          {"d_model": 64, "n_layers": 2, "max_len": 64}}]
    }

Query ``{"user": "u1", "num": 4}`` (or ``{"history": ["i1", "i2"], ...}``)
→ ``{"itemScores": [{"item": "i5", "score": 3.1}, ...]}``.

Under a process group the model trains over a mesh of the group's ranks
split by ``seq_parallel``, ``pipe_parallel`` and ``model_parallel``, the
rest on data (reference l.252-266). The engine model is a
``ShardableModel``: ``PIO_TPU_SHARDED_PERSIST=1`` persists its
parameters as row shards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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
from pio_tpu_torch.controller.params import Params
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.als import top_n
from pio_tpu_torch.models.seqrec import SeqRecConfig, SeqRecModel, train_seqrec
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.parallel.mesh import MeshSpec
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.common import (
    ItemScore,
    PredictedResult,
    eval_app_name,
    fold_assignments,
    resolve_app,
)
from pio_tpu_torch.templates.similarproduct import HitRateMetric
from pio_tpu_torch.workflow.shard_store import ShardableModel


# --------------------------------------------------------------- data source
@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    app_id: int = 0
    channel: str = ""
    #: events whose target entity enters the user's history, in time order
    event_names: Tuple[str, ...] = ("view", "buy", "rate")
    min_history: int = 2
    eval_k: int = 0  # >0 enables k-fold leave-last-out read_eval
    eval_num: int = 10


@dataclasses.dataclass
class TrainingData(SanityCheck):
    #: per user: time-ordered item-id history
    histories: Dict[str, List[str]]

    def sanity_check(self) -> None:
        if not self.histories:
            raise ValueError(
                "TrainingData is empty - no user event streams found. "
                "Did you import events for this app?"
            )

    def __len__(self):
        return len(self.histories)


class SequenceDataSource(DataSource):
    """Full event streams per user, ordered by eventTime."""

    params_class = DataSourceParams

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        p: DataSourceParams = self.params
        app_id, channel_id = resolve_app(p)
        frame = Storage.get_pevents().find_frame(
            app_id,
            channel_id=channel_id,
            event_names=list(p.event_names),
            entity_type="user",
            target_entity_type="item",
        )
        order = np.argsort(frame.event_time_us, kind="stable")
        histories: Dict[str, List[str]] = {}
        for i in order:
            histories.setdefault(str(frame.entity_id[i]), []).append(
                str(frame.target_entity_id[i])
            )
        histories = {
            u: h for u, h in histories.items() if len(h) >= p.min_history
        }
        return TrainingData(histories=histories)

    def read_eval(self, ctx: ComputeContext):
        """k-fold leave-last-out next-item protocol: users split into k
        folds; a fold's users train on their history minus the last item
        and are queried with that prefix, the actual being the held-out
        last item. Other folds' users train on their full history."""
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            return []
        if p.eval_k == 1:
            raise ValueError("k-fold cross-validation needs eval_k >= 2")
        td = self.read_training(ctx)
        users = sorted(td.histories)
        # seeded user folds: sorted user ids often encode signup order
        fold_of = fold_assignments(len(users), p.eval_k)
        folds = []
        for k in range(p.eval_k):
            train_h: Dict[str, List[str]] = {}
            qa = []
            for r, u in enumerate(users):
                h = td.histories[u]
                if fold_of[r] == k and len(h) > p.min_history:
                    train_h[u] = h[:-1]
                    qa.append(
                        (Query(history=tuple(h[:-1]), num=p.eval_num),
                         str(h[-1]))
                    )
                else:
                    train_h[u] = h
            folds.append((TrainingData(histories=train_h), {"fold": k}, qa))
        return folds


# --------------------------------------------------------------- preparator
@dataclasses.dataclass
class PreparedData:
    item_index: BiMap  # code 0 is reserved for padding
    sequences: np.ndarray  # [n_users, T] int32, right-padded with 0
    user_rows: Dict[str, int]  # user id → row in sequences


class SequencePreparator(Preparator):
    """Index items (code 0 = pad) and pack histories into a dense matrix."""

    def prepare(self, ctx: ComputeContext, td: TrainingData) -> PreparedData:
        all_items: List[str] = []
        for h in td.histories.values():
            all_items.extend(h)
        # BiMap codes start at 0; shift by +1 so 0 stays the pad id
        item_index = BiMap.string_int_by_frequency(all_items)
        fwd = item_index.to_dict()
        users = sorted(td.histories)
        t = max(len(td.histories[u]) for u in users)
        seqs = np.zeros((len(users), t), np.int32)
        for r, u in enumerate(users):
            h = td.histories[u]
            seqs[r, : len(h)] = [fwd[i] + 1 for i in h]
        return PreparedData(
            item_index=item_index,
            sequences=seqs,
            user_rows={u: r for r, u in enumerate(users)},
        )


# ----------------------------------------------------------------- algorithm
@dataclasses.dataclass(frozen=True)
class Query:
    user: str = ""
    history: Tuple[str, ...] = ()  # anonymous/session queries
    num: int = 10


@dataclasses.dataclass(frozen=True)
class SeqRecParams(Params):
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    ffn: int = 128
    max_len: int = 64
    learning_rate: float = 1e-3
    steps: int = 300
    seed: int = 0
    #: sequence-parallel attention mode: "ring" or "ulysses" (all-to-all)
    attention: str = "ring"
    #: rows per optimizer step; 0 = full-batch
    batch_size: int = 0
    #: epoch feed: "off" and "auto" stage it on the device; "on" (the
    #: streamed feed) is ROADMAP §A.3
    stream: str = "auto"
    #: mesh splits; the other ranks ride the data axis
    seq_parallel: int = 1
    pipe_parallel: int = 1
    model_parallel: int = 1


@dataclasses.dataclass
class SeqRecEngineModel(ShardableModel):
    model: SeqRecModel
    item_index: BiMap
    #: training-time histories for user-id queries
    user_histories: Dict[str, List[int]]

    shard_template = "seqrec"

    def shard_arrays(self):
        """The layer-stacked parameters flat, under the ``/`` paths the
        partition rules match (reference l.213-231)."""
        out = {}
        for k, v in self.model.params.items():
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    out[f"{k}/{k2}"] = v2
            else:
                out[k] = v
        return out

    def replace_shard_arrays(self, arrays):
        params: Dict = {}
        for name, arr in arrays.items():
            if "/" in name:
                outer, inner = name.split("/", 1)
                params.setdefault(outer, {})[inner] = arr
            else:
                params[name] = arr
        return dataclasses.replace(
            self, model=dataclasses.replace(self.model, params=params)
        )


class SeqRecAlgorithm(Algorithm):
    """Causal-transformer next-item training over the packed histories."""

    params_class = SeqRecParams
    query_class = Query
    splits_over_group = True

    def _mesh(self, ctx: ComputeContext):
        """The training mesh over the context's ranks: the seq, pipe and
        model splits (each clipped to what the world leaves), the rest on
        data; None without a group."""
        if ctx.mesh is None:
            return None
        p: SeqRecParams = self.params
        n = ctx.num_devices
        sp = max(1, min(p.seq_parallel, n))
        pp = max(1, min(p.pipe_parallel, n // sp))
        mp = max(1, min(p.model_parallel, n // (sp * pp)))
        return ctx.mesh_for(MeshSpec(data=-1, seq=sp, pipe=pp, model=mp))

    def train(
        self, ctx: ComputeContext, pd: PreparedData
    ) -> SeqRecEngineModel:
        p: SeqRecParams = self.params
        # train_seqrec keeps each row's newest max_len events (tail), the
        # same window predict scores
        model = train_seqrec(
            self._mesh(ctx),
            pd.sequences,
            n_items=len(pd.item_index),
            config=SeqRecConfig(
                d_model=p.d_model,
                n_heads=p.n_heads,
                n_layers=p.n_layers,
                ffn=p.ffn,
                max_len=p.max_len,
                learning_rate=p.learning_rate,
                steps=p.steps,
                attention=p.attention,
                seed=p.seed,
                batch_size=p.batch_size,
                stream=p.stream,
            ),
            checkpoint=ctx.checkpoint,
            checkpoint_every=ctx.checkpoint_every,
            device=ctx.device,
        )
        user_histories = {
            u: [int(x) for x in pd.sequences[r] if x > 0]
            for u, r in pd.user_rows.items()
        }
        return SeqRecEngineModel(model, pd.item_index, user_histories)

    def _history_codes(
        self, model: SeqRecEngineModel, query: Query
    ) -> Optional[List[int]]:
        if query.history:
            codes = [
                c + 1
                for c in (
                    model.item_index.get(i) for i in query.history
                )
                if c is not None
            ]
            return codes or None
        return model.user_histories.get(query.user)

    def warmup_query(self, model: SeqRecEngineModel) -> Optional[Query]:
        """Any user with a training-time history drives the [B, T]
        transformer forward."""
        for u, hist in model.user_histories.items():
            if hist:
                return Query(user=u)
        return None

    def predict(
        self, model: SeqRecEngineModel, query: Query
    ) -> PredictedResult:
        codes = self._history_codes(model, query)
        if not codes:
            return PredictedResult()  # unknown user / empty history
        scores = model.model.next_item_scores(
            _history_rows([codes], model.model.config.max_len)
        )[0]
        return _seq_top_result(scores, query.num, model.item_index)

    def batch_predict(self, model: SeqRecEngineModel, queries):
        """Every resolvable history stacked into one [B, T] forward."""
        out = []
        bidx, bq, bcodes = [], [], []
        for i, q in queries:
            codes = self._history_codes(model, q)
            if not codes:
                out.append((i, PredictedResult()))
                continue
            bidx.append(i)
            bq.append(q)
            bcodes.append(codes)
        if bidx:
            rows = _history_rows(bcodes, model.model.config.max_len)
            scores = model.model.next_item_scores(rows)
            for i, q, row in zip(bidx, bq, scores):
                out.append(
                    (i, _seq_top_result(row, q.num, model.item_index))
                )
        return out


def _history_rows(code_lists, max_len: int) -> np.ndarray:
    """Right-truncated, zero-padded [B, max_len] history batch."""
    rows = np.zeros((len(code_lists), max_len), np.int32)
    for r, codes in enumerate(code_lists):
        tail = codes[-max_len:]
        rows[r, : len(tail)] = tail
    return rows


def _seq_top_result(scores, num: int, item_index) -> PredictedResult:
    """Shared top-N tail (scores[0] is the pad row, shifted off here) so
    predict and batch_predict cannot diverge."""
    idx, vals = top_n(scores[1:], num)
    inv = item_index.inverse
    return PredictedResult(
        tuple(ItemScore(inv[int(i)], float(v)) for i, v in zip(idx, vals))
    )


class SequenceServing(FirstServing):
    pass


@register_engine("templates.sequence")
def sequence_engine() -> Engine:
    return Engine(
        SequenceDataSource,
        SequencePreparator,
        {"seqrec": SeqRecAlgorithm},
        SequenceServing,
    )


# -------------------------------------------------------------- evaluation
def sequence_evaluation(
    app_name: str = "",
    eval_k: int = 3,
    eval_num: int = 10,
    layer_grid=(1, 2),
    steps: int = 200,
    d_model: int = 32,
    max_len: int = 32,
):
    """Ready-made ``pio eval`` sweep: k-fold leave-last-out
    HitRate@``eval_num`` over a transformer-depth grid, over the app
    ``app_name`` (``$PIO_TPU_EVAL_APP`` when empty):

        PIO_TPU_EVAL_APP=myapp python -m pio_tpu_torch eval \\
            pio_tpu_torch.templates.sequence:sequence_evaluation
    """
    if eval_k < 2:
        raise ValueError("k-fold evaluation needs eval_k >= 2")
    ds = DataSourceParams(
        app_name=eval_app_name(app_name), eval_k=eval_k, eval_num=eval_num
    )
    grid = [
        EngineParams(
            data_source_params=ds,
            algorithm_params_list=(
                ("seqrec", SeqRecParams(
                    d_model=d_model, n_layers=n, steps=steps,
                    max_len=max_len,
                )),
            ),
        )
        for n in layer_grid
    ]
    return Evaluation(
        sequence_engine(), HitRateMetric(),
        engine_params_generator=EngineParamsGenerator(grid),
    )
