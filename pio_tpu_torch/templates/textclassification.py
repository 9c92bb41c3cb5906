"""Text-classification template — label prediction from raw text.

Counterpart of ``pio_tpu/templates/textclassification.py``. The data
source reads ``$set`` documents (text + label) from the event store; the
preparator fits a TF-IDF vocabulary and packs each document into a
(token-id, weight) bag on the host. Two algorithms, selectable in
engine.json:

- ``mlp`` — sparse-input MLP (:mod:`pio_tpu_torch.models.mlp`), trained
  with full-batch Adam on the card: the forward and the backward of its
  first layer are the CUDA embedding-bag kernels.
- ``nb`` — multinomial NB over the bags; its per-class feature sums are
  the bag-scatter kernel (:mod:`pio_tpu_torch.models.naive_bayes`).

A query's text becomes a bag on the host; the MLP scores it on the card,
NB on the host, and the softmax and argmax run on the host.

Evaluation (``pio eval``): :func:`textclassification_evaluation`, k-fold
accuracy (:class:`TextAccuracyMetric`) over the MLP's hidden widths; each
fold and width trains ``train_mlp`` on the context's device, and the
FastEval cache prepares each fold once for every width.

Query ``{"text": "..."}`` → ``{"label": "...", "confidence": 0.93}``.
"""

from __future__ import annotations

import dataclasses

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
from pio_tpu_torch.models.mlp import MLPConfig, MLPModel, train_mlp
from pio_tpu_torch.models.naive_bayes import (
    MultinomialNBModel,
    train_multinomial_nb_bags,
)
from pio_tpu_torch.models.tfidf import TfIdfVectorizer
from pio_tpu_torch.ops.embedding import pack_bags
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.common import eval_app_name, resolve_app


# --------------------------------------------------------------- data source
@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    app_id: int = 0
    channel: str = ""
    #: documents are $set properties on this entity type
    entity_type: str = "content"
    text_attr: str = "text"
    label_attr: str = "label"
    eval_k: int = 0  # >0 enables k-fold read_eval


@dataclasses.dataclass
class TrainingData(SanityCheck):
    texts: list  # [n] str
    labels: list  # [n] str

    def sanity_check(self) -> None:
        if not self.texts:
            raise ValueError(
                "TrainingData is empty - no entities with text + label "
                "properties. Did you $set documents for this app?"
            )

    def __len__(self):
        return len(self.texts)


class TextDataSource(DataSource):
    """aggregateProperties → (text, label) rows."""

    params_class = DataSourceParams

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        p: DataSourceParams = self.params
        app_id, channel_id = resolve_app(p)
        props = Storage.get_pevents().aggregate_properties(
            app_id,
            entity_type=p.entity_type,
            channel_id=channel_id,
            required=[p.text_attr, p.label_attr],
        )
        texts, labels = [], []
        for _eid, pm in sorted(props.items()):
            texts.append(str(pm.get(p.text_attr)))
            labels.append(str(pm.get(p.label_attr)))
        return TrainingData(texts=texts, labels=labels)

    def read_eval(self, ctx: ComputeContext):
        """k-fold split by document index (``split_data``): each held-out
        document is a query, its label the actual."""
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            return []
        td = self.read_training(ctx)
        return split_data(
            p.eval_k,
            list(zip(td.texts, td.labels)),
            to_training_data=lambda rows: TrainingData(
                texts=[t for t, _ in rows], labels=[lab for _, lab in rows]
            ),
            to_query_actual=lambda row: (Query(text=row[0]), row[1]),
        )


# --------------------------------------------------------------- preparator
@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    max_features: int = 65536
    #: cap on tokens per document bag (rounded up to a multiple of 8)
    max_doc_tokens: int = 256


@dataclasses.dataclass
class PreparedData:
    vectorizer: TfIdfVectorizer
    ids: np.ndarray  # [n, L] int32 bags
    weights: np.ndarray  # [n, L] float32
    label_codes: np.ndarray  # [n] int32
    label_index: BiMap
    token_cap: int = 0  # per-doc truncation cap applied at train time


class TextPreparator(Preparator):
    """Fit TF-IDF vocab + label index; documents → packed sparse bags."""

    params_class = PreparatorParams

    def prepare(self, ctx: ComputeContext, td: TrainingData) -> PreparedData:
        p: PreparatorParams = self.params
        vec = TfIdfVectorizer.fit(td.texts, max_features=p.max_features)
        bags = [
            _truncate_bag(*vec.transform_doc(t), p.max_doc_tokens)
            for t in td.texts
        ]
        longest = max((len(b[0]) for b in bags), default=1)
        ids, w = pack_bags(
            [b[0] for b in bags],
            [b[1] for b in bags],
            max_len=min(max(longest, 1), p.max_doc_tokens),
        )
        label_index = BiMap.string_int(td.labels)
        fwd = label_index.to_dict()
        codes = np.fromiter(
            (fwd[label] for label in td.labels), np.int32, len(td.labels)
        )
        return PreparedData(
            vec, ids, w, codes, label_index, token_cap=p.max_doc_tokens
        )


# ----------------------------------------------------------------- algorithm


@dataclasses.dataclass(frozen=True)
class Query:
    text: str = ""


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: str = ""
    confidence: float = 0.0

    def to_dict(self) -> dict:
        return {"label": self.label, "confidence": self.confidence}


def _truncate_bag(ids, w, width: int):
    """Cut a bag to ``width`` tokens keeping the *highest-weight* ones.

    transform_doc returns ids ascending (≈ descending document frequency),
    so a head-slice would keep the common low-idf tokens and drop the rare
    discriminative ones.
    """
    if len(ids) <= width:
        return ids, w
    keep = np.argsort(-np.asarray(w))[:width]
    keep.sort()  # preserve id order within the kept set
    return np.asarray(ids)[keep], np.asarray(w)[keep]


def _query_bag(vec: TfIdfVectorizer, text: str, width: int, cap: int = 0):
    """Pack one query doc to the training bag width.

    ``cap`` is the train-time truncation cap: the packed width is rounded
    up, so truncating at ``width`` would keep more tokens for queries than
    training docs got — train/serve skew.
    """
    cap = min(width, cap) if cap else width
    ids, w = _truncate_bag(*vec.transform_doc(text), cap)
    out_i = np.zeros((1, width), np.int32)
    out_w = np.zeros((1, width), np.float32)
    n = len(ids)
    out_i[0, :n] = ids
    out_w[0, :n] = w
    return out_i, out_w


@dataclasses.dataclass(frozen=True)
class MLPParams(Params):
    hidden: int = 128
    iterations: int = 200
    learning_rate: float = 0.01
    reg: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class TextMLPModel:
    mlp: MLPModel
    vectorizer: TfIdfVectorizer
    label_index: BiMap
    bag_width: int  # packed width (rounded up at train time)
    token_cap: int = 0  # truncation cap used at train time (0 = bag_width)


class MLPAlgorithm(Algorithm):
    """Sparse-input MLP over TF-IDF bags (CUDA embedding-bag hot path)."""

    params_class = MLPParams
    splits_over_group = True
    query_class = Query

    def train(self, ctx: ComputeContext, pd: PreparedData) -> TextMLPModel:
        p: MLPParams = self.params
        mlp = train_mlp(
            ctx,
            pd.ids,
            pd.weights,
            pd.label_codes,
            n_features=pd.vectorizer.n_features,
            n_classes=len(pd.label_index),
            config=MLPConfig(
                hidden=p.hidden,
                iterations=p.iterations,
                learning_rate=p.learning_rate,
                reg=p.reg,
                seed=p.seed,
            ),
        )
        return TextMLPModel(
            mlp, pd.vectorizer, pd.label_index, pd.ids.shape[1],
            token_cap=pd.token_cap,
        )

    def predict(self, model: TextMLPModel, query: Query) -> PredictedResult:
        ids, w = _query_bag(
            model.vectorizer, query.text, model.bag_width, model.token_cap
        )
        return _proba_result(
            model.mlp.predict_proba(ids, w)[0], model.label_index
        )

    def warmup_query(self, model: TextMLPModel) -> Query:
        """Bag width is fixed per model, so any text (even empty)
        produces the serving input shape."""
        return Query(text="warmup")

    def batch_predict(self, model: TextMLPModel, queries):
        """Tokenize per query on host, then one device forward per
        bounded chunk of stacked [B, L] bags."""
        out = []
        for chunk in _chunks(queries):
            ids, w = _stack_bags(model, chunk)
            proba = model.mlp.predict_proba(ids, w)
            out.extend(
                (i, _proba_result(p, model.label_index))
                for (i, _), p in zip(chunk, proba)
            )
        return out


@dataclasses.dataclass(frozen=True)
class NBParams(Params):
    lambda_: float = 1.0


@dataclasses.dataclass
class TextNBModel:
    nb: MultinomialNBModel
    vectorizer: TfIdfVectorizer
    label_index: BiMap
    bag_width: int  # packed width (rounded up at train time)
    token_cap: int = 0  # truncation cap used at train time (0 = bag_width)


class NBAlgorithm(Algorithm):
    """Multinomial NB over the sparse tf-idf bags (bag-scatter training on
    the card, host scoring)."""

    params_class = NBParams
    query_class = Query

    def train(self, ctx: ComputeContext, pd: PreparedData) -> TextNBModel:
        p: NBParams = self.params
        nb = train_multinomial_nb_bags(
            pd.ids,
            pd.weights,
            pd.label_codes,
            n_features=pd.vectorizer.n_features,
            n_classes=len(pd.label_index),
            lambda_=p.lambda_,
            device=ctx.device,
        )
        return TextNBModel(
            nb, pd.vectorizer, pd.label_index, pd.ids.shape[1],
            token_cap=pd.token_cap,
        )

    def predict(self, model: TextNBModel, query: Query) -> PredictedResult:
        ids, w = _query_bag(
            model.vectorizer, query.text, model.bag_width, model.token_cap
        )
        log_p = model.nb.scores_bags(ids, w)[0]
        return _proba_result(_softmax(log_p), model.label_index)

    def warmup_query(self, model: TextNBModel) -> Query:
        return Query(text="warmup")

    def batch_predict(self, model: TextNBModel, queries):
        """Tokenize per query on host, then one scores_bags call per
        bounded chunk (its [C, B, L] gather scales with the chunk)."""
        out = []
        for chunk in _chunks(queries):
            ids, w = _stack_bags(model, chunk)
            log_p = model.nb.scores_bags(ids, w)
            out.extend(
                (i, _proba_result(_softmax(lp), model.label_index))
                for (i, _), lp in zip(chunk, log_p)
            )
        return out


#: batch-scoring chunk: bounds the [B, L] bags (the kernel's launch, and
#: NB's [C, B, L] gather) regardless of query-file size
_BATCH_CHUNK = 1024


def _chunks(queries, n: int = _BATCH_CHUNK):
    for k in range(0, len(queries), n):
        yield queries[k:k + n]


def _stack_bags(model, queries):
    """[B, L] id/weight bags from the queries' texts (host tokenize)."""
    bags = [
        _query_bag(
            model.vectorizer, q.text, model.bag_width, model.token_cap
        )
        for _, q in queries
    ]
    return (
        np.concatenate([b[0] for b in bags]),
        np.concatenate([b[1] for b in bags]),
    )


def _softmax(log_p: np.ndarray) -> np.ndarray:
    p = np.exp(log_p - log_p.max())
    return p / p.sum()


def _proba_result(proba: np.ndarray, label_index) -> PredictedResult:
    """Shared argmax+confidence tail so predict/batch_predict agree."""
    code = int(np.argmax(proba))
    return PredictedResult(
        label=label_index.inverse[code], confidence=float(proba[code])
    )


class TextServing(FirstServing):
    pass


@register_engine("templates.textclassification")
def textclassification_engine() -> Engine:
    return Engine(
        TextDataSource,
        TextPreparator,
        {"mlp": MLPAlgorithm, "nb": NBAlgorithm},
        TextServing,
    )


# -------------------------------------------------------------- evaluation
class TextAccuracyMetric(AverageMetric):
    """Fraction of held-out documents labeled correctly."""

    def calculate_one(self, query, prediction, actual):
        return 1.0 if prediction.label == actual else 0.0


def textclassification_evaluation(
    app_name: str = "",
    eval_k: int = 3,
    hiddens=(64, 128),
):
    """Ready-made ``pio eval`` sweep over the app ``app_name``
    (``$PIO_TPU_EVAL_APP`` when empty): k-fold
    accuracy over the MLP's hidden widths. Run it with
    ``run_evaluation(ev, ev.engine_params_generator)``."""
    if eval_k < 2:
        raise ValueError("k-fold evaluation needs eval_k >= 2")
    app_name = eval_app_name(app_name)
    ds = DataSourceParams(app_name=app_name, eval_k=eval_k)
    grid = [
        EngineParams(
            data_source_params=ds,
            preparator_params=PreparatorParams(),
            algorithm_params_list=(("mlp", MLPParams(hidden=h)),),
        )
        for h in hiddens
    ]
    return Evaluation(
        textclassification_engine(), TextAccuracyMetric(),
        engine_params_generator=EngineParamsGenerator(grid),
    )
