"""Naive Bayes: categorical, and multinomial over dense features or bags.

Counterpart of ``pio_tpu/models/naive_bayes.py``:

- the categorical NB of the reference's e2 helper
  (:class:`LabeledPoint`, :class:`NaiveBayesModel`,
  :func:`train_naive_bayes`): host code, copied; its
  :meth:`~NaiveBayesModel.predict_batch` runs as torch ops on a device;
- :class:`MultinomialNBModel`, scored on the host in numpy as the
  reference's is;
- :func:`train_multinomial_nb`, the classification template's trainer over
  a dense ``[N, D]`` matrix: its per-class feature sums are one one-hot
  ``[C, N] @ [N, D]`` product on the device;
- :func:`train_multinomial_nb_bags`, the text template's trainer over
  sparse TF-IDF bags: its ``[C, V]`` per-class feature sums are the
  bag-scatter kernel of the embedding bag's backward on the card, one
  segment sum over the keys ``y·V + id`` with one column and gradient 1.

Both trainers sum in a fixed order, without atomics, so a run gives the
same bits twice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.models.logreg import feature_scales
from pio_tpu_torch.ops.embedding import embedding_bag_backward_table


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    """A training example: string label + categorical string features.

    ≙ reference ``LabeledPoint(label: String, features: Seq[String])``.
    """

    label: str
    features: Tuple[str, ...]


@dataclasses.dataclass
class NaiveBayesModel:
    """Dense categorical-NB model.

    Attributes:
        labels: label vocabulary, index = label code.
        feature_vocabs: per position, value vocabulary (index = value code).
        priors: [L] float32 log P(label).
        likelihoods: per position f, [L, V_f] float32 log P(value | label)
            with add-one smoothing.
    """

    labels: List[str]
    feature_vocabs: List[Dict[str, int]]
    priors: np.ndarray
    likelihoods: List[np.ndarray]

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Optional[float] = None,
    ) -> Optional[float]:
        """Log score of ``point`` under its own label.

        Returns None when the label is unknown, or when a feature value is
        out-of-vocabulary and no ``default_likelihood`` is given (parity with
        the reference's ``logScore(point, defaultLikelihood)`` Option result).
        """
        self._check_arity([point.features])
        if point.label not in self._label_index:
            return None
        li = self._label_index[point.label]
        total = float(self.priors[li])
        for f, value in enumerate(point.features):
            code = self.feature_vocabs[f].get(value)
            if code is None:
                if default_likelihood is None:
                    return None
                total += default_likelihood
            else:
                total += float(self.likelihoods[f][li, code])
        return total

    def _check_arity(self, features: Sequence[Sequence[str]]) -> None:
        want = len(self.feature_vocabs)
        for f in features:
            if len(f) != want:
                raise ValueError(
                    f"feature tuple has {len(f)} positions, model expects {want}"
                )

    def predict(self, features: Sequence[str]) -> str:
        """Label with the highest posterior log score."""
        self._check_arity([features])
        scores = self.priors.copy()
        for f, value in enumerate(features):
            code = self.feature_vocabs[f].get(value)
            if code is not None:
                scores = scores + self.likelihoods[f][:, code]
        return self.labels[int(np.argmax(scores))]

    def encode_batch(
        self, points: Sequence[Sequence[str]]
    ) -> List[np.ndarray]:
        """Encode feature strings to dense codes (-1 = out-of-vocab)."""
        self._check_arity(points)
        cols = []
        for f, vocab in enumerate(self.feature_vocabs):
            cols.append(
                np.fromiter(
                    (vocab.get(p[f], -1) for p in points),
                    np.int32,
                    len(points),
                )
            )
        return cols

    def predict_batch(self, points: Sequence[Sequence[str]],
                      device: DeviceLike = None) -> List[str]:
        """Batched argmax prediction as torch gathers and sums on
        ``device`` (CUDA unless told otherwise). An out-of-vocabulary
        value adds 0; a tie goes to the lower label code (``argmax``
        returns the first maximum, as ``jnp.argmax`` does)."""
        if not points:
            return []
        dev = resolve_device(device)
        codes = self.encode_batch(points)
        scores = torch.from_numpy(self.priors).to(dev).expand(
            len(points), len(self.labels))
        for f, col in enumerate(codes):
            lik = torch.from_numpy(self.likelihoods[f]).to(dev)  # [L, V_f]
            col = torch.from_numpy(col).to(dev).long()
            gathered = lik[:, col.clamp(min=0)].T  # [B, L]
            scores = scores + torch.where(
                (col >= 0)[:, None], gathered, 0.0)
        best = torch.argmax(scores, dim=1).cpu().numpy()
        return [self.labels[int(i)] for i in best]

    @property
    def _label_index(self) -> Dict[str, int]:
        if not hasattr(self, "_label_index_cache"):
            object.__setattr__(
                self,
                "_label_index_cache",
                {lb: i for i, lb in enumerate(self.labels)},
            )
        return self._label_index_cache  # type: ignore[attr-defined]


def train_naive_bayes(points: Sequence[LabeledPoint]) -> NaiveBayesModel:
    """Train categorical NB with add-one (Laplace) smoothing.

    ≙ reference ``CategoricalNaiveBayes.train``. Counting is vectorized:
    labels/values are dense-coded, then per-position count matrices come from
    ``np.add.at`` scatter-adds, on the host.
    """
    if not points:
        raise ValueError("train_naive_bayes needs at least one LabeledPoint")
    n_features = len(points[0].features)
    for p in points:
        if len(p.features) != n_features:
            raise ValueError(
                "all LabeledPoints must have the same number of features"
            )

    labels: List[str] = []
    label_index: Dict[str, int] = {}
    y = np.empty(len(points), np.int32)
    for i, p in enumerate(points):
        if p.label not in label_index:
            label_index[p.label] = len(labels)
            labels.append(p.label)
        y[i] = label_index[p.label]
    n_labels = len(labels)

    label_counts = np.bincount(y, minlength=n_labels).astype(np.float64)
    priors = np.log(label_counts / len(points)).astype(np.float32)

    feature_vocabs: List[Dict[str, int]] = []
    likelihoods: List[np.ndarray] = []
    for f in range(n_features):
        vocab: Dict[str, int] = {}
        codes = np.empty(len(points), np.int32)
        for i, p in enumerate(points):
            v = p.features[f]
            if v not in vocab:
                vocab[v] = len(vocab)
            codes[i] = vocab[v]
        counts = np.zeros((n_labels, len(vocab)), np.float64)
        np.add.at(counts, (y, codes), 1.0)
        # add-one smoothing over the observed vocabulary
        lik = np.log(
            (counts + 1.0)
            / (label_counts[:, None] + len(vocab))
        ).astype(np.float32)
        feature_vocabs.append(vocab)
        likelihoods.append(lik)

    return NaiveBayesModel(labels, feature_vocabs, priors, likelihoods)


# --------------------------------------------------------- multinomial NB
@dataclasses.dataclass
class MultinomialNBModel:
    """MLlib-``NaiveBayes``-parity model over numeric count features.

    Attributes:
        log_prior: [C] float32.
        log_theta: [C, D] float32 — smoothed log feature weights.
        feature_scales: [D] float32 per-column int8 quantization scales
            of the dense training features (None for bag-trained models):
            the serving int8 wire folds them into the resident weights
            (:mod:`pio_tpu_torch.server.residency`).
    """

    log_prior: np.ndarray
    log_theta: np.ndarray
    feature_scales: Optional[np.ndarray] = None

    @property
    def n_classes(self) -> int:
        return len(self.log_prior)

    def scores(self, X: np.ndarray) -> np.ndarray:
        return X.astype(np.float32) @ self.log_theta.T + self.log_prior

    def scores_bags(self, ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """Log-posterior scores from packed sparse bags (no densify).

        ``[B, L]`` ids/weights → ``[B, C]``: log_prior + Σ_l w_l ·
        log_theta[:, id_l]. Pad slots (weight 0) contribute nothing.
        """
        gathered = self.log_theta[:, ids]  # [C, B, L]
        return (
            np.einsum("cbl,bl->bc", gathered, weights.astype(np.float32))
            + self.log_prior
        )

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.scores(X), axis=1).astype(np.int32)


def _smoothed_logs(counts: torch.Tensor, feat_sums: torch.Tensor,
                   lambda_: float):
    """(log prior [C], log theta [C, D]) as host float32 arrays."""
    log_prior = torch.log(counts / counts.sum())
    smoothed = feat_sums + lambda_
    log_theta = torch.log(smoothed / smoothed.sum(dim=1, keepdim=True))
    return log_prior.cpu().numpy(), log_theta.cpu().numpy()


def train_multinomial_nb(
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    lambda_: float = 1.0,
    device: DeviceLike = None,
) -> MultinomialNBModel:
    """Multinomial NB with Laplace smoothing ``lambda_`` over a dense
    ``[N, D]`` feature matrix, on ``device`` (CUDA unless told otherwise).

    ≙ the reference classification template's ``NaiveBayes.train(data,
    lambda)``. The per-class feature sums are one one-hot ``[C, N] @
    [N, D]`` product: a GEMM sums in a fixed order, so two runs give the
    same bits (``index_add_`` on CUDA adds with atomics, whose order
    varies), and its products by 1 and 0 are exact. A label outside
    ``[0, C)`` counts nowhere, as the reference's ``segment_sum`` drops it.
    Returns the training features' int8 scales too.
    """
    dev = resolve_device(device)
    X = np.ascontiguousarray(X, np.float32)
    y = np.ascontiguousarray(y, np.int32)
    if (X < 0).any():
        raise ValueError("multinomial NB requires non-negative features")
    y_t = torch.from_numpy(y).to(dev)
    onehot = (torch.arange(n_classes, dtype=torch.int32, device=dev)[:, None]
              == y_t[None, :]).float()  # [C, N]
    feat_sums = onehot @ torch.from_numpy(X).to(dev)
    log_prior, log_theta = _smoothed_logs(onehot.sum(dim=1), feat_sums,
                                          lambda_)
    return MultinomialNBModel(log_prior=log_prior, log_theta=log_theta,
                              feature_scales=feature_scales(X))


def train_multinomial_nb_bags(
    ids: np.ndarray,
    weights: np.ndarray,
    y: np.ndarray,
    n_features: int,
    n_classes: int,
    lambda_: float = 1.0,
    device: DeviceLike = None,
) -> MultinomialNBModel:
    """Multinomial NB with Laplace smoothing ``lambda_`` from packed bags,
    on ``device`` (CUDA unless told otherwise).

    The per-class feature sums ``[C, V]`` are one segment sum over the
    flattened ``class·V + token_id`` keys (no ``[n, V]`` densification):
    :func:`~pio_tpu_torch.ops.embedding.embedding_bag_backward_table` with
    ``g = 1`` over ``C·V`` rows of one column. Pad slots (id 0, weight 0)
    contribute nothing. The class counts are a ``bincount``.

    Args:
        ids/weights: [n, L] bags in the ``pack_bags`` layout.
        y: [n] int class codes.
    """
    dev = resolve_device(device)
    ids = np.asarray(ids, np.int32)
    weights = np.ascontiguousarray(weights, np.float32)
    y = np.asarray(y, np.int32)
    if (weights < 0).any():
        raise ValueError("multinomial NB requires non-negative features")
    if n_classes * n_features >= 2 ** 31:
        raise ValueError(f"{n_classes} x {n_features} keys overflow int32")
    keys = y.astype(np.int64)[:, None] * n_features + ids
    keys_t = torch.from_numpy(keys.astype(np.int32)).to(dev)
    w_t = torch.from_numpy(weights).to(dev)
    y_t = torch.from_numpy(y.astype(np.int64)).to(dev)
    ones = torch.ones((len(y), 1), dtype=torch.float32, device=dev)

    counts = torch.bincount(y_t, minlength=n_classes).to(torch.float32)
    feat_sums = embedding_bag_backward_table(
        ones, keys_t, w_t, n_classes * n_features
    ).reshape(n_classes, n_features)
    log_prior, log_theta = _smoothed_logs(counts, feat_sums, lambda_)
    return MultinomialNBModel(log_prior=log_prior, log_theta=log_theta)
