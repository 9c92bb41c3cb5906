"""Multinomial naive Bayes over sparse TF-IDF bags.

Counterpart of the bag paths of ``pio_tpu/models/naive_bayes.py``:
:class:`MultinomialNBModel` (scored on the host in numpy, as the
reference's ``scores_bags`` is) and :func:`train_multinomial_nb_bags`,
whose ``[C, V]`` per-class feature sums are the bag-scatter kernel of the
embedding bag's backward on the card: one segment sum over the keys
``y·V + id`` with one column and gradient 1. The dense-matrix trainer and
the categorical NB come with the classification slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.ops.embedding import embedding_bag_backward_table


@dataclasses.dataclass
class MultinomialNBModel:
    """MLlib-``NaiveBayes``-parity model over numeric count features.

    Attributes:
        log_prior: [C] float32.
        log_theta: [C, D] float32 — smoothed log feature weights.
        feature_scales: [D] float32 per-column int8 quantization scales
            (None for bag-trained models, as every model of the port is).
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
    log_prior = torch.log(counts / counts.sum())
    smoothed = feat_sums + lambda_
    log_theta = torch.log(smoothed / smoothed.sum(dim=1, keepdim=True))
    return MultinomialNBModel(
        log_prior=log_prior.cpu().numpy(),
        log_theta=log_theta.cpu().numpy(),
    )
