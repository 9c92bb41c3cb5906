"""Helpers shared by the templates.

The port's copy of ``pio_tpu/templates/common.py`` (the port imports
nothing of ``pio_tpu``): the app lookup (``resolve_app``), the item-score
result types, the per-model top-N scorer cache (:class:`DeviceScorerModel`),
the k-fold helpers of a data source's ``read_eval``, and the item-scoring
rules of the similar-product and e-commerce templates
(:func:`l2_normalize_rows`, :func:`business_rule_mask`,
:func:`top_item_scores`: host numpy, copied unchanged, so that they give
the reference's bits).
"""

from __future__ import annotations

import dataclasses
import threading as _threading
from typing import FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch

from pio_tpu_torch.data.store import resolve_channel
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.utils import knobs


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...] = ()

    def to_dict(self) -> dict:
        return {
            "itemScores": [
                {"item": s.item, "score": s.score} for s in self.item_scores
            ]
        }


class DeviceScorerModel:
    """Lazy per-model :class:`~pio_tpu_torch.ops.topn.DeviceTopNScorer`
    cache that pickling drops. Subclasses return the (row_factors,
    col_factors) tensors from :meth:`_scorer_factors`; the scorer lives on
    their device — the device the model was built or loaded on
    (``load_models_for_instance`` puts a persisted model's tensors on its
    context's device), never a default.

    The serving mesh channel (reference l.63, 73): a query server with
    ``PIO_TPU_MESH_SERVE=1`` sets ``_serve_mesh`` (a tuple of devices) on
    the model before building its scorer, which then shards both tables
    over those devices; the model hands its device tables over to the
    scorer's shards (:meth:`_release_device_tables`), so the card holds
    them once."""

    def _scorer_factors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _release_device_tables(self, rows: np.ndarray,
                               cols: np.ndarray) -> None:
        """Swap the model's device tables for the sharded scorer's host
        mirrors (a model without this hook keeps its tables)."""

    def scorer(self, warmup: bool = False):
        """The scorer, built once per deploy lifetime. Lock-guarded:
        concurrent first requests in the threaded query server must not
        each build one and re-run the link probes."""
        s = self.__dict__.get("_scorer")
        if s is None:
            with self.__dict__.setdefault("_scorer_lock", _threading.Lock()):
                s = self.__dict__.get("_scorer")
                if s is None:
                    from pio_tpu_torch.ops.topn import DeviceTopNScorer

                    rows, cols = self._scorer_factors()
                    mesh = self.__dict__.get("_serve_mesh")
                    s = DeviceTopNScorer(
                        rows, cols, warmup=warmup,
                        device=mesh[0] if mesh else rows.device, mesh=mesh,
                    )
                    if s.mesh_sharded:
                        self._release_device_tables(*s.host_tables())
                    self.__dict__["_scorer"] = s
        return s

    def __getstate__(self):
        # the scorer holds device tensors and a lock, the mesh devices:
        # never persisted
        d = dict(self.__dict__)
        d.pop("_scorer", None)
        d.pop("_scorer_lock", None)
        d.pop("_serve_mesh", None)
        return d


def dedup_pair_indices(a, b) -> np.ndarray:
    """Indices of the first occurrence of each ``(a[i], b[i])`` pair, in
    order. K-fold holdouts dedupe interactions first so a repeated pair
    split across folds can't leak the held-out interaction into the
    training fold."""
    seen = set()
    keep = []
    for idx, pair in enumerate(zip(a, b)):
        if pair not in seen:
            seen.add(pair)
            keep.append(idx)
    return np.asarray(keep, np.int64)


def fold_assignments(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Deterministic randomized fold labels ``[n] → {0..k-1}``: a seeded
    permutation, since ``arange(n) % k`` over a time-ordered event frame
    can put whole users in one fold."""
    rng = np.random.default_rng(seed)
    return rng.permutation(n) % k


def seen_exclusion_holdout(train_users, train_items, test_users,
                           test_items, make_query):
    """The hitrate holdout protocol: per held-out (user, item) pair, a
    query that black-lists the user's training-fold items (a recommender
    ranks what it memorized first). User-cold and item-cold pairs are
    skipped. ``make_query(user, black_list)`` returns the template's
    query; returns ``[(query, actual)]``."""
    seen: dict = {}
    for u, i in zip(train_users, train_items):
        seen.setdefault(str(u), []).append(str(i))
    known_items = {str(i) for i in train_items}
    return [
        (make_query(str(u), tuple(seen[str(u)])), str(i))
        for u, i in zip(test_users, test_items)
        if str(u) in seen and str(i) in known_items
    ]


def eval_app_name(app_name: str) -> str:
    """App for a bundled `pio eval` sweep: the explicit argument, or the
    ``$PIO_TPU_EVAL_APP`` environment fallback for zero-arg CLI use —
    one contract shared by every template's evaluation factory."""
    return app_name or knobs.knob_str("PIO_TPU_EVAL_APP")


def resolve_app(params) -> Tuple[int, Optional[int]]:
    """(app_id, channel_id) from datasource params.

    ``params`` needs ``app_name``/``app_id`` and optionally ``channel``
    attributes (every bundled DataSourceParams has them).
    """
    app_id = params.app_id
    if params.app_name:
        app = Storage.get_meta_data_apps().get_by_name(params.app_name)
        if app is None:
            raise ValueError(f"app {params.app_name!r} not found")
        app_id = app.id
    if not app_id:
        raise ValueError("datasource params need app_name or app_id")
    return app_id, resolve_channel(app_id, getattr(params, "channel", ""))


# ------------------------------------------------ shared item-scoring rules
def l2_normalize_rows(f: np.ndarray) -> np.ndarray:
    """Row-normalize factors for cosine scoring; zero rows stay zero."""
    norms = np.linalg.norm(f, axis=1, keepdims=True)
    return np.where(norms > 0, f / np.where(norms > 0, norms, 1), 0.0).astype(
        np.float32
    )


def business_rule_mask(
    n_items: int,
    item_index,
    categories_per_item: Sequence[FrozenSet[str]],
    categories: Tuple[str, ...] = (),
    white_list: Tuple[str, ...] = (),
    black_list: Tuple[str, ...] = (),
) -> np.ndarray:
    """Boolean keep-mask from the standard template filters
    (≙ the reference templates' categories/whiteList/blackList handling)."""
    mask = np.ones(n_items, bool)
    if categories:
        wanted = set(categories)
        mask &= np.fromiter(
            (bool(wanted & c) for c in categories_per_item),
            bool,
            len(categories_per_item),
        )
    if white_list:
        white = np.zeros(n_items, bool)
        for i in white_list:
            c = item_index.get(i)
            if c is not None:
                white[c] = True
        mask &= white
    for i in black_list:
        c = item_index.get(i)
        if c is not None:
            mask[c] = False
    return mask


def top_item_scores(
    scores: np.ndarray, mask: np.ndarray, num: int, item_index
) -> PredictedResult:
    """Masked top-N → PredictedResult (argpartition, not full sort)."""
    scores = np.where(mask, scores, -np.inf)
    n = min(num, int(mask.sum()))
    if n <= 0:
        return PredictedResult()
    idx = np.argpartition(-scores, n - 1)[:n]
    idx = idx[np.argsort(-scores[idx])]
    inv = item_index.inverse
    return PredictedResult(
        tuple(
            ItemScore(inv[int(i)], float(scores[i]))
            for i in idx
            if np.isfinite(scores[i])
        )
    )
