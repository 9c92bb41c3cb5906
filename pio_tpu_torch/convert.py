"""Carry a trained model across from the reference package's field names.

The reference persists plain numpy arrays and Python values; this module
takes those values (never a reference object) and builds the port's model
on a device: the text-classification MLP, the recommendation ALS model
and the two-tower and sequence models (their trained engine models, and
the reference's initial parameter trees, so that both packages train
from one init); and the similar-product, e-commerce and classification
models, which hold host numpy arrays (the classification models'
resident scorer is placed by the query server).
The tests build the mapping from a model trained by the JAX
package; ``chip_smoke.py`` builds it from seeded random weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.als import ALSFactors
from pio_tpu_torch.models.logreg import LogRegModel
from pio_tpu_torch.models.mlp import MLPModel
from pio_tpu_torch.models.naive_bayes import MultinomialNBModel
from pio_tpu_torch.models.seqrec import SeqRecConfig, SeqRecModel
from pio_tpu_torch.models.tfidf import TfIdfVectorizer
from pio_tpu_torch.models.two_tower import TwoTowerConfig, TwoTowerModel
from pio_tpu_torch.templates.classification import (
    LogRegClassifierModel,
    NBClassifierModel,
)
from pio_tpu_torch.templates.ecommerce import ECommModel
from pio_tpu_torch.templates.recommendation import ALSModel
from pio_tpu_torch.templates.sequence import SeqRecEngineModel
from pio_tpu_torch.templates.similarproduct import SimilarProductModel
from pio_tpu_torch.templates.textclassification import TextMLPModel
from pio_tpu_torch.templates.twotower import TwoTowerEngineModel


def text_mlp_from_reference(
    arrays: Mapping[str, Any], device: DeviceLike = None
) -> TextMLPModel:
    """Build a :class:`TextMLPModel` on ``device`` from plain values.

    ``arrays`` holds the reference ``TextMLPModel``'s fields by name:
    ``w_in [V, H]``, ``b_in [H]``, ``w_out [H, C]``, ``b_out [C]`` (the
    ``mlp``'s arrays), ``vocab`` (token → id dict) and ``idf [V]`` (the
    vectorizer's), ``labels`` (label strings in code order, i.e.
    ``label_index.inverse``), ``bag_width`` and ``token_cap``.
    """
    idf = np.asarray(arrays["idf"], np.float32)
    labels = [str(label) for label in arrays["labels"]]
    mlp = MLPModel(
        arrays["w_in"], arrays["b_in"], arrays["w_out"], arrays["b_out"],
        device=device,
    )
    if mlp.n_features != len(idf):
        raise ValueError(
            f"w_in has {mlp.n_features} rows but idf has {len(idf)} entries"
        )
    if mlp.n_classes != len(labels):
        raise ValueError(
            f"w_out has {mlp.n_classes} columns but {len(labels)} labels"
        )
    vocab = {str(tok): int(i) for tok, i in dict(arrays["vocab"]).items()}
    if vocab and (min(vocab.values()) < 1 or max(vocab.values()) >= len(idf)):
        raise ValueError("vocab ids must lie in [1, V)")
    return TextMLPModel(
        mlp=mlp,
        vectorizer=TfIdfVectorizer(vocab=vocab, idf=idf),
        label_index=BiMap({label: code for code, label in enumerate(labels)}),
        bag_width=int(arrays["bag_width"]),
        token_cap=int(arrays["token_cap"]),
    )


def als_model_from_reference(
    arrays: Mapping[str, Any], device: DeviceLike = None
) -> ALSModel:
    """Build an :class:`ALSModel` on ``device`` from plain values.

    ``arrays`` holds the reference ``ALSModel``'s fields by name:
    ``user_factors [U, K]`` and ``item_factors [I, K]`` (its
    ``ALSFactors``), and ``user_index`` and ``item_index``, each a mapping
    of string id → code (``BiMap.to_dict()``) whose codes are the factor
    rows ``0..U-1`` and ``0..I-1``.
    """
    uf = np.asarray(arrays["user_factors"], np.float32)
    itf = np.asarray(arrays["item_factors"], np.float32)
    if uf.ndim != 2 or itf.ndim != 2 or uf.shape[1] != itf.shape[1]:
        raise ValueError(
            f"factor shapes {uf.shape} and {itf.shape} are not [n, rank]"
        )
    return ALSModel.from_factors(
        ALSFactors(user_factors=uf, item_factors=itf),
        _index(arrays, "user_index", uf.shape[0]),
        _index(arrays, "item_index", itf.shape[0]),
        device=device,
    )


def _index(arrays: Mapping[str, Any], name: str, n: int) -> BiMap:
    """The BiMap of ``arrays[name]`` (string id → code), whose codes must be
    the rows ``0..n-1``, one each."""
    fwd = {str(k): int(v) for k, v in dict(arrays[name]).items()}
    if sorted(fwd.values()) != list(range(n)):
        raise ValueError(f"{name} codes must be 0..{n - 1}, one each")
    return BiMap(fwd)


def _factors(arrays: Mapping[str, Any], name: str) -> np.ndarray:
    f = np.asarray(arrays[name], np.float32)
    if f.ndim != 2:
        raise ValueError(f"{name} has shape {f.shape}, not [n, rank]")
    return f


def _categories(arrays: Mapping[str, Any], n: int):
    cats = [frozenset(str(c) for c in cs) for cs in arrays["categories"]]
    if len(cats) != n:
        raise ValueError(f"{len(cats)} category sets for {n} items")
    return cats


def similarproduct_model_from_reference(
    arrays: Mapping[str, Any]
) -> SimilarProductModel:
    """Build a :class:`SimilarProductModel` (host numpy) from plain values.

    ``arrays`` holds the reference ``SimilarProductModel``'s fields by
    name: ``norm_factors [I, K]`` (L2-normalized item factors),
    ``item_index`` (string id → code, ``BiMap.to_dict()``, codes the rows
    ``0..I-1``) and ``categories`` (one iterable of strings an item, in
    code order).
    """
    nf = _factors(arrays, "norm_factors")
    return SimilarProductModel(
        norm_factors=nf,
        item_index=_index(arrays, "item_index", nf.shape[0]),
        categories=_categories(arrays, nf.shape[0]),
    )


def ecomm_model_from_reference(arrays: Mapping[str, Any]) -> ECommModel:
    """Build an :class:`ECommModel` (host numpy) from plain values.

    ``arrays`` holds the reference ``ECommModel``'s fields by name:
    ``user_factors [U, K]``, ``item_factors [I, K]`` and
    ``norm_item_factors [I, K]``, ``user_index`` and ``item_index``
    (string id → code, codes the factor rows), ``categories`` (one
    iterable of strings an item, in code order) and ``app_id`` (the app
    whose live events the model reads at query time).
    """
    uf = _factors(arrays, "user_factors")
    itf = _factors(arrays, "item_factors")
    nf = _factors(arrays, "norm_item_factors")
    if not (uf.shape[1] == itf.shape[1] == nf.shape[1]
            and itf.shape == nf.shape):
        raise ValueError(f"factor shapes {uf.shape}, {itf.shape} and "
                         f"{nf.shape} do not agree")
    return ECommModel(
        user_factors=uf,
        norm_item_factors=nf,
        item_factors=itf,
        user_index=_index(arrays, "user_index", uf.shape[0]),
        item_index=_index(arrays, "item_index", itf.shape[0]),
        categories=_categories(arrays, itf.shape[0]),
        app_id=int(arrays["app_id"]),
    )


def _labels_and_scales(arrays: Mapping[str, Any], n_classes: int, dim: int):
    """The label BiMap (``labels``: label strings in code order) and the
    optional ``feature_scales [D]`` of a classifier's arrays, checked."""
    labels = [str(label) for label in arrays["labels"]]
    if len(labels) != n_classes or len(set(labels)) != n_classes:
        raise ValueError(f"{len(labels)} labels for {n_classes} classes, "
                         f"one each")
    scales = arrays.get("feature_scales")
    if scales is not None:
        scales = np.asarray(scales, np.float32)
        if scales.shape != (dim,):
            raise ValueError(f"feature_scales {scales.shape}, not [{dim}]")
    index = BiMap({label: code for code, label in enumerate(labels)})
    return index, scales


def logreg_model_from_reference(
    arrays: Mapping[str, Any]
) -> LogRegClassifierModel:
    """Build a :class:`LogRegClassifierModel` (host numpy) from plain values.

    ``arrays`` holds the reference ``LogRegClassifierModel``'s fields by
    name: ``weights [D, C]``, ``bias [C]`` and ``feature_scales [D]`` (or
    None; its ``lr``), and ``labels`` (label strings in code order, i.e.
    ``label_index.inverse``).
    """
    w = np.asarray(arrays["weights"], np.float32)
    b = np.asarray(arrays["bias"], np.float32)
    if w.ndim != 2 or b.shape != (w.shape[1],):
        raise ValueError(f"weights {w.shape} and bias {b.shape} are not "
                         f"[D, C] and [C]")
    index, scales = _labels_and_scales(arrays, w.shape[1], w.shape[0])
    return LogRegClassifierModel(
        LogRegModel(weights=w, bias=b, n_classes=w.shape[1],
                    feature_scales=scales),
        index, w.shape[0])


def nb_classifier_from_reference(
    arrays: Mapping[str, Any]
) -> NBClassifierModel:
    """Build an :class:`NBClassifierModel` (host numpy) from plain values.

    ``arrays`` holds the reference ``NBClassifierModel``'s fields by name:
    ``log_prior [C]``, ``log_theta [C, D]`` and ``feature_scales [D]`` (or
    None; its ``nb``), and ``labels`` (label strings in code order).
    """
    lp = np.asarray(arrays["log_prior"], np.float32)
    lt = np.asarray(arrays["log_theta"], np.float32)
    if lt.ndim != 2 or lp.shape != (lt.shape[0],):
        raise ValueError(f"log_theta {lt.shape} and log_prior {lp.shape} "
                         f"are not [C, D] and [C]")
    index, scales = _labels_and_scales(arrays, lt.shape[0], lt.shape[1])
    return NBClassifierModel(
        MultinomialNBModel(log_prior=lp, log_theta=lt, feature_scales=scales),
        index, lt.shape[1])


_TOWER_KEYS = ("emb", "w1", "b1", "w2", "b2")
_SEQREC_BLOCK_KEYS = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo",
                      "ln2_g", "ln2_b", "w1", "b1", "w2", "b2")


def _tensor_tree(tree: Mapping[str, Any], keys, device: torch.device,
                 where: str) -> dict:
    """``tree``'s arrays, by ``keys`` (a key maps to a nested tuple of
    keys for a sub-tree), as float32 tensors on ``device``."""
    if set(tree) != {k if isinstance(k, str) else k[0] for k in keys}:
        raise ValueError(f"{where}: keys {sorted(tree)} are not the model's")
    out = {}
    for k in keys:
        if isinstance(k, str):
            out[k] = torch.from_numpy(
                np.array(tree[k], np.float32)).to(device)
        else:
            out[k[0]] = _tensor_tree(tree[k[0]], k[1], device,
                                     f"{where}/{k[0]}")
    return out


def twotower_params_from_reference(
    tree: Mapping[str, Any], device: DeviceLike = None
) -> dict:
    """The reference's two-tower parameter tree (``{"user": tower, "item":
    tower}``, each tower ``emb [V, E]``, ``w1 [E, H]``, ``b1 [H]``,
    ``w2 [H, O]``, ``b2 [O]``, as host arrays) as the port's, on
    ``device``: what ``two_tower.init_params`` returns."""
    dev = resolve_device(device)
    return _tensor_tree(
        tree, (("user", _TOWER_KEYS), ("item", _TOWER_KEYS)), dev,
        "two-tower params")


def seqrec_params_from_reference(
    tree: Mapping[str, Any], device: DeviceLike = None
) -> dict:
    """The reference's layer-stacked sequence-model tree (``emb``,
    ``pos``, ``blocks`` with a leading layer dim, ``lnf_g``, ``lnf_b``)
    as the port's, on ``device``: what ``seqrec.init_params`` returns."""
    dev = resolve_device(device)
    return _tensor_tree(
        tree, ("emb", "pos", ("blocks", _SEQREC_BLOCK_KEYS), "lnf_g",
               "lnf_b"), dev, "seqrec params")


def twotower_model_from_reference(
    arrays: Mapping[str, Any], device: DeviceLike = None
) -> TwoTowerEngineModel:
    """Build a :class:`TwoTowerEngineModel` on ``device`` from plain values.

    ``arrays`` holds the reference ``TwoTowerEngineModel``'s fields by
    name: ``user_vectors [U, D]`` and ``item_vectors [I, D]`` (its
    ``TwoTowerModel``), ``config`` (the ``TwoTowerConfig``'s fields as a
    mapping), and ``user_index`` and ``item_index`` (string id → code,
    codes the rows).
    """
    dev = resolve_device(device)
    uv = _factors(arrays, "user_vectors")
    iv = _factors(arrays, "item_vectors")
    if uv.shape[1] != iv.shape[1]:
        raise ValueError(f"vector widths differ: {uv.shape} and {iv.shape}")
    model = TwoTowerModel(
        user_vectors=torch.from_numpy(uv.copy()).to(dev),
        item_vectors=torch.from_numpy(iv.copy()).to(dev),
        config=TwoTowerConfig(**dict(arrays.get("config", {}))),
    )
    return TwoTowerEngineModel(
        model, _index(arrays, "user_index", uv.shape[0]),
        _index(arrays, "item_index", iv.shape[0]),
    )


def seqrec_model_from_reference(
    arrays: Mapping[str, Any], device: DeviceLike = None
) -> SeqRecEngineModel:
    """Build a :class:`SeqRecEngineModel` on ``device`` from plain values.

    ``arrays`` holds the reference ``SeqRecEngineModel``'s fields by name:
    ``params`` (the trained tree, ``emb`` of ``n_items + 1`` rows, row 0
    the pad), ``n_items`` and ``config`` (the ``SeqRecConfig``'s fields as
    a mapping) of its ``SeqRecModel``; ``item_index`` (string id → code,
    codes ``0..n_items-1``; the model's rows are the codes plus one) and
    ``user_histories`` (user id → list of item codes plus one).
    """
    params = seqrec_params_from_reference(arrays["params"], device)
    n_items = int(arrays["n_items"])
    if params["emb"].shape[0] != n_items + 1:
        raise ValueError(
            f"emb has {params['emb'].shape[0]} rows for {n_items} items "
            f"and the pad row"
        )
    histories = {str(u): [int(c) for c in h]
                 for u, h in dict(arrays["user_histories"]).items()}
    if any(c < 1 or c > n_items for h in histories.values() for c in h):
        raise ValueError(f"history codes must lie in [1, {n_items}]")
    return SeqRecEngineModel(
        SeqRecModel(params=params, n_items=n_items,
                    config=SeqRecConfig(**dict(arrays["config"]))),
        _index(arrays, "item_index", n_items), histories,
    )
