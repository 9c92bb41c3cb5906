"""Carry a trained model across from the reference package's field names.

The reference persists plain numpy arrays and Python values; this module
takes those values (never a reference object) and builds the port's model
on a device: the text-classification MLP and the recommendation ALS
model. The tests build the mapping from a model trained by the JAX
package; ``chip_smoke.py`` builds it from seeded random weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from pio_tpu_torch import DeviceLike
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.als import ALSFactors
from pio_tpu_torch.models.mlp import MLPModel
from pio_tpu_torch.models.tfidf import TfIdfVectorizer
from pio_tpu_torch.templates.recommendation import ALSModel
from pio_tpu_torch.templates.textclassification import TextMLPModel


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
    indexes = []
    for name, n in (("user_index", uf.shape[0]), ("item_index", itf.shape[0])):
        fwd = {str(k): int(v) for k, v in dict(arrays[name]).items()}
        if sorted(fwd.values()) != list(range(n)):
            raise ValueError(f"{name} codes must be 0..{n - 1}, one each")
        indexes.append(BiMap(fwd))
    return ALSModel.from_factors(
        ALSFactors(user_factors=uf, item_factors=itf), *indexes, device=device
    )
