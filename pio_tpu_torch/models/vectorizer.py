"""Binary one-hot vectorizer — the port's copy of
``pio_tpu/models/vectorizer.py``, a rebuild of the reference e2 helper.

Reference: ``e2/src/main/scala/o/a/p/e2/engine/BinaryVectorizer.scala``
(UNVERIFIED path; see SURVEY.md §2.5) — learns a ``(field, value) → index``
map from property maps restricted to selected fields, then turns a property
map into a binary feature vector.

The learned index is a plain dict and the encoding is host numpy, as in
the reference: a batch of property maps becomes a dense ``[B, D]`` float32
matrix, which a model moves to its device with ``torch.from_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple


@dataclasses.dataclass
class BinaryVectorizer:
    """(field, value) → dense one-hot index."""

    index: Dict[Tuple[str, str], int]
    fields: Tuple[str, ...]

    @property
    def dim(self) -> int:
        return len(self.index)

    @classmethod
    def fit(
        cls,
        maps: Sequence[Mapping[str, str]],
        fields: Sequence[str],
    ) -> "BinaryVectorizer":
        """Learn the index from observed (field, value) pairs.

        ≙ reference ``BinaryVectorizer.apply(RDD[HashMap], properties)``.
        Insertion order is deterministic (first-seen), so vectors are stable
        across runs for identical input order.
        """
        fset = tuple(fields)
        index: Dict[Tuple[str, str], int] = {}
        for m in maps:
            for f in fset:
                if f in m:
                    key = (f, str(m[f]))
                    if key not in index:
                        index[key] = len(index)
        return cls(index=index, fields=fset)

    def to_vector(self, m: Mapping[str, str]) -> List[float]:
        """One property map → binary vector (list of 0.0/1.0)."""
        vec = [0.0] * len(self.index)
        for f in self.fields:
            if f in m:
                i = self.index.get((f, str(m[f])))
                if i is not None:
                    vec[i] = 1.0
        return vec

    def to_matrix(self, maps: Sequence[Mapping[str, str]]):
        """Batch encode → np.float32 [B, D]."""
        import numpy as np

        out = np.zeros((len(maps), len(self.index)), np.float32)
        for b, m in enumerate(maps):
            for f in self.fields:
                if f in m:
                    i = self.index.get((f, str(m[f])))
                    if i is not None:
                        out[b, i] = 1.0
        return out
