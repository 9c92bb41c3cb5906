"""BiMap — immutable bidirectional map (a copy of ``pio_tpu/data/bimap.py``).

Indexes string labels into dense integer codes and back. Indices are
assigned over **sorted** keys (:meth:`BiMap.string_int`) or by descending
frequency with lexicographic ties (:meth:`BiMap.string_int_by_frequency`),
so index maps are deterministic.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Generic, Hashable, Iterable, Iterator, Mapping, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    """Immutable one-to-one mapping with O(1) lookups both ways."""

    __slots__ = ("_fwd", "_rev")

    def __init__(self, mapping: Mapping[K, V], _rev: Optional[Dict[V, K]] = None):
        self._fwd: Dict[K, V] = dict(mapping)
        if _rev is None:
            _rev = {v: k for k, v in self._fwd.items()}
            if len(_rev) != len(self._fwd):
                raise ValueError("BiMap values must be unique")
        self._rev: Dict[V, K] = _rev

    def __getitem__(self, key: K) -> V:
        return self._fwd[key]

    def get(self, key: K, default: Optional[V] = None) -> Optional[V]:
        return self._fwd.get(key, default)

    def __contains__(self, key: object) -> bool:
        return key in self._fwd

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def keys(self):
        return self._fwd.keys()

    def values(self):
        return self._fwd.values()

    def items(self):
        return self._fwd.items()

    @property
    def inverse(self) -> "BiMap[V, K]":
        """Flipped view — O(1): BiMap is immutable, so the view shares
        both dicts instead of copying them."""
        inv = BiMap.__new__(BiMap)
        inv._fwd = self._rev
        inv._rev = self._fwd
        return inv

    def to_dict(self) -> Dict[K, V]:
        return dict(self._fwd)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BiMap):
            return self._fwd == other._fwd
        return NotImplemented

    def __repr__(self) -> str:
        return f"BiMap({self._fwd!r})"

    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Index distinct keys 0..n-1, over the sorted keys."""
        distinct = sorted(set(keys))
        return BiMap({k: i for i, k in enumerate(distinct)})

    @staticmethod
    def string_int_by_frequency(keys: Iterable[str]) -> "BiMap[str, int]":
        """Index distinct keys 0..n-1 by DESCENDING occurrence count, ties
        ordered lexicographically (so the assignment stays deterministic).

        Popular entities get low codes: the hot rows of a factor table
        cluster together, and the ALS delta item wire gets smaller gaps.
        Interchangeable with :meth:`string_int` but for the assignment.
        """
        counts = Counter(keys)
        ordered = sorted(counts, key=lambda k: (-counts[k], k))
        return BiMap({k: i for i, k in enumerate(ordered)})
