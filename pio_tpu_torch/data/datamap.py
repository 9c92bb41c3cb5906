"""DataMap / PropertyMap — typed JSON property bags.

Rebuild of the reference's ``data/.../data/storage/DataMap.scala`` and
``PropertyMap.scala`` (UNVERIFIED paths; see SURVEY.md). A ``DataMap`` wraps a
JSON object; ``get`` raises on a missing key, ``get_opt`` returns ``None``.
``PropertyMap`` adds the aggregation timestamps ``first_updated`` /
``last_updated`` produced by folding ``$set/$unset/$delete`` event streams.

The port's copy of ``pio_tpu/data/datamap.py`` (the port imports nothing of ``pio_tpu``).
"""

from __future__ import annotations

import copy as _copy
import datetime as _dt
import json
from typing import Any, Iterable, Iterator, Mapping, Optional, Type, TypeVar

T = TypeVar("T")

# JSON scalar/compound types a DataMap value may hold.
JsonValue = Any


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


def _json_copy(v: JsonValue) -> JsonValue:
    """Deep copy specialized to JSON trees (dict/list/tuple containers,
    immutable leaves shared). ~10× faster than ``copy.deepcopy`` — which
    was a measurable slice of per-event ingest cost — while keeping the
    same isolation guarantee for JSON-shaped input; anything exotic
    falls back to deepcopy."""
    t = type(v)
    if t is dict:
        return {k: _json_copy(x) for k, x in v.items()}
    if t is list:
        return [_json_copy(x) for x in v]
    if t is tuple:
        return tuple(_json_copy(x) for x in v)
    if t in (str, int, float, bool) or v is None:
        return v
    return _copy.deepcopy(v)


def _check_type(name: str, value: JsonValue, expected: Optional[Type]) -> JsonValue:
    if expected is None:
        return value
    if expected is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)  # JSON ints coerce up to float on request
    if expected is int and isinstance(value, bool):
        raise DataMapError(f"field {name!r} is a bool, expected {expected.__name__}")
    if not isinstance(value, expected):
        raise DataMapError(
            f"field {name!r} has type {type(value).__name__}, "
            f"expected {expected.__name__}"
        )
    return value


class DataMap:
    """Immutable typed view over a JSON object.

    Mirrors the reference API surface: ``get[T]`` -> :meth:`get`,
    ``getOpt[T]`` -> :meth:`get_opt`, ``getOrElse`` -> :meth:`get_or_else`,
    ``++`` -> :meth:`union`, ``--`` -> :meth:`minus`, ``keySet`` ->
    :meth:`keys`.

    Deliberately NOT a ``collections.abc.Mapping``: :meth:`get` follows the
    reference's required-typed-get contract (missing key raises; second arg
    is a type), which conflicts with ``Mapping.get``'s default-value
    contract — registering as a Mapping would invite generic dict code to
    misuse it.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, JsonValue]] = None):
        # Deep-copy once at construction so outside mutation of the source
        # dict can't reach us. Decode hot paths that own their freshly
        # parsed dict should use :meth:`_wrap` instead.
        # no throwaway dict(fields) before the deep copy: _json_copy
        # already copies the top level when fields is a plain dict
        self._fields: dict = (
            _json_copy(fields if type(fields) is dict else dict(fields))
            if fields else {}
        )

    @classmethod
    def _wrap(cls, owned: dict) -> "DataMap":
        """No-copy constructor for callers handing over ownership of a
        never-aliased dict (e.g. a fresh ``json.loads`` result on storage
        decode paths)."""
        self = cls.__new__(cls)
        self._fields = owned
        return self

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> JsonValue:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def keys(self):
        return self._fields.keys()

    def values(self):
        return self._fields.values()

    def items(self):
        return self._fields.items()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            # A plain DataMap never equals a PropertyMap (whose identity
            # includes timestamps) — keeps == transitive.
            return False
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- typed accessors ----------------------------------------------------
    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name!r} is required.")

    def get(self, name: str, typ: Optional[Type[T]] = None) -> T:  # type: ignore[override]
        """Mandatory typed get — raises :class:`DataMapError` if absent/null.

        Container values come back as copies so callers can't mutate the
        (immutable) map through them.
        """
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise DataMapError(f"The required field {name!r} cannot be null.")
        value = _check_type(name, value, typ)
        # Containers come back as copies so callers can't mutate the map
        # (hash stability); scalar gets — the common case — stay copy-free.
        return _json_copy(value) if isinstance(value, (list, dict)) else value

    def get_opt(self, name: str, typ: Optional[Type[T]] = None) -> Optional[T]:
        value = self._fields.get(name)
        if value is None:
            return None
        value = _check_type(name, value, typ)
        return _json_copy(value) if isinstance(value, (list, dict)) else value

    def get_or_else(self, name: str, default: T, typ: Optional[Type[T]] = None) -> T:
        value = self.get_opt(name, typ)
        return default if value is None else value

    def get_double(self, name: str) -> float:
        return self.get(name, float)

    def get_string(self, name: str) -> str:
        return self.get(name, str)

    def get_string_list(self, name: str) -> list:
        value = self.get(name, list)
        if not all(isinstance(v, str) for v in value):
            raise DataMapError(f"field {name!r} is not a list of strings")
        return value

    # -- set algebra (reference ``++`` / ``--``) ----------------------------
    def union(self, other: "DataMap | Mapping[str, JsonValue]") -> "DataMap":
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def minus(self, keys: Iterable[str]) -> "DataMap":
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    # -- JSON ---------------------------------------------------------------
    def to_dict(self) -> dict:
        """Shallow copy — hot paths (EventFrame) read it without per-row
        deep copies; callers must not mutate nested containers."""
        return dict(self._fields)

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        obj = json.loads(s)
        if not isinstance(obj, dict):
            raise DataMapError("DataMap JSON must be an object")
        return cls(obj)

    @property
    def is_empty(self) -> bool:
        return not self._fields


class PropertyMap(DataMap):
    """A DataMap plus aggregation timestamps.

    Produced by folding an entity's ``$set/$unset/$delete`` event stream
    (reference ``PropertyMap.scala`` + ``LEventAggregator.scala``):
    ``first_updated`` is the event time of the first event since the last
    ``$delete``; ``last_updated`` the latest event time folded in.
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, JsonValue]],
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self._fields == other._fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        # Never equal to a plain DataMap/dict: delegating to field-only
        # equality would make == non-transitive across PropertyMaps with
        # different timestamps. Must be False, not NotImplemented — the
        # reflected DataMap.__eq__ would otherwise field-compare.
        return False

    __hash__ = DataMap.__hash__
