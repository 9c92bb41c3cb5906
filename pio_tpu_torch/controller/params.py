"""Typed component params — the engine.json / query binding layer.

A copy of ``pio_tpu/controller/params.py``'s binding: JSON objects bind to
frozen dataclasses with explicit validation. Unknown keys are rejected,
missing keys fall back to dataclass defaults, a missing required key is an
error naming the field, and camelCase wire keys bind to snake_case fields.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import typing
from typing import Any, Mapping, Optional, Type, TypeVar

#: camelCase → snake_case boundary (see params_from_dict wire parity)
_SNAKE_RE = re.compile(r"(?<=[a-z0-9])([A-Z])")


@functools.lru_cache(maxsize=None)
def _hints_of(cls: type) -> Mapping[str, Any]:
    """Per-class cache of ``get_type_hints`` — query binding runs once per
    serving request."""
    return typing.get_type_hints(cls)


P = TypeVar("P", bound="Params")


class ParamsError(ValueError):
    """Raised when engine.json params or a query don't bind to a Params
    dataclass."""


@dataclasses.dataclass(frozen=True)
class Params:
    """Base class for component parameters; subclass as a frozen dataclass."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """No parameters."""


def _check_field_type(name: str, value: Any, ftype: Any) -> Any:
    """Best-effort runtime check/coercion for common JSON-able field types."""
    origin = typing.get_origin(ftype)
    if origin is tuple and isinstance(value, list):
        # a JSON array binds to a tuple field (a query's black_list)
        return tuple(value)
    if ftype is Any or origin is not None and origin is not list:
        return value  # Optional/Union/Dict etc. — accept as-is
    if ftype is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    if isinstance(ftype, type):
        if ftype is int and isinstance(value, bool):
            raise ParamsError(f"param {name!r}: got bool, expected int")
        if origin is None and not isinstance(value, ftype):
            raise ParamsError(
                f"param {name!r}: got {type(value).__name__}, "
                f"expected {ftype.__name__}"
            )
    return value


def params_from_dict(cls: Type[P], d: Optional[Mapping[str, Any]]) -> P:
    """Bind a JSON object to a Params dataclass (strict about unknown keys)."""
    if d is not None and not isinstance(d, Mapping):
        raise ParamsError(
            f"{cls.__name__}: params must be a JSON object, "
            f"got {type(d).__name__}"
        )
    d = dict(d or {})
    if not dataclasses.is_dataclass(cls):
        raise ParamsError(f"{cls.__name__} must be a dataclass")
    hints = _hints_of(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    # wire parity: queries and engine.json use camelCase keys; fields here
    # are snake_case. Accept both; a key that matches a field exactly wins.
    for key in list(d):
        if key in fields:
            continue
        snake = _SNAKE_RE.sub(r"_\1", key).lower()
        if snake not in fields and snake + "_" in fields:
            # Python-keyword collisions: "lambda" binds to a lambda_ field
            snake = snake + "_"
        if snake in fields:
            if snake in d:
                raise ParamsError(
                    f"{cls.__name__}: both {key!r} and {snake!r} given"
                )
            d[snake] = d.pop(key)
    unknown = set(d) - set(fields)
    if unknown:
        raise ParamsError(
            f"{cls.__name__}: unknown params {sorted(unknown)}; "
            f"known: {sorted(fields)}"
        )
    kwargs = {}
    for name, f in fields.items():
        if name in d:
            kwargs[name] = _check_field_type(name, d[name], hints.get(name))
        elif (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING  # type: ignore[misc]
        ):
            raise ParamsError(f"{cls.__name__}: missing required param {name!r}")
    try:
        return cls(**kwargs)  # type: ignore[return-value]
    except (TypeError, ValueError) as e:
        raise ParamsError(f"{cls.__name__}: {e}") from None


def params_to_dict(p: Params) -> dict:
    return dataclasses.asdict(p)


def params_to_json(p: Params) -> str:
    return json.dumps(params_to_dict(p), sort_keys=True)
