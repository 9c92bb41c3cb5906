"""Canonical immutable Event + validation rules.

Rebuild of the reference's ``data/.../data/storage/Event.scala`` +
``EventValidation`` (UNVERIFIED path; see SURVEY.md provenance warning):
a time-stamped fact about an entity, optionally pointing at a target entity,
carrying a JSON property bag. Special events ``$set/$unset/$delete`` mutate
aggregated entity properties; names starting with ``$`` outside that set and
the ``pio_`` prefix on entity types / property keys are reserved.

The port's copy of ``pio_tpu/data/event.py`` (the port imports nothing of ``pio_tpu``).
"""

from __future__ import annotations

import datetime as _dt
import os
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional, Tuple

from pio_tpu_torch.data.datamap import DataMap

#: Special events understood by the property-aggregation fold.
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})

#: Entity types reserved for internal use (reference: builtinEntityTypes).
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})

RESERVED_PREFIX = "pio_"


class EventValidationError(ValueError):
    """Raised when an event violates the validation rules."""


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass(frozen=True)
class Event:
    """One immutable event.

    Field-for-field parity with the reference ``Event`` case class
    (eventId, event, entityType, entityId, targetEntityType, targetEntityId,
    properties, eventTime, tags, prId, creationTime).
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=_utcnow)
    tags: Tuple[str, ...] = ()
    pr_id: Optional[str] = None
    event_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=_utcnow)

    def __post_init__(self):
        # Normalize: naive datetimes are taken as UTC; times truncate to
        # millisecond precision (Joda-time parity — keeps in-memory values
        # identical to their wire/storage round-trip); properties may arrive
        # as a plain mapping.
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        for attr in ("event_time", "creation_time"):
            value = getattr(self, attr)
            if isinstance(value, _dt.datetime):
                if value.tzinfo is None:
                    value = value.replace(tzinfo=_dt.timezone.utc)
                value = value.replace(microsecond=value.microsecond // 1000 * 1000)
                object.__setattr__(self, attr, value)
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))

    # -- helpers ------------------------------------------------------------
    def with_event_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    @staticmethod
    def new_event_id() -> str:
        # 128 random bits as 32 hex chars — the uuid4 wrapper's version-
        # bit bookkeeping cost ~5 µs/event on the ingest hot path for an
        # id that is opaque everywhere in the system
        return os.urandom(16).hex()

    # -- JSON (API wire format; reference EventJson4sSupport) ---------------
    def to_api_dict(self) -> dict:
        d: dict = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.to_dict(),
            "eventTime": _format_time(self.event_time),
            "creationTime": _format_time(self.creation_time),
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        return d

    @classmethod
    def from_api_dict(cls, d: Mapping[str, Any]) -> "Event":
        """Parse the Event-Server wire format (camelCase keys)."""
        props = d.get("properties")
        if props is None:
            props = {}
        if not isinstance(props, Mapping):
            raise EventValidationError("'properties' must be a JSON object")
        tags = d.get("tags")
        if tags is None:
            tags = ()
        if not isinstance(tags, (list, tuple)) or not all(
            isinstance(t, str) for t in tags
        ):
            raise EventValidationError("'tags' must be a list of strings")
        now = _utcnow()
        ev = cls(
            event=_req_str(d, "event"),
            entity_type=_req_str(d, "entityType"),
            entity_id=_req_str(d, "entityId"),
            target_entity_type=_opt_str(d, "targetEntityType"),
            target_entity_id=_opt_str(d, "targetEntityId"),
            properties=DataMap(props),
            event_time=_parse_time(d.get("eventTime")) or now,
            tags=tuple(tags),
            pr_id=_opt_str(d, "prId"),
            event_id=_opt_str(d, "eventId"),
            creation_time=_parse_time(d.get("creationTime")) or now,
        )
        validate_event(ev)
        return ev


def _req_str(d: Mapping[str, Any], key: str) -> str:
    if key not in d:
        raise EventValidationError(f"field {key!r} is required")
    v = d[key]
    if not isinstance(v, str):
        raise EventValidationError(f"field {key!r} must be a string")
    return v


def _opt_str(d: Mapping[str, Any], key: str) -> Optional[str]:
    v = d.get(key)
    if v is None:
        return None
    if not isinstance(v, str):
        raise EventValidationError(f"field {key!r} must be a string")
    return v


def _parse_time(s: Optional[str]) -> Optional[_dt.datetime]:
    if s is None:
        return None
    if not isinstance(s, str):
        raise EventValidationError("time fields must be ISO-8601 strings")
    try:
        # Accept ISO-8601, incl. trailing 'Z'.
        t = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError as e:
        raise EventValidationError(f"cannot parse time {s!r}: {e}") from None
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t


def _format_time(t: _dt.datetime) -> str:
    return t.astimezone(_dt.timezone.utc).isoformat(timespec="milliseconds").replace(
        "+00:00", "Z"
    )


def validate_event(e: Event) -> None:
    """Validation rules mirroring the reference ``EventValidation.validate``.

    - event / entityType / entityId non-empty
    - targetEntityType and targetEntityId specified together, non-empty
    - ``$``-prefixed events restricted to :data:`SPECIAL_EVENTS`
    - special-event rules: no target entity; ``$unset`` needs non-empty
      properties; ``$delete`` must carry no properties
    - ``pio_`` prefix reserved on entity types / property keys (except
      builtin types)
    """
    if not e.event:
        raise EventValidationError("event must not be empty")
    if not e.entity_type:
        raise EventValidationError("entityType must not be empty")
    if not e.entity_id:
        raise EventValidationError("entityId must not be empty")
    if e.target_entity_type is not None and not e.target_entity_type:
        raise EventValidationError("targetEntityType must not be empty string")
    if e.target_entity_id is not None and not e.target_entity_id:
        raise EventValidationError("targetEntityId must not be empty string")
    if (e.target_entity_type is None) != (e.target_entity_id is None):
        raise EventValidationError(
            "targetEntityType and targetEntityId must be specified together"
        )
    if e.entity_type.startswith(RESERVED_PREFIX) and e.entity_type not in BUILTIN_ENTITY_TYPES:
        raise EventValidationError(
            f"entityType prefix {RESERVED_PREFIX!r} is reserved"
        )
    if e.target_entity_type is not None and e.target_entity_type.startswith(
        RESERVED_PREFIX
    ) and e.target_entity_type not in BUILTIN_ENTITY_TYPES:
        raise EventValidationError(
            f"targetEntityType prefix {RESERVED_PREFIX!r} is reserved"
        )
    for key in e.properties.keys():
        if key.startswith(RESERVED_PREFIX) or key.startswith("$"):
            raise EventValidationError(
                f"property key {key!r} uses a reserved prefix"
            )
    if e.event.startswith("$"):
        if e.event not in SPECIAL_EVENTS:
            raise EventValidationError(
                f"event name {e.event!r}: '$'-prefixed names are reserved "
                f"(allowed: {sorted(SPECIAL_EVENTS)})"
            )
        _validate_special(e)


def _validate_special(e: Event) -> None:
    if e.target_entity_type is not None or e.target_entity_id is not None:
        raise EventValidationError(
            f"special event {e.event} must not have targetEntity"
        )
    if e.event == "$unset" and e.properties.is_empty:
        raise EventValidationError("$unset event must have non-empty properties")
    if e.event == "$delete" and not e.properties.is_empty:
        raise EventValidationError("$delete event must not have properties")
