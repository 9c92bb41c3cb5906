"""Event-store compaction — the port's copy of ``pio_tpu/data/cleaning.py``.

It rebuilds the reference SelfCleaningDataSource.

Reference: ``core/src/main/scala/o/a/p/core/SelfCleaningDataSource.scala``
(UNVERIFIED path; SURVEY.md §2.1): a DataSource mix-in configured with an
``EventWindow(duration, removeDuplicates, compressProperties)`` that rewrites
the persisted event stream:

- ``duration`` — drop plain events whose ``event_time`` is older than
  ``now - duration``;
- ``compress_properties`` — fold each entity's ``$set/$unset/$delete`` chain
  into a single ``$set`` carrying the entity's final PropertyMap (entities
  whose final state is deleted disappear entirely);
- ``remove_duplicates`` — collapse events identical in everything but
  ``event_id``/``creation_time``.

The compaction itself reuses :mod:`pio_tpu_torch.data.aggregation`'s fold (the
same semantics serving uses), so a compacted store aggregates identically to
the original — asserted by the test suite.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re
from typing import List, Optional, Sequence, Tuple

from pio_tpu_torch.data.aggregation import aggregate_properties
from pio_tpu_torch.data.event import SPECIAL_EVENTS, Event

_DURATION_RE = re.compile(
    r"^\s*(\d+)\s*(seconds?|minutes?|hours?|days?|weeks?|s|m|h|d|w)\s*$",
    re.IGNORECASE,
)

_UNIT_SECONDS = {
    "s": 1, "second": 1, "seconds": 1,
    "m": 60, "minute": 60, "minutes": 60,
    "h": 3600, "hour": 3600, "hours": 3600,
    "d": 86400, "day": 86400, "days": 86400,
    "w": 604800, "week": 604800, "weeks": 604800,
}


def parse_duration(text: str) -> _dt.timedelta:
    """``"30 days"`` / ``"12h"`` / ``"90 minutes"`` → timedelta."""
    m = _DURATION_RE.match(text)
    if not m:
        raise ValueError(f"unparseable duration: {text!r}")
    value, unit = int(m.group(1)), m.group(2).lower()
    return _dt.timedelta(seconds=value * _UNIT_SECONDS[unit])


@dataclasses.dataclass(frozen=True)
class EventWindow:
    """≙ reference ``EventWindow`` case class."""

    duration: Optional[str] = None
    remove_duplicates: bool = False
    compress_properties: bool = False


def _dedup_key(e: Event) -> Tuple:
    import json

    return (
        e.event,
        e.entity_type,
        e.entity_id,
        e.target_entity_type,
        e.target_entity_id,
        # canonical JSON so list/dict property values stay hashable
        json.dumps(e.properties.to_dict(), sort_keys=True, default=str),
        e.event_time,
    )


def clean_events(
    events: Sequence[Event],
    window: EventWindow,
    now: Optional[_dt.datetime] = None,
) -> List[Event]:
    """Pure compaction: the cleaned event list for one (app, channel).

    Ordering of the result follows event time (stable for ties).
    """
    now = now or _dt.datetime.now(_dt.timezone.utc)
    ordered = sorted(events, key=lambda e: e.event_time)

    special = [e for e in ordered if e.event in SPECIAL_EVENTS]
    plain = [e for e in ordered if e.event not in SPECIAL_EVENTS]

    if window.duration is not None:
        cutoff = now - parse_duration(window.duration)
        plain = [e for e in plain if e.event_time >= cutoff]

    if window.compress_properties:
        folded = aggregate_properties(special)
        compressed = [
            Event(
                "$set",
                etype,
                eid,
                properties=pm.to_dict(),
                event_time=pm.last_updated,
            )
            for (etype, eid), pm in folded.items()
        ]
        special = sorted(compressed, key=lambda e: e.event_time)

    merged = sorted(special + plain, key=lambda e: e.event_time)

    if window.remove_duplicates:
        seen = set()
        deduped = []
        for e in merged:
            k = _dedup_key(e)
            if k not in seen:
                seen.add(k)
                deduped.append(e)
        merged = deduped

    return merged


class SelfCleaningDataSource:
    """DataSource mix-in: compact the persisted store in place.

    Subclasses (or callers) provide ``event_window`` — cleaning is a no-op
    without one — and call :meth:`clean_persisted_events` with the app id,
    typically right before ``read_training`` (the reference calls it from
    user DataSources the same way).
    """

    event_window: Optional[EventWindow] = None

    def clean_persisted_events(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        now: Optional[_dt.datetime] = None,
    ) -> int:
        """Rewrite the store; returns the number of events removed."""
        if self.event_window is None:
            return 0
        from pio_tpu_torch.storage.registry import Storage

        pe = Storage.get_pevents()
        before = pe.find(app_id, channel_id=channel_id)
        after = clean_events(before, self.event_window, now=now)

        # write-then-delete: a crash between the two calls leaves duplicates
        # (removable by a re-run), never a wiped store
        old_ids = [e.event_id for e in before if e.event_id]
        pe.write(
            [dataclasses.replace(e, event_id=None) for e in after],
            app_id,
            channel_id=channel_id,
        )
        pe.delete(old_ids, app_id, channel_id=channel_id)
        return len(before) - len(after)
