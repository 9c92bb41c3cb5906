"""Property aggregation: fold $set/$unset/$delete streams into PropertyMaps.

Rebuild of the reference's ``data/.../data/storage/LEventAggregator.scala`` /
``PEventAggregator.scala`` (UNVERIFIED paths; see SURVEY.md). Semantics:

- events are folded in ascending ``event_time`` order (ties broken by
  insertion order, i.e. a stable sort);
- ``$set``    merges the event's properties over the current state
  (later event time wins per key);
- ``$unset``  removes the named keys;
- ``$delete`` clears the entity entirely — both the properties and the
  ``first_updated`` watermark restart at the next ``$set``;
- entities whose final state is deleted (or never ``$set``) yield no entry.

The port's copy of ``pio_tpu/data/aggregation.py`` (the port imports nothing of ``pio_tpu``).
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterable, Optional, Tuple

from pio_tpu_torch.data.datamap import PropertyMap
from pio_tpu_torch.data.event import SPECIAL_EVENTS, Event


class _PropState:
    """Mutable fold state for one entity (reference ``Prop`` case class)."""

    __slots__ = ("fields", "first_updated", "last_updated")

    def __init__(self):
        self.fields: Optional[dict] = None
        self.first_updated: Optional[_dt.datetime] = None
        self.last_updated: Optional[_dt.datetime] = None

    def step(self, e: Event) -> None:
        if e.event == "$set":
            if self.fields is None:
                self.fields = e.properties.to_dict()
                self.first_updated = e.event_time
            else:
                self.fields.update(e.properties.to_dict())
            self.last_updated = e.event_time
        elif e.event == "$unset":
            if self.fields is not None:
                for k in e.properties.keys():
                    self.fields.pop(k, None)
                self.last_updated = e.event_time
        elif e.event == "$delete":
            self.fields = None
            self.first_updated = None
            self.last_updated = None

    def result(self) -> Optional[PropertyMap]:
        if self.fields is None:
            return None
        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(self.fields, self.first_updated, self.last_updated)


def fold_properties(events: Iterable[Event]) -> Optional[PropertyMap]:
    """Fold one entity's special-event stream into its current PropertyMap."""
    ordered = sorted(events, key=lambda e: e.event_time)
    state = _PropState()
    for e in ordered:
        state.step(e)
    return state.result()


def aggregate_properties(
    events: Iterable[Event],
) -> Dict[Tuple[str, str], PropertyMap]:
    """Group special events by (entity_type, entity_id) and fold each group.

    Reference ``LEventAggregator.aggregateProperties``. Non-special events
    are ignored (callers normally pre-filter on event name).
    """
    groups: Dict[Tuple[str, str], list] = {}
    for e in events:
        if e.event in SPECIAL_EVENTS:
            groups.setdefault((e.entity_type, e.entity_id), []).append(e)
    out: Dict[Tuple[str, str], PropertyMap] = {}
    for key, evs in groups.items():
        pm = fold_properties(evs)
        if pm is not None:
            out[key] = pm
    return out
