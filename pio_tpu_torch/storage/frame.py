"""EventFrame — a batch of events as host columns.

The port's copy of ``pio_tpu/storage/frame.py`` (the port imports nothing
of ``pio_tpu``): bulk event reads (:meth:`PEvents.find_frame`) come back
as column arrays a data source turns into training arrays in a few
vectorized steps. ``to_device_arrays``, which places columns on a mesh,
comes with the multi-device slice.
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Iterable, List, Optional, Tuple

import numpy as np

from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.data.event import Event

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
_US = _dt.timedelta(microseconds=1)


def _to_micros(t: _dt.datetime) -> int:
    """Epoch microseconds, in integer arithmetic (a float conversion
    truncates 1 us low far from 1970)."""
    return (t - _EPOCH) // _US


def json_objects(texts) -> list:
    """The JSON texts of a properties column parsed in one call: a whole
    column as one JSON array, several times faster than a ``json.loads``
    a row, with the same values."""
    return json.loads("[" + ",".join(texts) + "]")


class EventFrame:
    """A batch of events in column-oriented form."""

    def __init__(
        self,
        event: np.ndarray,
        entity_type: np.ndarray,
        entity_id: np.ndarray,
        target_entity_type: np.ndarray,
        target_entity_id: np.ndarray,
        properties: List[dict],
        event_time_us: np.ndarray,
    ):
        self.event = event
        self.entity_type = entity_type
        self.entity_id = entity_id
        self.target_entity_type = target_entity_type
        self.target_entity_id = target_entity_id
        self.properties = properties
        self.event_time_us = event_time_us

    @classmethod
    def from_events(cls, events: Iterable[Event]) -> "EventFrame":
        evs = list(events)
        return cls(
            event=np.array([e.event for e in evs], dtype=object),
            entity_type=np.array([e.entity_type for e in evs], dtype=object),
            entity_id=np.array([e.entity_id for e in evs], dtype=object),
            target_entity_type=np.array(
                [e.target_entity_type or "" for e in evs], dtype=object
            ),
            target_entity_id=np.array(
                [e.target_entity_id or "" for e in evs], dtype=object
            ),
            properties=[e.properties.to_dict() for e in evs],
            event_time_us=np.array(
                [_to_micros(e.event_time) for e in evs], dtype=np.int64
            ),
        )

    def __len__(self) -> int:
        return len(self.event)

    def property_column(
        self, name: str, dtype=np.float32, default: float = np.nan
    ) -> np.ndarray:
        """Numeric property column; missing values become ``default``."""
        out = np.full(len(self), default, dtype=dtype)
        for i, p in enumerate(self.properties):
            v = p.get(name)
            if v is not None:
                out[i] = v
        return out

    def codes(
        self, column: str, index: Optional[BiMap] = None
    ) -> Tuple[BiMap, np.ndarray]:
        """Index a string column into dense int32 codes.

        Returns (BiMap, codes). Unseen ids under a supplied ``index`` map to
        -1 (callers mask them out).
        """
        col = getattr(self, column)
        if index is None:
            index = BiMap.string_int(col.tolist())
        fwd = index.to_dict()
        codes = np.array([fwd.get(v, -1) for v in col.tolist()], dtype=np.int32)
        return index, codes
