"""Epoch-microsecond conversions — single source of truth.

The port's copy of ``pio_tpu/utils/timeutil.py`` (the port imports nothing
of ``pio_tpu``). Integer arithmetic only: float ``total_seconds()*1e6``
truncates 1us low for large (post-2038) and pre-1970 timestamps, which
after Event's millisecond truncation corrupts stored times by a full
millisecond on round-trip.
"""

from __future__ import annotations

import datetime as _dt

EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
_US = _dt.timedelta(microseconds=1)


def to_micros(t: _dt.datetime) -> int:
    return (t - EPOCH) // _US


def from_micros(us: int) -> _dt.datetime:
    return EPOCH + _dt.timedelta(microseconds=int(us))
