"""Storage SPI — abstract interfaces every backend implements.

Rebuild of the reference's storage traits (``data/.../data/storage/
{LEvents,PEvents,Apps,AccessKeys,Channels,EngineInstances,
EvaluationInstances,Models}.scala`` — UNVERIFIED paths; see SURVEY.md).

Two event access styles, as in the reference:

- :class:`LEvents` — single-row CRUD + filtered scans; the low-latency,
  serving-side path (Event Server inserts, feedback loop reads).
- :class:`PEvents` — bulk access for training (the reference's Spark
  ``RDD[Event]``), as Python lists or a columnar
  :class:`~pio_tpu_torch.storage.frame.EventFrame` (:meth:`PEvents.find_frame`).

A backend may implement both over the same underlying store (the SQLite
and memory backends do).

The port's copy of ``pio_tpu/storage/base.py`` (the port imports nothing of
``pio_tpu``).
"""

from __future__ import annotations

import abc
import datetime as _dt
from typing import Iterable, List, Optional, Sequence

from pio_tpu_torch.data.datamap import PropertyMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.storage.records import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)

#: channel_id None == default channel (reference uses Option[Int]).
ChannelId = Optional[int]


class StorageError(RuntimeError):
    pass


def _aggregate_via_find(
    find,
    app_id: int,
    entity_type: str,
    channel_id: ChannelId,
    start_time,
    until_time,
    required,
) -> dict:
    """Shared fold behind LEvents/PEvents.aggregate_properties."""
    from pio_tpu_torch.data.aggregation import aggregate_properties as _agg
    from pio_tpu_torch.data.event import SPECIAL_EVENTS

    events = find(
        app_id,
        channel_id=channel_id,
        start_time=start_time,
        until_time=until_time,
        entity_type=entity_type,
        event_names=sorted(SPECIAL_EVENTS),
    )
    folded = _agg(events)
    out = {eid: pm for (etype, eid), pm in folded.items() if etype == entity_type}
    if required:
        req = set(required)
        out = {k: v for k, v in out.items() if req.issubset(v.keys())}
    return out


class LEvents(abc.ABC):
    """Single-event CRUD + query (reference trait ``LEvents``)."""

    @abc.abstractmethod
    def init_channel(self, app_id: int, channel_id: ChannelId = None) -> bool:
        """Prepare storage for an (app, channel); idempotent."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: ChannelId = None) -> str:
        """Insert one event; returns the (possibly generated) event id."""

    def insert_batch(
        self, events: List[Event], app_id: int,
        channel_id: ChannelId = None,
    ) -> List[str]:
        """Insert many events, returning their ids in order.

        Default loops :meth:`insert`; backends with a cheaper bulk path
        (one transaction/commit instead of one per event — the sqlite
        backend measures ~4× on the batch ingest route) override it. The
        reference's ``/batch/events.json`` is the consumer.
        """
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: ChannelId = None
    ) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: ChannelId = None
    ) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: ChannelId = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> List[Event]:
        """Filtered scan ordered by event time (desc when ``reversed_order``).

        ``limit=None`` means no limit; the reference's ``limit=-1`` maps to
        ``None`` here.
        """

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: ChannelId = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict:
        """Fold special events into per-entity PropertyMaps.

        Default implementation on top of :meth:`find`, as the reference's
        ``LEventAggregator`` does; backends may override with a pushed-down
        version. Returns {entity_id: PropertyMap}.
        """
        return _aggregate_via_find(
            self.find, app_id, entity_type, channel_id, start_time, until_time,
            required,
        )

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: ChannelId = None) -> bool:
        """Drop all events for (app, channel)."""

    def close(self) -> None:
        pass


class PEvents(abc.ABC):
    """Bulk event access for training (reference trait ``PEvents``).

    The reference returns ``RDD[Event]``; this returns either a Python list
    (:meth:`find`) or a columnar :class:`EventFrame` (:meth:`find_frame`).
    """

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: ChannelId = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
    ) -> List[Event]: ...

    def find_frame(self, app_id: int, **filters):
        """Columnar bulk read. Default: build from :meth:`find`."""
        from pio_tpu_torch.storage.frame import EventFrame

        return EventFrame.from_events(self.find(app_id, **filters))

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: ChannelId = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict:
        return _aggregate_via_find(
            self.find, app_id, entity_type, channel_id, start_time, until_time,
            required,
        )

    @abc.abstractmethod
    def write(
        self, events: Iterable[Event], app_id: int, channel_id: ChannelId = None
    ) -> None:
        """Bulk append (reference ``PEvents.write``)."""

    @abc.abstractmethod
    def delete(
        self, event_ids: Iterable[str], app_id: int, channel_id: ChannelId = None
    ) -> None:
        """Bulk delete by event id (reference ``PEvents.delete``)."""


class PEventsAdapter(PEvents):
    """PEvents facade over a combined LEvents+bulk backend.

    Needed because ``PEvents.delete`` (bulk, by id list) clashes with
    ``LEvents.delete`` (single id) on classes implementing both; backends
    expose the bulk variant as ``delete_bulk`` and this adapter maps it to
    the SPI name.
    """

    def __init__(self, backend):
        self._b = backend

    def find(self, app_id, channel_id=None, **filters) -> List[Event]:
        return self._b.find(app_id, channel_id=channel_id, **filters)

    def find_frame(self, app_id, **filters):
        # a backend with a columnar read of its own (the event log's
        # native scan) keeps it on the bulk path
        if hasattr(self._b, "find_frame"):
            return self._b.find_frame(app_id, **filters)
        return super().find_frame(app_id, **filters)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None) -> dict:
        # a backend that pushed the fold down (e.g. the partitioned log's
        # snapshot-aware read) must keep that advantage on the bulk path
        if type(self._b).aggregate_properties is not LEvents.aggregate_properties:
            return self._b.aggregate_properties(
                app_id, entity_type, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                required=required,
            )
        return super().aggregate_properties(
            app_id, entity_type, channel_id=channel_id,
            start_time=start_time, until_time=until_time, required=required,
        )

    def write(self, events, app_id, channel_id=None) -> None:
        self._b.write(events, app_id, channel_id)

    def delete(self, event_ids, app_id, channel_id=None) -> None:
        self._b.delete_bulk(event_ids, app_id, channel_id)


# ----------------------------------------------------------------- meta data
class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; app.id==0 means auto-assign. Returns assigned id."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> Optional[str]:
        """Insert; empty key means generate. Returns the key string."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]:
        """Insert; channel.id==0 means auto-assign. Returns assigned id."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert; empty id means generate. Returns id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...
