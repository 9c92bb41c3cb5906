"""User-facing event store facades — stable API over the storage SPI.

Rebuild of the reference's ``data/src/main/scala/o/a/p/data/store/
{PEventStore,LEventStore,Common}.scala`` (UNVERIFIED paths; SURVEY.md §2.2
"Store facades"): engine code addresses apps by NAME (+ optional channel
name), the facade resolves names against the meta store and forwards to the
configured backend. ``PEventStore`` is the bulk/training side — its
``find`` returns a columnar :class:`EventFrame` ready for device transfer
(the reference returns an ``RDD[Event]``); ``LEventStore`` is the serving
side returning ``Event`` lists. Both are synchronous: the reference's
future/timeout machinery wrapped network storage clients, which this
framework's local backends don't need.

The port's copy of ``pio_tpu/data/store.py`` (the port imports nothing of
``pio_tpu``).
"""

from __future__ import annotations

import datetime as _dt
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from pio_tpu_torch.data.datamap import PropertyMap
from pio_tpu_torch.data.event import Event

if TYPE_CHECKING:  # import cycle: storage.base imports data
    from pio_tpu_torch.storage.frame import EventFrame


def _storage():
    """Deferred registry import — pio_tpu_torch.storage imports
    pio_tpu_torch.data at module load, so a top-level import here would be circular."""
    from pio_tpu_torch.storage.registry import Storage

    return Storage


def resolve_channel(app_id: int, channel_name: Optional[str]) -> Optional[int]:
    """channel_id from its name within an app; None = default channel.

    The single home for channel lookup — the CLI and template helpers
    delegate here rather than re-implementing the meta-store query.
    """
    if not channel_name:
        return None
    chans = _storage().get_meta_data_channels().get_by_app_id(app_id)
    match = [c for c in chans if c.name == channel_name]
    if not match:
        raise ValueError(f"channel {channel_name!r} not found")
    return match[0].id


def resolve_names(
    app_name: str, channel_name: Optional[str] = None
) -> Tuple[int, Optional[int]]:
    """(app_id, channel_id) from names (reference ``Common.appNameToId``).

    ``channel_name`` None → the app's default channel (channel_id None).
    """
    app = _storage().get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise ValueError(f"app {app_name!r} not found")
    return app.id, resolve_channel(app.id, channel_name)


class PEventStore:
    """Bulk (training-side) reads — reference ``PEventStore`` object."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
    ) -> EventFrame:
        """Filtered scan → columnar frame (reference returns RDD[Event])."""
        app_id, channel_id = resolve_names(app_name, channel_name)
        return _storage().get_pevents().find_frame(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )

    @staticmethod
    def find_events(
        app_name: str, channel_name: Optional[str] = None, **filters
    ) -> List[Event]:
        """Same filters as :meth:`find`, materialized as Event objects."""
        app_id, channel_id = resolve_names(app_name, channel_name)
        return _storage().get_pevents().find(
            app_id, channel_id=channel_id, **filters
        )

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """{entity_id: PropertyMap} from the entity's $set/$unset/$delete
        stream (reference ``PEventStore.aggregateProperties``)."""
        app_id, channel_id = resolve_names(app_name, channel_name)
        return _storage().get_pevents().aggregate_properties(
            app_id,
            entity_type,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )


class LEventStore:
    """Low-latency (serving-side) reads — reference ``LEventStore``."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = True,
    ) -> List[Event]:
        """Newest-first by default, as the serving path wants recency."""
        app_id, channel_id = resolve_names(app_name, channel_name)
        return _storage().get_levents().find(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed_order=reversed_order,
        )

    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> List[Event]:
        """One entity's recent events (reference
        ``LEventStore.findByEntity``) — e.g. a user's last N interactions
        fetched inside ``Algorithm.predict`` for real-time re-ranking."""
        return LEventStore.find(
            app_name,
            channel_name=channel_name,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            limit=limit,
            reversed_order=latest,
        )
