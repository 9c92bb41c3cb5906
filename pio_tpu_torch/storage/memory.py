"""In-memory storage backend — tests + ephemeral servers.

Plays the role of the reference's H2/in-process JDBC test backends
(SURVEY.md §4: "one spec, many backends"). Implements every SPI trait.
Thread-safe via a single coarse lock (the Event Server inserts from multiple
request threads).

The port's copy of ``pio_tpu/storage/memory.py`` (the port imports nothing of ``pio_tpu``).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import replace as _replace
from typing import Dict, Iterable, List, Optional, Tuple

from pio_tpu_torch.data.event import Event
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.records import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)


def _match(
    e: Event,
    start_time=None,
    until_time=None,
    entity_type=None,
    entity_id=None,
    event_names=None,
    target_entity_type=None,
    target_entity_id=None,
) -> bool:
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in set(event_names):
        return False
    if target_entity_type is not None and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not None and e.target_entity_id != target_entity_id:
        return False
    return True


class MemLEvents(base.LEvents, base.PEvents):
    """Both LEvents and PEvents over one dict-of-lists store."""

    def __init__(self):
        self._lock = threading.RLock()
        # (app_id, channel_id) -> {event_id: Event}
        self._events: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}

    def _bucket(self, app_id: int, channel_id) -> Dict[str, Event]:
        return self._events.setdefault((app_id, channel_id), {})

    # -- LEvents ------------------------------------------------------------
    def init_channel(self, app_id, channel_id=None) -> bool:
        with self._lock:
            self._bucket(app_id, channel_id)
        return True

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        with self._lock:
            eid = event.event_id or Event.new_event_id()
            # an Event is frozen: one that carries its id is stored as is
            self._bucket(app_id, channel_id)[eid] = (
                event if event.event_id == eid else event.with_event_id(eid))
            return eid

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        with self._lock:
            return self._bucket(app_id, channel_id).get(event_id)

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        with self._lock:
            return self._bucket(app_id, channel_id).pop(event_id, None) is not None

    def find(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=None,
        target_entity_id=None,
        limit=None,
        reversed_order=False,
    ) -> List[Event]:
        with self._lock:
            evs = list(self._bucket(app_id, channel_id).values())
        evs = [
            e
            for e in evs
            if _match(
                e,
                start_time,
                until_time,
                entity_type,
                entity_id,
                event_names,
                target_entity_type,
                target_entity_id,
            )
        ]
        evs.sort(key=lambda e: e.event_time, reverse=reversed_order)
        if limit is not None and limit >= 0:
            evs = evs[:limit]
        return evs

    def remove(self, app_id, channel_id=None) -> bool:
        with self._lock:
            self._events.pop((app_id, channel_id), None)
        return True

    # -- PEvents ------------------------------------------------------------
    def write(self, events: Iterable[Event], app_id, channel_id=None) -> None:
        with self._lock:
            for e in events:
                self.insert(e, app_id, channel_id)

    # PEvents.find shares the LEvents signature minus limit; the LEvents
    # implementation above already covers it.

    def delete_bulk(self, event_ids, app_id, channel_id=None) -> None:
        with self._lock:
            for eid in event_ids:
                self._bucket(app_id, channel_id).pop(eid, None)


# Shared facade mapping the bulk PEvents SPI onto the combined store.
MemPEvents = base.PEventsAdapter


class MemApps(base.Apps):
    def __init__(self):
        self._lock = threading.RLock()
        self._apps: Dict[int, App] = {}
        self._next = 1

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            if self.get_by_name(app.name) is not None:
                return None
            app_id = app.id
            if app_id == 0:
                app_id = self._next
            if app_id in self._apps:
                return None
            self._next = max(self._next, app_id) + 1
            self._apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        for a in self._apps.values():
            if a.name == name:
                return a
        return None

    def get_all(self) -> List[App]:
        return sorted(self._apps.values(), key=lambda a: a.id)

    def update(self, app: App) -> bool:
        with self._lock:
            if app.id not in self._apps:
                return False
            self._apps[app.id] = app
            return True

    def delete(self, app_id: int) -> bool:
        with self._lock:
            return self._apps.pop(app_id, None) is not None


class MemAccessKeys(base.AccessKeys):
    def __init__(self):
        self._lock = threading.RLock()
        self._keys: Dict[str, AccessKey] = {}

    def insert(self, access_key: AccessKey) -> Optional[str]:
        with self._lock:
            ak = access_key
            if not ak.key:
                ak = AccessKey.generate(ak.app_id, ak.events)
            if ak.key in self._keys:
                return None
            self._keys[ak.key] = ak
            return ak.key

    def get(self, key: str) -> Optional[AccessKey]:
        return self._keys.get(key)

    def get_all(self) -> List[AccessKey]:
        return list(self._keys.values())

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [k for k in self._keys.values() if k.app_id == app_id]

    def update(self, access_key: AccessKey) -> bool:
        with self._lock:
            if access_key.key not in self._keys:
                return False
            self._keys[access_key.key] = access_key
            return True

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._keys.pop(key, None) is not None


class MemChannels(base.Channels):
    def __init__(self):
        self._lock = threading.RLock()
        self._channels: Dict[int, Channel] = {}
        self._next = 1

    def insert(self, channel: Channel) -> Optional[int]:
        with self._lock:
            if not Channel.is_valid_name(channel.name):
                return None
            cid = channel.id or self._next
            if cid in self._channels:
                return None
            self._next = max(self._next, cid) + 1
            self._channels[cid] = Channel(cid, channel.name, channel.app_id)
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._channels.values() if c.app_id == app_id]

    def delete(self, channel_id: int) -> bool:
        with self._lock:
            return self._channels.pop(channel_id, None) is not None


class MemEngineInstances(base.EngineInstances):
    def __init__(self):
        self._lock = threading.RLock()
        self._instances: Dict[str, EngineInstance] = {}

    def insert(self, instance: EngineInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            self._instances[iid] = (
                instance if instance.id else _replace(instance, id=iid)
            )
            return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return self._instances.get(instance_id)

    def get_all(self) -> List[EngineInstance]:
        return list(self._instances.values())

    def get_completed(self, engine_id, engine_version, engine_variant):
        out = [
            i
            for i in self._instances.values()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, instance: EngineInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemEvaluationInstances(base.EvaluationInstances):
    def __init__(self):
        self._lock = threading.RLock()
        self._instances: Dict[str, EvaluationInstance] = {}

    def insert(self, instance: EvaluationInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            self._instances[iid] = (
                instance if instance.id else _replace(instance, id=iid)
            )
            return iid

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return self._instances.get(instance_id)

    def get_all(self) -> List[EvaluationInstance]:
        return list(self._instances.values())

    def get_completed(self) -> List[EvaluationInstance]:
        out = [i for i in self._instances.values() if i.status == "COMPLETED"]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def update(self, instance: EvaluationInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemModels(base.Models):
    def __init__(self):
        self._models: Dict[str, Model] = {}

    def insert(self, model: Model) -> None:
        self._models[model.id] = model

    def get(self, model_id: str) -> Optional[Model]:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> bool:
        return self._models.pop(model_id, None) is not None
