"""Parquet columnar event store — the bulk/training-side backend.

The port's copy of ``pio_tpu/storage/parquet.py`` (the port imports
nothing of ``pio_tpu``), with the same schema and layout, so a shard
directory written by either package is read by the other: an append-only
directory of Parquet shards per (app, channel). Training reads scan shards
with pyarrow predicate pushdown and materialize columnar
:class:`EventFrame`s directly — no per-row Python objects on the hot path
(unlike the reference, the columns convert in one call each).
It serves PEvents only (``Storage.get_levents()`` refuses it, as the
reference's registry does).

Layout: ``<root>/app_<id>/channel_<cid>/part-<uuid>.parquet``.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Iterable, List, Optional

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pa_ds
import pyarrow.parquet as pq

from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.frame import EventFrame, json_objects
from pio_tpu_torch.utils.timeutil import from_micros as _from_us
from pio_tpu_torch.utils.timeutil import to_micros as _to_us

_SCHEMA = pa.schema(
    [
        ("id", pa.string()),
        ("event", pa.string()),
        ("entity_type", pa.string()),
        ("entity_id", pa.string()),
        ("target_entity_type", pa.string()),
        ("target_entity_id", pa.string()),
        ("properties", pa.string()),  # JSON
        ("event_time_us", pa.int64()),
        ("tags", pa.string()),  # JSON list
        ("pr_id", pa.string()),
        ("creation_time_us", pa.int64()),
    ]
)


class ParquetPEvents(base.PEvents):
    """Append-only Parquet shard store implementing the bulk PEvents SPI."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, app_id: int, channel_id) -> str:
        cid = 0 if channel_id is None else int(channel_id)
        return os.path.join(self.root, f"app_{app_id}", f"channel_{cid}")

    # -- write --------------------------------------------------------------
    def write(self, events: Iterable[Event], app_id, channel_id=None) -> None:
        evs = list(events)
        if not evs:
            return
        d = self._dir(app_id, channel_id)
        os.makedirs(d, exist_ok=True)
        table = pa.table(
            {
                "id": [e.event_id or Event.new_event_id() for e in evs],
                "event": [e.event for e in evs],
                "entity_type": [e.entity_type for e in evs],
                "entity_id": [e.entity_id for e in evs],
                "target_entity_type": [e.target_entity_type or "" for e in evs],
                "target_entity_id": [e.target_entity_id or "" for e in evs],
                "properties": [json.dumps(e.properties.to_dict()) for e in evs],
                "event_time_us": [_to_us(e.event_time) for e in evs],
                "tags": [json.dumps(list(e.tags)) for e in evs],
                "pr_id": [e.pr_id or "" for e in evs],
                "creation_time_us": [_to_us(e.creation_time) for e in evs],
            },
            schema=_SCHEMA,
        )
        pq.write_table(table, os.path.join(d, f"part-{uuid.uuid4().hex}.parquet"))

    # -- read ---------------------------------------------------------------
    def _filter_expr(
        self,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=None,
        target_entity_id=None,
    ):
        expr = None

        def conj(e):
            nonlocal expr
            expr = e if expr is None else expr & e

        if start_time is not None:
            conj(pc.field("event_time_us") >= _to_us(start_time))
        if until_time is not None:
            conj(pc.field("event_time_us") < _to_us(until_time))
        if entity_type is not None:
            conj(pc.field("entity_type") == entity_type)
        if entity_id is not None:
            conj(pc.field("entity_id") == entity_id)
        if event_names is not None:
            conj(pc.field("event").isin(list(event_names)))
        if target_entity_type is not None:
            conj(pc.field("target_entity_type") == target_entity_type)
        if target_entity_id is not None:
            conj(pc.field("target_entity_id") == target_entity_id)
        return expr

    def _scan(self, app_id, channel_id, **filters) -> Optional[pa.Table]:
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d) or not os.listdir(d):
            return None
        ds = pa_ds.dataset(d, format="parquet", schema=_SCHEMA)
        return ds.to_table(filter=self._filter_expr(**filters))

    def find(self, app_id, channel_id=None, **filters) -> List[Event]:
        table = self._scan(app_id, channel_id, **filters)
        if table is None:
            return []
        table = table.sort_by("event_time_us")
        cols = {name: table.column(name).to_pylist() for name in table.schema.names}
        out = []
        for i in range(table.num_rows):
            out.append(
                Event(
                    event=cols["event"][i],
                    entity_type=cols["entity_type"][i],
                    entity_id=cols["entity_id"][i],
                    target_entity_type=cols["target_entity_type"][i] or None,
                    target_entity_id=cols["target_entity_id"][i] or None,
                    properties=DataMap._wrap(json.loads(cols["properties"][i])),
                    event_time=_from_us(cols["event_time_us"][i]),
                    tags=tuple(json.loads(cols["tags"][i])),
                    pr_id=cols["pr_id"][i] or None,
                    event_id=cols["id"][i],
                    creation_time=_from_us(cols["creation_time_us"][i]),
                )
            )
        return out

    def find_frame(self, app_id, channel_id=None, **filters) -> EventFrame:
        """Columnar read that never builds per-row Event objects."""
        table = self._scan(app_id, channel_id, **filters)
        if table is None:
            return EventFrame.from_events([])
        table = table.sort_by("event_time_us")

        def objects(name):
            return table.column(name).to_numpy(zero_copy_only=False)

        return EventFrame(
            event=objects("event"),
            entity_type=objects("entity_type"),
            entity_id=objects("entity_id"),
            target_entity_type=objects("target_entity_type"),
            target_entity_id=objects("target_entity_id"),
            properties=json_objects(table.column("properties").to_pylist()),
            event_time_us=table.column("event_time_us").to_numpy(),
        )

    def delete(self, event_ids, app_id, channel_id=None) -> None:
        """Bulk delete = rewrite shards without the given ids (compaction)."""
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):
            return
        drop = set(event_ids)
        ds = pa_ds.dataset(d, format="parquet", schema=_SCHEMA)
        table = ds.to_table()
        keep = table.filter(~pc.field("id").isin(list(drop)))
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
        if keep.num_rows:
            pq.write_table(keep, os.path.join(d, f"part-{uuid.uuid4().hex}.parquet"))

    def compact(self, app_id, channel_id=None) -> None:
        """Merge shards into one file (the HBase-compaction analog)."""
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d) or len(os.listdir(d)) <= 1:
            return
        table = pa_ds.dataset(d, format="parquet", schema=_SCHEMA).to_table()
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
        pq.write_table(table, os.path.join(d, f"part-{uuid.uuid4().hex}.parquet"))
