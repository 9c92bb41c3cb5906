#!/usr/bin/env python3
"""The port's event stores' bulk write and read at MovieLens-1M's shape.

Builds ``--events`` ``rate`` events (default 1,000,209 over 6,040 users
and 3,706 items, synthetic as ``bench.py``'s ``_synth_ratings``, ids and
times fixed), then for each store of ``--stores`` under ``--root`` (a
fresh directory each): ``PEvents.write`` of them in ``--chunks`` calls,
each call timed, then ``find_frame`` of them. Prints one JSON object a
store: the write walls, the events a second, ``find_frame``'s wall, the
bytes on disk (with SQLite's WAL apart), ``os.cpu_count()``. Host clock;
the card is not used.

With ``--reference``, each store's ``find_frame`` is also read as the
JAX package's copy of the store reads it, and the two frames must be
equal: SQLite and searchable through ``find`` and
``EventFrame.from_events`` (the port reads the columns straight from the
rows), the event log with a decode a string and a ``json.loads`` a row
(the port decodes an ASCII arena once and parses a column in one call),
parquet through ``to_pylist`` and a ``json.loads`` a row (the port
converts a column with ``to_numpy``). The object gains
``reference_find_frame_s``, in turns with the port's read (port,
reference, reference, port: both walls of each).

Usage: ``python3 scripts/torch_store_write.py [--stores sqlite,searchable,
eventlog,parquet,memory] [--events N] [--chunks K] [--root DIR]
[--reference]``.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime as dt
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pio_tpu_torch.data.event import Event  # noqa: E402
from pio_tpu_torch.storage import eventlog, memory, parquet, searchable  # noqa: E402
from pio_tpu_torch.storage import sqlite as ssql  # noqa: E402
from pio_tpu_torch.storage.base import PEventsAdapter  # noqa: E402
from pio_tpu_torch.storage.frame import EventFrame  # noqa: E402

ML1M = (1_000_209, 6_040, 3_706)


def events(n: int, n_users: int, n_items: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, size=n).astype(np.int32)
    i = (rng.random(n) ** 2 * n_items).astype(np.int32)
    r = (rng.integers(1, 11, size=n) * 0.5).astype(np.float32)
    t0 = dt.datetime(2026, 4, 1, tzinfo=dt.timezone.utc)
    return [Event("rate", "user", f"u{a}", "item", f"i{b}",
                  properties={"rating": c},
                  event_time=t0 + dt.timedelta(seconds=k),
                  event_id=f"r{k:07d}", creation_time=t0)
            for k, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(),
                                              r.tolist()))]


def store(kind: str, root: str):
    if kind == "memory":
        return PEventsAdapter(memory.MemLEvents())
    if kind == "eventlog":
        return PEventsAdapter(eventlog.EventLogEvents(root))
    if kind == "parquet":
        return parquet.ParquetPEvents(root)
    db = os.path.join(root, "events.db")
    if kind == "sqlite":
        return PEventsAdapter(ssql.SQLiteEvents(ssql.SQLiteClient(db)))
    return PEventsAdapter(searchable.SearchableEvents(
        searchable.SearchableClient(db)))


@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _strings_one_by_one(arena: bytes, offsets: list) -> list:
    return [arena[offsets[k]:offsets[k + 1]].decode()
            for k in range(len(offsets) - 1)]


def _json_row_by_row(texts) -> list:
    return [json.loads(p) for p in texts]


def reference_frame(kind: str, pe) -> EventFrame:
    """``find_frame`` of app 1 as the JAX package's copy of the store
    computes it."""
    if kind in ("sqlite", "searchable"):
        return EventFrame.from_events(pe.find(1))
    if kind == "eventlog":
        with patched(eventlog, "_column_strings", _strings_one_by_one), \
                patched(eventlog, "json_objects", _json_row_by_row):
            return pe.find_frame(1)
    table = pe._scan(1, None).sort_by("event_time_us")

    def objects(name):
        return np.asarray(table.column(name).to_pylist(), dtype=object)

    return EventFrame(
        event=objects("event"), entity_type=objects("entity_type"),
        entity_id=objects("entity_id"),
        target_entity_type=objects("target_entity_type"),
        target_entity_id=objects("target_entity_id"),
        properties=_json_row_by_row(table.column("properties").to_pylist()),
        event_time_us=table.column("event_time_us").to_numpy())


def same_frame(a: EventFrame, b: EventFrame) -> bool:
    return all(np.array_equal(getattr(a, c), getattr(b, c)) for c in (
        "event", "entity_type", "entity_id", "target_entity_type",
        "target_entity_id", "event_time_us")) \
        and list(a.properties) == list(b.properties)


def timed(fn) -> tuple:
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def disk_bytes(root: str) -> dict:
    out = {"files": 0, "wal": 0}
    for dirpath, _, files in os.walk(root):
        for f in files:
            size = os.path.getsize(os.path.join(dirpath, f))
            out["wal" if f.endswith("-wal") else "files"] += size
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stores", default="sqlite,searchable,eventlog,parquet,memory")
    ap.add_argument("--events", type=int, default=ML1M[0])
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--root", default=os.path.join("build", "store_write"))
    ap.add_argument("--seed", type=int, default=44)
    ap.add_argument("--reference", action="store_true",
                    help="also read each store as the JAX package's copy "
                         "does, in turns with the port's read")
    args = ap.parse_args(argv)
    t = time.perf_counter()
    evs = events(args.events, ML1M[1], ML1M[2], args.seed)
    print(json.dumps({"events": len(evs), "built_s": time.perf_counter() - t,
                      "cpu_count": os.cpu_count()}), flush=True)
    for kind in args.stores.split(","):
        root = os.path.join(args.root, kind)
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        pe = store(kind, root)
        walls = []
        for chunk in np.array_split(np.arange(len(evs)), args.chunks):
            t = time.perf_counter()
            pe.write(evs[chunk[0]:chunk[-1] + 1], 1)
            walls.append(time.perf_counter() - t)
        frame, read_s = timed(lambda: pe.find_frame(1))
        if len(frame) != len(evs):
            raise AssertionError(f"{kind}: find_frame {len(frame)} events")
        row = {"store": kind, "write_s": walls,
               "events_per_s": len(evs) / sum(walls),
               "find_frame_s": read_s, **disk_bytes(root),
               "cpu_count": os.cpu_count()}
        if args.reference and kind != "memory":
            ref, ref_s = timed(lambda: reference_frame(kind, pe))
            if not same_frame(frame, ref):
                raise AssertionError(f"{kind}: the port's frame differs "
                                     f"from the reference's read")
            del ref
            ref_again = timed(lambda: reference_frame(kind, pe))[1]
            row["find_frame_s"] = [read_s, timed(lambda: pe.find_frame(1))[1]]
            row["reference_find_frame_s"] = [ref_s, ref_again]
            row["same_frame"] = True
        print(json.dumps(row), flush=True)
        del pe, frame
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
