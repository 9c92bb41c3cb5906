"""SQLite storage backend — the quickstart default.

Plays the role of the reference's JDBC/PostgreSQL backend
(``storage/jdbc/src/main/scala/o/a/p/data/storage/jdbc/*`` — UNVERIFIED
path; see SURVEY.md): implements every SPI trait over a single SQLite file.
Connections are per-thread (sqlite3 objects can't cross threads); WAL mode
keeps concurrent server reads cheap.

The port's copy of ``pio_tpu/storage/sqlite.py`` (the port imports nothing
of ``pio_tpu``), with the same schema and version, so one ``pio.db`` is
read and written by both packages. Failpoints: the group committer's
``groupcommit.flush.sqlite`` and ``storage.sqlite.commit`` between the
event flush's ``executemany`` and its commit. Unlike the reference, the
events' ``find_frame`` reads its columns straight from the rows (the same
frame, without an Event object a row), a connection keeps its statement
journals and temp tables in memory, and a bulk ``write`` holds a large page
cache until its commit (the same rows, far fewer write calls).
"""

from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import threading
import uuid
from typing import Iterable, List, Optional

import numpy as np

from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.durability import mode as _durability
from pio_tpu_torch.storage.frame import EventFrame, json_objects
from pio_tpu_torch.storage.groupcommit import GroupCommitter
from pio_tpu_torch.storage.records import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)
from pio_tpu_torch.utils.timeutil import from_micros as _from_us, to_micros as _to_us

_SCHEMA = """
CREATE TABLE IF NOT EXISTS events (
  id TEXT NOT NULL,
  app_id INTEGER NOT NULL,
  channel_id INTEGER NOT NULL DEFAULT 0,
  event TEXT NOT NULL,
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  target_entity_type TEXT,
  target_entity_id TEXT,
  properties TEXT NOT NULL,
  event_time_us INTEGER NOT NULL,
  tags TEXT NOT NULL,
  pr_id TEXT,
  creation_time_us INTEGER NOT NULL,
  PRIMARY KEY (app_id, channel_id, id)
);
CREATE INDEX IF NOT EXISTS idx_events_scan
  ON events (app_id, channel_id, event_time_us);
CREATE INDEX IF NOT EXISTS idx_events_entity
  ON events (app_id, channel_id, entity_type, entity_id);
CREATE TABLE IF NOT EXISTS apps (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  description TEXT
);
CREATE TABLE IF NOT EXISTS access_keys (
  key TEXT PRIMARY KEY,
  app_id INTEGER NOT NULL,
  events TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS channels (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL,
  app_id INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS engine_instances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  start_time_us INTEGER NOT NULL,
  end_time_us INTEGER NOT NULL,
  engine_id TEXT NOT NULL,
  engine_version TEXT NOT NULL,
  engine_variant TEXT NOT NULL,
  engine_factory TEXT NOT NULL,
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  jax_conf TEXT NOT NULL DEFAULT '{}',
  data_source_params TEXT NOT NULL DEFAULT '{}',
  preparator_params TEXT NOT NULL DEFAULT '{}',
  algorithms_params TEXT NOT NULL DEFAULT '[]',
  serving_params TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS evaluation_instances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  start_time_us INTEGER NOT NULL,
  end_time_us INTEGER NOT NULL,
  evaluation_class TEXT NOT NULL DEFAULT '',
  engine_params_generator_class TEXT NOT NULL DEFAULT '',
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  evaluator_results TEXT NOT NULL DEFAULT '',
  evaluator_results_html TEXT NOT NULL DEFAULT '',
  evaluator_results_json TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS models (
  id TEXT PRIMARY KEY,
  models BLOB NOT NULL
);
"""

#: bump when _SCHEMA changes shape, and add a migration step below
#: (reference analog: `pio upgrade` migrating storage between releases)
SCHEMA_VERSION = 1

#: from-version → LIST of single SQL statements bringing the db to
#: from-version + 1. Statement lists (not scripts): sqlite3's
#: executescript() force-commits, which would break the per-step
#: transaction that makes a failed migration roll back cleanly.
MIGRATIONS: dict = {}


class SQLiteClient:
    """Per-thread connections to one SQLite file (or shared memory db)."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._init_lock = threading.Lock()
        with self._init_lock:
            conn = self.conn()
            # the DDL commit inside _migrate is the same one-shot
            # migration the suppression below covers
            self._migrate(conn)  # pio: disable=lock-blocking-call
            # one-shot schema migration: serializing the commit is the
            # point (concurrent first-openers must not race the DDL)
            conn.commit()  # pio: disable=lock-blocking-call

    @staticmethod
    def _migrate(conn) -> None:
        """Create or upgrade the schema, stamped via PRAGMA user_version.

        Version 0 covers both fresh files and pre-versioning databases;
        the CREATE IF NOT EXISTS script is idempotent over the latter.
        A FILE NEWER than this build refuses to open (no downgrades).
        """
        v = conn.execute("PRAGMA user_version").fetchone()[0]
        if v > SCHEMA_VERSION:
            raise base.StorageError(
                f"database schema v{v} is newer than this build's "
                f"v{SCHEMA_VERSION}; upgrade pio-tpu instead"
            )
        if v == 0:
            pre_versioning = conn.execute(
                "SELECT 1 FROM sqlite_master WHERE type='table' "
                "AND name='events'"
            ).fetchone()
            if pre_versioning:
                # tables from a pre-versioning build: stamp v1 (their
                # shape) and fall through the ladder like any old db
                conn.execute("PRAGMA user_version = 1")
                conn.commit()
                v = 1
            else:
                # fresh file: current schema directly, no ladder
                conn.executescript(_SCHEMA)
                conn.execute(f"PRAGMA user_version = {SCHEMA_VERSION}")
                conn.commit()
                return
        for step in range(v, SCHEMA_VERSION):
            if step not in MIGRATIONS:
                raise base.StorageError(
                    f"no migration registered for schema v{step} → "
                    f"v{step + 1} (SCHEMA_VERSION bumped without a "
                    "MIGRATIONS entry)"
                )
            # one transaction per step, stamped inside it: a failure rolls
            # the step back whole, and a concurrent migrator blocks on
            # BEGIN IMMEDIATE then re-reads the version it races with
            conn.commit()  # close any implicit transaction first
            conn.execute("BEGIN IMMEDIATE")
            try:
                cur = conn.execute("PRAGMA user_version").fetchone()[0]
                if cur != step:  # someone else already applied this step
                    conn.rollback()
                    continue
                for stmt in MIGRATIONS[step]:
                    conn.execute(stmt)
                conn.execute(f"PRAGMA user_version = {step + 1}")
                conn.commit()
            except BaseException:
                conn.rollback()
                raise

    @staticmethod
    def schema_version(conn) -> int:
        return conn.execute("PRAGMA user_version").fetchone()[0]

    def conn(self) -> sqlite3.Connection:
        c = getattr(self._local, "conn", None)
        if c is None:
            try:
                c = sqlite3.connect(self.path, timeout=30.0)
            except sqlite3.OperationalError:
                # self-heal a vanished parent directory (cleanup/rotation
                # under a long-running server) instead of failing every
                # request until restart
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                c = sqlite3.connect(self.path, timeout=30.0)
            c.execute("PRAGMA journal_mode=WAL")
            # the durability knob maps onto SQLite's sync levels: commit
            # = FULL (fsync per txn), batch = NORMAL (WAL fsyncs at
            # checkpoint), os = OFF (page cache only)
            sync = {"commit": "FULL", "batch": "NORMAL", "os": "OFF"}[
                _durability()
            ]
            c.execute(f"PRAGMA synchronous={sync}")
            # in-engine busy handler alongside the connect timeout: a
            # statement hitting SQLITE_BUSY retries inside sqlite before
            # surfacing OperationalError (which retrying() then treats
            # as transient)
            c.execute("PRAGMA busy_timeout=30000")
            # default checkpoint-every-1000-pages runs mid-commit on the
            # ingest hot path (measured ~2x per-insert cost); 16384 pages
            # (~64 MB WAL ceiling) amortizes it — readers are unaffected,
            # the WAL is part of the database
            c.execute("PRAGMA wal_autocheckpoint=16384")
            # statement journals and temp tables in memory: a statement
            # that may fire a trigger (the searchable store's REPLACE)
            # otherwise journals every page it touches to a temp file,
            # about 9 write calls a row of a bulk write
            c.execute("PRAGMA temp_store=MEMORY")
            self._local.conn = c
        return c

    def close(self):
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None


#: the page cache a bulk write holds (KiB): SQLite's default 2 MB spills
#: dirty pages to the WAL a few at a time all through a large transaction
BULK_CACHE_KIB = 256 * 1024


@contextlib.contextmanager
def bulk_cache(conn: sqlite3.Connection):
    """A page cache of BULK_CACHE_KIB on ``conn`` inside the block (the
    connection's own size restored after): a bulk write's pages stay in
    memory until its commit writes them once."""
    (old,) = conn.execute("PRAGMA cache_size").fetchone()
    conn.execute(f"PRAGMA cache_size=-{BULK_CACHE_KIB}")
    try:
        yield conn
    finally:
        conn.execute(f"PRAGMA cache_size={old}")


def _chan(channel_id) -> int:
    return 0 if channel_id is None else int(channel_id)


def _row_to_event(r) -> Event:
    return Event(
        event=r[3],
        entity_type=r[4],
        entity_id=r[5],
        target_entity_type=r[6],
        target_entity_id=r[7],
        properties=DataMap._wrap(json.loads(r[8])),
        event_time=_from_us(r[9]),
        tags=tuple(json.loads(r[10])),
        pr_id=r[11],
        event_id=r[0],
        creation_time=_from_us(r[12]),
    )


_EVENT_INSERT_SQL = (
    "INSERT OR REPLACE INTO events VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"
)


class SQLiteEvents(base.LEvents, base.PEvents):
    """LEvents + PEvents over the ``events`` table."""

    def __init__(self, client: SQLiteClient):
        self._c = client
        # the group committer must coalesce across REQUESTS, and the
        # registry builds a fresh wrapper per get_levents() call — so it
        # lives on the (cached, shared) client, created once
        gc = getattr(client, "_events_gc", None)
        if gc is None:
            with client._init_lock:
                gc = getattr(client, "_events_gc", None)
                if gc is None:
                    def flush(payloads):
                        conn = client.conn()
                        try:
                            conn.executemany(
                                _EVENT_INSERT_SQL,
                                [p[1] for p in payloads],
                            )
                            # between executemany and commit: an error
                            # here proves the rollback keeps the thread-
                            # local connection clean; a crash proves WAL
                            # recovery drops the uncommitted txn whole
                            failpoint("storage.sqlite.commit")
                            conn.commit()
                        except Exception:
                            # leave nothing pending on the thread-local
                            # connection — an unrolled-back partial
                            # executemany would ride out with the next
                            # unrelated commit despite the client 500
                            conn.rollback()
                            raise
                        return [p[0] for p in payloads]

                    gc = GroupCommitter(flush, store="sqlite")
                    client._events_gc = gc
        self._gc = gc

    def init_channel(self, app_id, channel_id=None) -> bool:
        return True  # single-table design; nothing to create

    @staticmethod
    def _row(eid: str, event: Event, app_id, channel_id):
        return (
            eid,
            app_id,
            _chan(channel_id),
            event.event,
            event.entity_type,
            event.entity_id,
            event.target_entity_type,
            event.target_entity_id,
            json.dumps(event.properties.to_dict()),
            _to_us(event.event_time),
            json.dumps(list(event.tags)),
            event.pr_id,
            _to_us(event.creation_time),
        )

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        """Single insert via GROUP COMMIT: concurrent single-event
        ingests coalesce into one executemany + one WAL commit (the
        leader/follower protocol in storage/groupcommit.py — free for
        serial traffic, amortized commits under concurrent POSTs)."""
        eid = event.event_id or Event.new_event_id()
        return self._gc.submit(
            (eid, self._row(eid, event, app_id, channel_id))
        )

    def insert_batch(self, events, app_id, channel_id=None):
        """One executemany + one commit for the whole batch (the WAL
        commit per event dominates per-event cost; amortizing it across
        ≤50 events is the batch route's whole point)."""
        ids = [e.event_id or Event.new_event_id() for e in events]
        conn = self._c.conn()
        conn.executemany(
            _EVENT_INSERT_SQL,
            [
                self._row(eid, e, app_id, channel_id)
                for eid, e in zip(ids, events)
            ],
        )
        conn.commit()
        return ids

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        cur = self._c.conn().execute(
            "SELECT * FROM events WHERE app_id=? AND channel_id=? AND id=?",
            (app_id, _chan(channel_id), event_id),
        )
        r = cur.fetchone()
        return _row_to_event(r) if r else None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        conn = self._c.conn()
        cur = conn.execute(
            "DELETE FROM events WHERE app_id=? AND channel_id=? AND id=?",
            (app_id, _chan(channel_id), event_id),
        )
        conn.commit()
        return cur.rowcount > 0

    def _select(self, columns: str, app_id, channel_id=None, start_time=None,
                until_time=None, entity_type=None, entity_id=None,
                event_names=None, target_entity_type=None,
                target_entity_id=None, limit=None, reversed_order=False):
        """The rows of ``columns`` that pass the filters, in time order."""
        sql = [f"SELECT {columns} FROM events WHERE app_id=? AND channel_id=?"]
        args: list = [app_id, _chan(channel_id)]
        if start_time is not None:
            sql.append("AND event_time_us >= ?")
            args.append(_to_us(start_time))
        if until_time is not None:
            sql.append("AND event_time_us < ?")
            args.append(_to_us(until_time))
        if entity_type is not None:
            sql.append("AND entity_type = ?")
            args.append(entity_type)
        if entity_id is not None:
            sql.append("AND entity_id = ?")
            args.append(entity_id)
        if event_names is not None:
            qs = ",".join("?" * len(list(event_names)))
            sql.append(f"AND event IN ({qs})")
            args.extend(event_names)
        if target_entity_type is not None:
            sql.append("AND target_entity_type = ?")
            args.append(target_entity_type)
        if target_entity_id is not None:
            sql.append("AND target_entity_id = ?")
            args.append(target_entity_id)
        sql.append(
            "ORDER BY event_time_us DESC" if reversed_order else "ORDER BY event_time_us ASC"
        )
        if limit is not None and limit >= 0:
            sql.append("LIMIT ?")
            args.append(limit)
        return self._c.conn().execute(" ".join(sql), args).fetchall()

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
        rows = self._select(
            "*", app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
            limit, reversed_order,
        )
        return [_row_to_event(r) for r in rows]

    def find_frame(self, app_id, channel_id=None, **filters) -> EventFrame:
        """Columnar bulk read straight from the rows: the frame
        ``EventFrame.from_events(find(...))`` gives, without an Event a
        row (times truncate to the millisecond, as an Event's do)."""
        rows = self._select(
            "event, entity_type, entity_id, coalesce(target_entity_type, ''),"
            " coalesce(target_entity_id, ''), properties, event_time_us",
            app_id, channel_id, **filters,
        )
        cols = list(zip(*rows)) if rows else [()] * 7
        return EventFrame(
            event=np.array(cols[0], dtype=object),
            entity_type=np.array(cols[1], dtype=object),
            entity_id=np.array(cols[2], dtype=object),
            target_entity_type=np.array(cols[3], dtype=object),
            target_entity_id=np.array(cols[4], dtype=object),
            properties=json_objects(cols[5]),
            event_time_us=np.array(cols[6], dtype=np.int64) // 1000 * 1000,
        )

    def remove(self, app_id, channel_id=None) -> bool:
        conn = self._c.conn()
        conn.execute(
            "DELETE FROM events WHERE app_id=? AND channel_id=?",
            (app_id, _chan(channel_id)),
        )
        conn.commit()
        return True

    # -- PEvents ------------------------------------------------------------
    def write(self, events: Iterable[Event], app_id, channel_id=None) -> None:
        conn = self._c.conn()
        rows = [
            self._row(event.event_id or Event.new_event_id(), event, app_id,
                      channel_id)
            for event in events
        ]
        with bulk_cache(conn):
            conn.executemany(_EVENT_INSERT_SQL, rows)
            conn.commit()

    def delete_bulk(self, event_ids, app_id, channel_id=None) -> None:
        conn = self._c.conn()
        conn.executemany(
            "DELETE FROM events WHERE app_id=? AND channel_id=? AND id=?",
            [(app_id, _chan(channel_id), eid) for eid in event_ids],
        )
        conn.commit()

    def close(self) -> None:
        self._c.close()


# Shared facade mapping the bulk PEvents SPI onto the combined store.
SQLitePEvents = base.PEventsAdapter


class SQLiteApps(base.Apps):
    def __init__(self, client: SQLiteClient):
        self._c = client

    def insert(self, app: App) -> Optional[int]:
        conn = self._c.conn()
        try:
            if app.id:
                cur = conn.execute(
                    "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
            else:
                cur = conn.execute(
                    "INSERT INTO apps (name, description) VALUES (?,?)",
                    (app.name, app.description),
                )
            conn.commit()
            return cur.lastrowid if not app.id else app.id
        except sqlite3.IntegrityError:
            return None

    def get(self, app_id: int) -> Optional[App]:
        r = self._c.conn().execute(
            "SELECT id, name, description FROM apps WHERE id=?", (app_id,)
        ).fetchone()
        return App(*r) if r else None

    def get_by_name(self, name: str) -> Optional[App]:
        r = self._c.conn().execute(
            "SELECT id, name, description FROM apps WHERE name=?", (name,)
        ).fetchone()
        return App(*r) if r else None

    def get_all(self) -> List[App]:
        rows = self._c.conn().execute(
            "SELECT id, name, description FROM apps ORDER BY id"
        ).fetchall()
        return [App(*r) for r in rows]

    def update(self, app: App) -> bool:
        conn = self._c.conn()
        cur = conn.execute(
            "UPDATE apps SET name=?, description=? WHERE id=?",
            (app.name, app.description, app.id),
        )
        conn.commit()
        return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        conn = self._c.conn()
        cur = conn.execute("DELETE FROM apps WHERE id=?", (app_id,))
        conn.commit()
        return cur.rowcount > 0


class SQLiteAccessKeys(base.AccessKeys):
    def __init__(self, client: SQLiteClient):
        self._c = client

    def insert(self, access_key: AccessKey) -> Optional[str]:
        ak = access_key
        if not ak.key:
            ak = AccessKey.generate(ak.app_id, ak.events)
        conn = self._c.conn()
        try:
            conn.execute(
                "INSERT INTO access_keys VALUES (?,?,?)",
                (ak.key, ak.app_id, json.dumps(list(ak.events))),
            )
            conn.commit()
            return ak.key
        except sqlite3.IntegrityError:
            return None

    def _row(self, r) -> AccessKey:
        return AccessKey(r[0], r[1], tuple(json.loads(r[2])))

    def get(self, key: str) -> Optional[AccessKey]:
        r = self._c.conn().execute(
            "SELECT * FROM access_keys WHERE key=?", (key,)
        ).fetchone()
        return self._row(r) if r else None

    def get_all(self) -> List[AccessKey]:
        return [self._row(r) for r in self._c.conn().execute(
            "SELECT * FROM access_keys").fetchall()]

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [
            self._row(r)
            for r in self._c.conn()
            .execute("SELECT * FROM access_keys WHERE app_id=?", (app_id,))
            .fetchall()
        ]

    def update(self, access_key: AccessKey) -> bool:
        conn = self._c.conn()
        cur = conn.execute(
            "UPDATE access_keys SET app_id=?, events=? WHERE key=?",
            (access_key.app_id, json.dumps(list(access_key.events)), access_key.key),
        )
        conn.commit()
        return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        conn = self._c.conn()
        cur = conn.execute("DELETE FROM access_keys WHERE key=?", (key,))
        conn.commit()
        return cur.rowcount > 0


class SQLiteChannels(base.Channels):
    def __init__(self, client: SQLiteClient):
        self._c = client

    def insert(self, channel: Channel) -> Optional[int]:
        if not Channel.is_valid_name(channel.name):
            return None
        conn = self._c.conn()
        try:
            if channel.id:
                conn.execute(
                    "INSERT INTO channels (id, name, app_id) VALUES (?,?,?)",
                    (channel.id, channel.name, channel.app_id),
                )
                conn.commit()
                return channel.id
            cur = conn.execute(
                "INSERT INTO channels (name, app_id) VALUES (?,?)",
                (channel.name, channel.app_id),
            )
            conn.commit()
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, channel_id: int) -> Optional[Channel]:
        r = self._c.conn().execute(
            "SELECT id, name, app_id FROM channels WHERE id=?", (channel_id,)
        ).fetchone()
        return Channel(*r) if r else None

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        rows = self._c.conn().execute(
            "SELECT id, name, app_id FROM channels WHERE app_id=?", (app_id,)
        ).fetchall()
        return [Channel(*r) for r in rows]

    def delete(self, channel_id: int) -> bool:
        conn = self._c.conn()
        cur = conn.execute("DELETE FROM channels WHERE id=?", (channel_id,))
        conn.commit()
        return cur.rowcount > 0


class SQLiteEngineInstances(base.EngineInstances):
    def __init__(self, client: SQLiteClient):
        self._c = client

    def insert(self, instance: EngineInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        conn = self._c.conn()
        conn.execute(
            "INSERT OR REPLACE INTO engine_instances VALUES "
            "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                iid,
                instance.status,
                _to_us(instance.start_time),
                _to_us(instance.end_time),
                instance.engine_id,
                instance.engine_version,
                instance.engine_variant,
                instance.engine_factory,
                instance.batch,
                json.dumps(instance.env),
                json.dumps(instance.jax_conf),
                instance.data_source_params,
                instance.preparator_params,
                instance.algorithms_params,
                instance.serving_params,
            ),
        )
        conn.commit()
        return iid

    def _row(self, r) -> EngineInstance:
        return EngineInstance(
            id=r[0],
            status=r[1],
            start_time=_from_us(r[2]),
            end_time=_from_us(r[3]),
            engine_id=r[4],
            engine_version=r[5],
            engine_variant=r[6],
            engine_factory=r[7],
            batch=r[8],
            env=json.loads(r[9]),
            jax_conf=json.loads(r[10]),
            data_source_params=r[11],
            preparator_params=r[12],
            algorithms_params=r[13],
            serving_params=r[14],
        )

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        r = self._c.conn().execute(
            "SELECT * FROM engine_instances WHERE id=?", (instance_id,)
        ).fetchone()
        return self._row(r) if r else None

    def get_all(self) -> List[EngineInstance]:
        rows = self._c.conn().execute("SELECT * FROM engine_instances").fetchall()
        return [self._row(r) for r in rows]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self._c.conn().execute(
            "SELECT * FROM engine_instances WHERE status='COMPLETED' AND "
            "engine_id=? AND engine_version=? AND engine_variant=? "
            "ORDER BY start_time_us DESC",
            (engine_id, engine_version, engine_variant),
        ).fetchall()
        return [self._row(r) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, instance: EngineInstance) -> bool:
        if self.get(instance.id) is None:
            return False
        self.insert(instance)
        return True

    def delete(self, instance_id: str) -> bool:
        conn = self._c.conn()
        cur = conn.execute(
            "DELETE FROM engine_instances WHERE id=?", (instance_id,)
        )
        conn.commit()
        return cur.rowcount > 0


class SQLiteEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: SQLiteClient):
        self._c = client

    def insert(self, instance: EvaluationInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        conn = self._c.conn()
        conn.execute(
            "INSERT OR REPLACE INTO evaluation_instances VALUES "
            "(?,?,?,?,?,?,?,?,?,?,?)",
            (
                iid,
                instance.status,
                _to_us(instance.start_time),
                _to_us(instance.end_time),
                instance.evaluation_class,
                instance.engine_params_generator_class,
                instance.batch,
                json.dumps(instance.env),
                instance.evaluator_results,
                instance.evaluator_results_html,
                instance.evaluator_results_json,
            ),
        )
        conn.commit()
        return iid

    def _row(self, r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0],
            status=r[1],
            start_time=_from_us(r[2]),
            end_time=_from_us(r[3]),
            evaluation_class=r[4],
            engine_params_generator_class=r[5],
            batch=r[6],
            env=json.loads(r[7]),
            evaluator_results=r[8],
            evaluator_results_html=r[9],
            evaluator_results_json=r[10],
        )

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        r = self._c.conn().execute(
            "SELECT * FROM evaluation_instances WHERE id=?", (instance_id,)
        ).fetchone()
        return self._row(r) if r else None

    def get_all(self) -> List[EvaluationInstance]:
        rows = self._c.conn().execute(
            "SELECT * FROM evaluation_instances"
        ).fetchall()
        return [self._row(r) for r in rows]

    def get_completed(self) -> List[EvaluationInstance]:
        rows = self._c.conn().execute(
            "SELECT * FROM evaluation_instances WHERE status='COMPLETED' "
            "ORDER BY start_time_us DESC"
        ).fetchall()
        return [self._row(r) for r in rows]

    def update(self, instance: EvaluationInstance) -> bool:
        if self.get(instance.id) is None:
            return False
        self.insert(instance)
        return True

    def delete(self, instance_id: str) -> bool:
        conn = self._c.conn()
        cur = conn.execute(
            "DELETE FROM evaluation_instances WHERE id=?", (instance_id,)
        )
        conn.commit()
        return cur.rowcount > 0


class SQLiteModels(base.Models):
    def __init__(self, client: SQLiteClient):
        self._c = client

    def insert(self, model: Model) -> None:
        conn = self._c.conn()
        conn.execute(
            "INSERT OR REPLACE INTO models VALUES (?,?)", (model.id, model.models)
        )
        conn.commit()

    def get(self, model_id: str) -> Optional[Model]:
        r = self._c.conn().execute(
            "SELECT id, models FROM models WHERE id=?", (model_id,)
        ).fetchone()
        return Model(r[0], r[1]) if r else None

    def delete(self, model_id: str) -> bool:
        conn = self._c.conn()
        cur = conn.execute("DELETE FROM models WHERE id=?", (model_id,))
        conn.commit()
        return cur.rowcount > 0
