"""Searchable storage backend — the Elasticsearch analog.

The port's copy of ``pio_tpu/storage/searchable.py`` (the port imports
nothing of ``pio_tpu``), the same schema, FTS5 tables and triggers, so a
database written by either package is searched by the other. It keeps
searchability in-process: SQLite FTS5 (BM25-ranked, unicode tokenizer)
over the same file the relational tables live in — no network service,
the same SPI, one extra capability: ``search(...)`` on events, apps, and
run metadata.

Index maintenance is done by SQL **triggers**, not Python overrides, so
every write path (INSERT OR REPLACE upserts, bulk deletes, future verbs)
keeps the index consistent by construction. ``PRAGMA recursive_triggers``
is enabled per connection because REPLACE conflict resolution only fires
delete triggers with it on.

The indexed "body" of each row is a concatenation of its searchable
columns (including raw JSON text for properties/params — the FTS tokenizer
splits on punctuation, making JSON keys and values matchable terms).

Select it with::

    PIO_STORAGE_SOURCES_MYES_TYPE=searchable    # aliases: fts, elasticsearch
    PIO_STORAGE_SOURCES_MYES_PATH=/path/to/pio-search.db
"""

from __future__ import annotations

import sqlite3
from typing import List, Optional

from pio_tpu_torch.data.event import Event
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.records import App, EngineInstance, EvaluationInstance
from pio_tpu_torch.storage.sqlite import (
    _EVENT_INSERT_SQL,
    SQLiteApps,
    SQLiteClient,
    SQLiteEngineInstances,
    SQLiteEvaluationInstances,
    SQLiteEvents,
    _chan,
    _row_to_event,
    bulk_cache,
)

#: body expressions per indexed table (also used by the trigger DDL and
#: the one-time backfill — single home so they cannot diverge)
_BODY = {
    "events": (
        "coalesce({p}.event,'') || ' ' || coalesce({p}.entity_type,'') || "
        "' ' || coalesce({p}.entity_id,'') || ' ' || "
        "coalesce({p}.target_entity_type,'') || ' ' || "
        "coalesce({p}.target_entity_id,'') || ' ' || "
        "coalesce({p}.properties,'') || ' ' || coalesce({p}.tags,'')"
    ),
    "apps": "coalesce({p}.name,'') || ' ' || coalesce({p}.description,'')",
    "engine_instances": (
        "coalesce({p}.id,'') || ' ' || coalesce({p}.status,'') || ' ' || "
        "coalesce({p}.engine_id,'') || ' ' || "
        "coalesce({p}.engine_factory,'') || ' ' || "
        "coalesce({p}.engine_variant,'') || ' ' || "
        "coalesce({p}.data_source_params,'') || ' ' || "
        "coalesce({p}.algorithms_params,'') || ' ' || "
        "coalesce({p}.serving_params,'')"
    ),
    "evaluation_instances": (
        "coalesce({p}.id,'') || ' ' || coalesce({p}.status,'') || ' ' || "
        "coalesce({p}.evaluation_class,'') || ' ' || "
        "coalesce({p}.engine_params_generator_class,'') || ' ' || "
        "coalesce({p}.evaluator_results,'')"
    ),
}


def _fts_ddl(table: str) -> List[str]:
    body_new = _BODY[table].format(p="new")
    return [
        f"CREATE VIRTUAL TABLE IF NOT EXISTS {table}_fts USING fts5(body)",
        f"""CREATE TRIGGER IF NOT EXISTS {table}_fts_ai
            AFTER INSERT ON {table} BEGIN
              INSERT INTO {table}_fts(rowid, body)
              VALUES (new.rowid, {body_new});
            END""",
        f"""CREATE TRIGGER IF NOT EXISTS {table}_fts_ad
            AFTER DELETE ON {table} BEGIN
              DELETE FROM {table}_fts WHERE rowid = old.rowid;
            END""",
        f"""CREATE TRIGGER IF NOT EXISTS {table}_fts_au
            AFTER UPDATE ON {table} BEGIN
              DELETE FROM {table}_fts WHERE rowid = old.rowid;
              INSERT INTO {table}_fts(rowid, body)
              VALUES (new.rowid, {body_new});
            END""",
    ]


class SearchableClient(SQLiteClient):
    """SQLiteClient + FTS5 index tables and sync triggers."""

    def __init__(self, path: str):
        super().__init__(path)
        conn = self.conn()
        for table in _BODY:
            for stmt in _fts_ddl(table):
                conn.execute(stmt)
            # adopt an existing plain-sqlite file: two-way sync of rows
            # written (or deleted) while no index/triggers existed.
            # Count-guarded so the common already-indexed open skips the
            # O(n) scan; OR IGNORE so two processes racing the first
            # adoption can't collide on duplicate FTS rowids; the DELETE
            # clears stale entries so the counts converge instead of
            # rescanning forever. (Open the same file as `searchable`
            # everywhere — a plain-sqlite writer on the side bypasses the
            # triggers between opens.)
            n_rows, n_idx = conn.execute(
                f"SELECT (SELECT count(*) FROM {table}), "
                f"(SELECT count(*) FROM {table}_fts)"
            ).fetchone()
            if n_rows != n_idx:
                conn.execute(
                    f"DELETE FROM {table}_fts WHERE rowid NOT IN "
                    f"(SELECT rowid FROM {table})"
                )
                conn.execute(
                    f"INSERT OR IGNORE INTO {table}_fts(rowid, body) "
                    f"SELECT t.rowid, {_BODY[table].format(p='t')} "
                    f"FROM {table} t WHERE t.rowid NOT IN "
                    f"(SELECT rowid FROM {table}_fts)"
                )
        conn.commit()

    def conn(self) -> sqlite3.Connection:
        fresh = getattr(self._local, "conn", None) is None
        c = super().conn()
        if fresh:
            # REPLACE-resolution deletes only fire the _ad triggers with
            # this on; per-connection, so set once when the thread-local
            # connection is created (close() → recreate re-applies it)
            c.execute("PRAGMA recursive_triggers=ON")
        return c

    def rebuild_index(self) -> None:
        """Drop and refill every FTS table from its base table.

        The index is keyed on sqlite's implicit rowid for tables without
        an INTEGER PRIMARY KEY (events has a composite PK; the instance
        tables have TEXT PKs), and ``VACUUM`` may renumber implicit
        rowids — silently desyncing the index in a way the count-based
        adoption guard in ``__init__`` cannot detect (counts still
        match). Any out-of-band ``VACUUM`` of the database file must be
        followed by this call. Nothing in-tree vacuums; this is the
        recovery hook for operators who do.
        """
        conn = self.conn()
        for table in _BODY:
            conn.execute(f"DELETE FROM {table}_fts")
            conn.execute(
                f"INSERT INTO {table}_fts(rowid, body) "
                f"SELECT t.rowid, {_BODY[table].format(p='t')} "
                f"FROM {table} t"
            )
        conn.commit()


class SearchError(base.StorageError):
    """Malformed FTS query string (surfaced with the sqlite detail)."""


def _match(conn, table: str, query: str, where: str, args: tuple,
           limit: Optional[int]):
    sql = (
        f"SELECT t.* FROM {table} t JOIN {table}_fts f ON t.rowid = f.rowid "
        f"WHERE {table}_fts MATCH ? {where} ORDER BY bm25({table}_fts)"
    )
    params: list = [query, *args]
    if limit is not None and limit >= 0:
        sql += " LIMIT ?"
        params.append(limit)
    try:
        return conn.execute(sql, params).fetchall()
    except sqlite3.OperationalError as e:
        # MATCH-parse failures are the caller's fault — 'fts5: syntax
        # error' for malformed expressions, 'no such column' for ES-style
        # field:term filters naming a non-column. Locks and other
        # infrastructure errors must propagate unblamed.
        msg = str(e).lower()
        if "fts5" in msg or "no such column" in msg:
            raise SearchError(f"bad search query {query!r}: {e}") from e
        raise


class SearchableEvents(SQLiteEvents):
    """LEvents/PEvents + BM25 full-text search over event bodies."""

    def write(self, events, app_id, channel_id=None) -> None:
        """Bulk append, indexed in one pass (unlike the reference, whose
        insert trigger indexes a row at a time, about ten times the
        cost): in one transaction the insert trigger is dropped, the rows
        are written, their index rows are added by one ``INSERT ...
        SELECT`` of the trigger's own body, and the trigger is created
        again. The same rows and index; a failure rolls all of it back.
        A replaced row's old index row goes through the delete trigger,
        as on the per-row path."""
        chan = _chan(channel_id)
        rows = [self._row(e.event_id or Event.new_event_id(), e, app_id,
                          channel_id) for e in events]
        if not rows:
            return
        conn = self._c.conn()
        with bulk_cache(conn):
            conn.execute("BEGIN IMMEDIATE")
            try:
                conn.execute("DROP TRIGGER events_fts_ai")
                conn.executemany(_EVENT_INSERT_SQL, rows)
                conn.execute("CREATE TEMP TABLE IF NOT EXISTS bulk_ids "
                             "(id TEXT PRIMARY KEY)")
                conn.executemany("INSERT OR IGNORE INTO bulk_ids VALUES (?)",
                                 ((r[0],) for r in rows))
                conn.execute(
                    f"INSERT INTO events_fts(rowid, body) SELECT t.rowid, "
                    f"{_BODY['events'].format(p='t')} FROM bulk_ids b JOIN "
                    f"events t ON t.app_id = ? AND t.channel_id = ? AND "
                    f"t.id = b.id", (app_id, chan))
                conn.execute("DELETE FROM bulk_ids")
                conn.execute(_fts_ddl("events")[1])  # the insert trigger
                conn.commit()
            except BaseException:
                conn.rollback()
                raise

    def search(
        self,
        app_id: int,
        query: str,
        channel_id=None,
        limit: Optional[int] = None,
    ):
        """Events of one app/channel matching an FTS5 query string
        (terms, ``AND``/``OR``/``NOT``, ``"phrases"``, ``prefix*``),
        best BM25 rank first."""
        rows = _match(
            self._c.conn(), "events", query,
            "AND t.app_id = ? AND t.channel_id = ?",
            (app_id, _chan(channel_id)), limit,
        )
        return [_row_to_event(r) for r in rows]


class SearchableApps(SQLiteApps):
    def search(self, query: str, limit: Optional[int] = None) -> List[App]:
        rows = _match(self._c.conn(), "apps", query, "", (), limit)
        return [App(id=r[0], name=r[1], description=r[2]) for r in rows]


class SearchableEngineInstances(SQLiteEngineInstances):
    def search(
        self, query: str, limit: Optional[int] = None
    ) -> List[EngineInstance]:
        rows = _match(
            self._c.conn(), "engine_instances", query, "", (), limit
        )
        return [self._row(r) for r in rows]


class SearchableEvaluationInstances(SQLiteEvaluationInstances):
    def search(
        self, query: str, limit: Optional[int] = None
    ) -> List[EvaluationInstance]:
        rows = _match(
            self._c.conn(), "evaluation_instances", query, "", (), limit
        )
        return [self._row(r) for r in rows]
