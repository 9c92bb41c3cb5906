"""Event-log storage backend — native C++ scan over append-only logs.

The port's copy of ``pio_tpu/storage/eventlog.py`` (the port imports
nothing of ``pio_tpu``), over the port's own copy of the C++ library
(``pio_tpu_torch/native/event_log.cpp``, the same format: a log written by
either package is read by the other). The at-scale event store: one
append-only binary log per (app, channel) on local disk, with
filter/sort/tombstone done entirely in C++. Python only frames records on
write and materializes results on read — ``find_frame`` goes log →
columnar arenas → EventFrame with no per-record Python loop on the filter
path. Single inserts are group-committed (concurrent ingests coalesce
into one append a file); every write path fsyncs per
``PIO_TPU_DURABILITY`` (:class:`~pio_tpu_torch.storage.durability.IntervalSyncer`).

Failpoints, under the reference's names: ``eventlog.append.before_write``
(a torn write persists a prefix of the framed bytes and fails),
``eventlog.append.after_write``, ``eventlog.flush.before_write`` and
``eventlog.scan``.

Registry type: ``PIO_STORAGE_SOURCES_<N>_TYPE=eventlog`` (+ ``_PATH`` dir).
"""

from __future__ import annotations

import ctypes
import datetime as _dt
import json
import os
import struct
import threading
import uuid
import zlib
from typing import List, Optional, Sequence

import numpy as np

from pio_tpu_torch.analysis.runtime import make_lock, make_rlock
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.durability import IntervalSyncer
from pio_tpu_torch.storage.frame import EventFrame, json_objects
from pio_tpu_torch.utils.timeutil import from_micros as _from_us
from pio_tpu_torch.utils.timeutil import to_micros

_I64_MIN = -(2 ** 63)
_I64_MAX = 2 ** 63 - 1

#: one lock per log FILE (realpath), shared by every handle that touches
#: it: a scan racing an in-flight append would read a torn tail record and
#: report the log as corrupt. Per-file (not per-root) so a slow scan of one
#: app's log never blocks other apps. (Cross-process access is not
#: coordinated.)
_file_locks: dict = {}
_file_locks_guard = make_lock("eventlog.locks_guard")


def _column_strings(arena: bytes, offsets: list) -> list:
    """The strings of one scanned column: ``arena[offsets[k]:offsets[k+1]]``
    decoded, for each k. Unlike the reference (a decode a string), an
    all-ASCII arena is decoded once and sliced, its byte offsets being
    character offsets; the same strings."""
    n = len(offsets) - 1
    text = arena.decode()
    if len(text) == len(arena):
        return [text[offsets[k]:offsets[k + 1]] for k in range(n)]
    return [arena[offsets[k]:offsets[k + 1]].decode() for k in range(n)]


def _lock_for(path: str) -> threading.RLock:
    # re-entrant so delete() can hold it across its get + tombstone append
    key = os.path.realpath(path)
    with _file_locks_guard:
        return _file_locks.setdefault(key, make_rlock(f"eventlog.file:{key}"))


def _to_us(t: Optional[_dt.datetime], default: int) -> int:
    if t is None:
        return default
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return to_micros(t)


def _encode_record(
    flags: int,
    time_us: int,
    ctime_us: int,
    strings: Sequence[bytes],
) -> bytes:
    """Frame one record (see event_log.cpp layout)."""
    assert len(strings) == 9
    for s in strings[:8]:
        if len(s) > 0xFFFF:
            # StorageError, not ValueError: callers catch the SPI error
            # type, and other backends accept the same event
            raise base.StorageError(
                "event string field exceeds the event-log backend's "
                f"64 KiB limit ({len(s)} bytes)"
            )
        # NUL is unrepresentable in the C-ABI filter strings; rejecting it
        # at write time keeps read-side "NUL filter matches nothing" exact
        if flags == 0 and b"\0" in s:
            raise base.StorageError(
                "event string fields may not contain NUL bytes "
                "(event-log backend)"
            )
    header = struct.pack(
        "<Bqq8HI",
        flags,
        time_us,
        ctime_us,
        *(len(s) for s in strings[:8]),
        len(strings[8]),
    )
    payload = header + b"".join(strings)
    # PEL2 framing: length-prefix + payload + crc32 trailer. The crc is
    # what lets the scanner tell "plausible-length garbage at the tail"
    # (a torn write) from committed data — length checks alone can't.
    return (
        struct.pack("<I", len(payload))
        + payload
        + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
    )


class EventLogEvents(base.LEvents, base.PEvents):
    """LEvents + PEvents over per-(app, channel) native logs."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        from pio_tpu_torch.native import event_log_lib
        from pio_tpu_torch.storage.groupcommit import GroupCommitter

        self._lib = event_log_lib()
        self._repaired: set = set()  # paths torn-tail-checked this handle
        self._syncer = IntervalSyncer()  # durability knob: when to fsync
        # instance is registry-cached per root, so this coalesces across
        # concurrent requests (see insert())
        self._gc = GroupCommitter(self._flush_appends, store="eventlog")

    # -- files --------------------------------------------------------------
    def _path(self, app_id: int, channel_id=None) -> str:
        name = f"app_{app_id}"
        if channel_id is not None:
            name += f"_ch{channel_id}"
        return os.path.join(self.root, name + ".pel")

    def _append(self, app_id: int, channel_id, data: bytes) -> None:
        """Locked append; first append per path truncates any torn tail.

        Scans tolerate a torn tail (a crash mid-append), but an append
        after one would land behind unreachable bytes — so repair lazily,
        once per path per handle, before writing.
        """
        path = self._path(app_id, channel_id)
        with _lock_for(path):
            if path not in self._repaired:
                if int(self._lib.pel_repair(path.encode())) < 0:
                    raise base.StorageError(
                        f"event-log repair failed for app {app_id} ({path})"
                    )
                self._repaired.add(path)
            torn = failpoint("eventlog.append.before_write", data)
            if torn is not None:
                # injected torn write: persist only a prefix of the framed
                # bytes and fail — exactly the wound a crash mid-append
                # leaves, which the crc + repair pass must heal on reopen
                self._lib.pel_append(path.encode(), torn, len(torn), 0)
                self._repaired.discard(path)
                raise base.StorageError(
                    f"event-log append failed for app {app_id} "
                    "(injected torn write)"
                )
            sync = self._syncer.due(path)
            rc = self._lib.pel_append(
                path.encode(), data, len(data), 1 if sync else 0
            )
            if rc == 0:
                if sync:
                    self._syncer.mark(path)
                failpoint("eventlog.append.after_write")
            else:
                # a partial fwrite may have left a torn tail: force a
                # re-repair before the next append or later writes would
                # land behind unreachable bytes
                self._repaired.discard(path)
        if rc != 0:
            raise base.StorageError(
                f"event-log append failed for app {app_id}"
            )

    # -- LEvents ------------------------------------------------------------
    def init_channel(self, app_id: int, channel_id=None) -> bool:
        return True  # files appear on first append

    @staticmethod
    def _encode_event(event: Event) -> tuple:
        """→ (event_id, framed record bytes)."""
        event_id = event.event_id or uuid.uuid4().hex
        strings = [
            event_id.encode(),
            event.event.encode(),
            event.entity_type.encode(),
            event.entity_id.encode(),
            (event.target_entity_type or "").encode(),
            (event.target_entity_id or "").encode(),
            (event.pr_id or "").encode(),
            json.dumps(list(event.tags)).encode() if event.tags else b"[]",
            json.dumps(event.properties.to_dict()).encode(),
        ]
        return event_id, _encode_record(
            0,
            _to_us(event.event_time, 0),
            _to_us(event.creation_time, 0),
            strings,
        )

    def insert(self, event: Event, app_id: int, channel_id=None) -> str:
        """Single insert via GROUP COMMIT (storage/groupcommit.py):
        concurrent single-event ingests coalesce into one open/write/
        flush per (app, channel) log — the self-framed records make a
        concatenation a valid append sequence, exactly as insert_batch
        relies on."""
        event_id, rec = self._encode_event(event)
        return self._gc.submit((event_id, app_id, channel_id, rec))

    def _flush_appends(self, payloads):
        """Batched flush over possibly several (app, channel) log files.
        Appends to multiple files cannot be all-or-nothing, so a failed
        group reports per-payload outcomes (PartialFlushOutcome) instead
        of raising wholesale — a blind committer retry would re-append
        the groups that already landed (duplicates in an append-only
        log)."""
        from pio_tpu_torch.storage.groupcommit import PartialFlushOutcome

        failpoint("eventlog.flush.before_write")
        groups: dict = {}
        for k, (eid, app_id, channel_id, rec) in enumerate(payloads):
            groups.setdefault((app_id, channel_id), []).append((k, rec))
        outcomes: list = [None] * len(payloads)
        failed = False
        for (app_id, channel_id), members in groups.items():
            try:
                self._append(
                    app_id, channel_id, b"".join(r for _, r in members)
                )
                for k, _ in members:
                    outcomes[k] = payloads[k][0]
            except Exception as exc:
                failed = True
                for k, _ in members:
                    outcomes[k] = exc
        if failed:
            raise PartialFlushOutcome(outcomes)
        return outcomes

    def insert_batch(self, events, app_id: int, channel_id=None):
        """Frame every record and land them in ONE native append — a
        single open/write/flush of the log instead of one per event (the
        records are self-framed, so a concatenation IS a valid sequence
        of appends; the torn-tail repair contract is unchanged)."""
        if not events:
            return []
        ids, recs = [], []
        for e in events:
            eid, rec = self._encode_event(e)
            ids.append(eid)
            recs.append(rec)
        self._append(app_id, channel_id, b"".join(recs))
        return ids

    @staticmethod
    def _empty_columns() -> dict:
        cols: dict = {
            k: []
            for k in (
                "event_id", "event", "entity_type", "entity_id",
                "target_entity_type", "target_entity_id", "pr_id",
                "tags", "properties",
            )
        }
        cols["time_us"] = np.zeros(0, np.int64)
        cols["ctime_us"] = np.zeros(0, np.int64)
        return cols

    def _scan(
        self,
        app_id: int,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        event_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ):
        """Native scan → (columns dict of lists/arrays). Internal."""
        from pio_tpu_torch.native import PelResult

        names = None if event_names is None else list(event_names)
        if names is not None and not names:
            # [] = "match no event names" (SPI contract, same as the
            # sqlite/memory backends); only None means "any"
            return self._empty_columns()
        # "" is unrepresentable as a native filter (the C ABI uses "" for
        # "any"), and no stored event has an empty value in these fields
        # (validation requires them non-empty when present) — so an
        # explicit empty-string filter matches nothing, as on the other
        # backends.
        filters = (
            entity_type, entity_id, target_entity_type,
            target_entity_id, event_id,
        )
        if "" in filters or any(f and "\0" in f for f in filters):
            # "" and NUL are unrepresentable in the C ABI, and no stored
            # field is empty or NUL-containing (rejected on write) — so
            # these filters match nothing, as on the other backends
            return self._empty_columns()
        names = names or []
        if any("\0" in n for n in names):
            names = [n for n in names if "\0" not in n]
            if not names:
                return self._empty_columns()
        failpoint("eventlog.scan")
        packed = b"".join(n.encode() + b"\0" for n in names)
        res = PelResult()
        path = self._path(app_id, channel_id)
        with _lock_for(path):
            rc = self._lib.pel_scan(
                path.encode(),
                packed,
                len(names),
                (entity_type or "").encode(),
                (entity_id or "").encode(),
                (target_entity_type or "").encode(),
                (target_entity_id or "").encode(),
                (event_id or "").encode(),
                _to_us(start_time, _I64_MIN),
                _to_us(until_time, _I64_MAX),
                1 if reversed_order else 0,
                -1 if limit is None else int(limit),
                ctypes.byref(res),
            )
        if rc == -2:
            raise base.StorageError(
                f"corrupt event log for app {app_id} "
                f"({self._path(app_id, channel_id)})"
            )
        if rc == -3:
            raise base.StorageError(
                f"event-log scan result too large for app {app_id} "
                "(a string column exceeds 4 GiB; narrow the filters)"
            )
        if rc != 0:
            raise base.StorageError(
                f"event-log scan failed for app {app_id} (rc={rc})"
            )
        try:
            n = res.n
            time_us = np.ctypeslib.as_array(res.time_us, shape=(n,)).copy() \
                if n else np.zeros(0, np.int64)
            ctime_us = np.ctypeslib.as_array(
                res.ctime_us, shape=(n,)
            ).copy() if n else np.zeros(0, np.int64)
            cols = []
            for c in range(9):
                if n == 0:
                    cols.append([])
                    continue
                offs = np.ctypeslib.as_array(res.off[c], shape=(n + 1,))
                o = offs.tolist()  # Python ints: numpy scalars index slowly
                cols.append(_column_strings(
                    ctypes.string_at(res.arena[c], o[n]), o))
        finally:
            self._lib.pel_free_result(ctypes.byref(res))
        return {
            "event_id": cols[0],
            "event": cols[1],
            "entity_type": cols[2],
            "entity_id": cols[3],
            "target_entity_type": cols[4],
            "target_entity_id": cols[5],
            "pr_id": cols[6],
            "tags": cols[7],
            "properties": cols[8],
            "time_us": time_us,
            "ctime_us": ctime_us,
        }

    def _to_events(self, cols) -> List[Event]:
        out = []
        for k in range(len(cols["event_id"])):
            out.append(
                Event(
                    event=cols["event"][k],
                    entity_type=cols["entity_type"][k],
                    entity_id=cols["entity_id"][k],
                    target_entity_type=cols["target_entity_type"][k] or None,
                    target_entity_id=cols["target_entity_id"][k] or None,
                    properties=DataMap(json.loads(cols["properties"][k])),
                    event_time=_from_us(cols["time_us"][k]),
                    tags=tuple(json.loads(cols["tags"][k])),
                    pr_id=cols["pr_id"][k] or None,
                    event_id=cols["event_id"][k],
                    creation_time=_from_us(cols["ctime_us"][k]),
                )
            )
        return out

    def get(self, event_id: str, app_id: int, channel_id=None):
        evs = self._to_events(
            self._scan(app_id, channel_id, event_id=event_id, limit=1)
        )
        return evs[0] if evs else None

    def delete(self, event_id: str, app_id: int, channel_id=None) -> bool:
        # lock held across check + tombstone so two concurrent deletes of
        # the same id can't both observe it live and both return True
        # (matches the memory backend's atomic dict.pop)
        with _lock_for(self._path(app_id, channel_id)):
            if self.get(event_id, app_id, channel_id) is None:
                return False
            # tombstone: flags bit0; only the event_id field matters
            rec = _encode_record(
                1, 0, 0, [event_id.encode()] + [b""] * 8
            )
            self._append(app_id, channel_id, rec)
            return True

    def find(
        self,
        app_id: int,
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
        return self._to_events(
            self._scan(
                app_id,
                channel_id,
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
        )

    def remove(self, app_id: int, channel_id=None) -> bool:
        path = self._path(app_id, channel_id)
        with _lock_for(path):
            self._repaired.discard(path)
            try:
                os.remove(path)
            except FileNotFoundError:
                return False
        return True

    # -- PEvents ------------------------------------------------------------
    def find_frame(self, app_id, channel_id=None, **filters) -> EventFrame:
        cols = self._scan(app_id, channel_id, **filters)
        return EventFrame(
            event=np.array(cols["event"], dtype=object),
            entity_type=np.array(cols["entity_type"], dtype=object),
            entity_id=np.array(cols["entity_id"], dtype=object),
            target_entity_type=np.array(
                cols["target_entity_type"], dtype=object
            ),
            target_entity_id=np.array(
                cols["target_entity_id"], dtype=object
            ),
            properties=json_objects(cols["properties"]),
            event_time_us=cols["time_us"],
        )

    def write(self, events: Sequence[Event], app_id: int, channel_id=None):
        # bulk-import hot path: frame every record, ONE locked append
        recs = b"".join(
            self._encode_event(e)[1] for e in events
        )
        if recs:
            self._append(app_id, channel_id, recs)

    def delete_bulk(self, event_ids, app_id: int, channel_id=None) -> None:
        """Bulk tombstones (PEventsAdapter maps this to PEvents.delete).

        Blind: one batched append of a tombstone per requested id, no read.
        Under last-write-wins a tombstone for an absent or already-deleted
        id is a no-op on read, and any later insert of the id outranks it
        by sequence — identical observable behavior to a checked delete.
        """
        ids = list(dict.fromkeys(event_ids))
        if not ids:
            return
        recs = b"".join(
            _encode_record(1, 0, 0, [eid.encode()] + [b""] * 8)
            for eid in ids
        )
        self._append(app_id, channel_id, recs)

    def compact(self, app_id: int, channel_id=None) -> int:
        """Rewrite the log dropping tombstones and shadowed records;
        returns bytes reclaimed. Atomic (temp file + rename), safe to run
        while serving — in-process readers/writers are excluded by the
        per-file lock for the duration."""
        path = self._path(app_id, channel_id)
        with _lock_for(path):
            n = int(self._lib.pel_compact(path.encode()))
            if n > 0:
                # the REWRITTEN file has no torn tail by construction;
                # n <= 0 means the original (possibly torn) file is still
                # in place and the next append must keep its repair pass
                self._repaired.add(path)
        if n == -2:
            raise base.StorageError(f"corrupt event log for app {app_id}")
        if n < 0:
            raise base.StorageError(
                f"event-log compaction failed for app {app_id} (rc={n})"
            )
        return n

    def count(self, app_id: int, channel_id=None) -> int:
        path = self._path(app_id, channel_id)
        with _lock_for(path):
            n = int(self._lib.pel_count(path.encode()))
        if n == -2:
            raise base.StorageError(f"corrupt event log for app {app_id}")
        if n < 0:
            raise base.StorageError(
                f"event-log read failed for app {app_id} (rc={n})"
            )
        return n
