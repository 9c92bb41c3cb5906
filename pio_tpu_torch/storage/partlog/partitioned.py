"""PartitionedEventLog — hash-partitioned, replicated LEvents backend.

The scale-out event store: where the single-host
backends funnel every ingest through one fsync queue, this backend
hash-partitions events BY ENTITY ID (``crc32(entity_id) % N``) into N
independent segment logs (``partlog/segments.py``), each with its own
group committer — N concurrent fsync queues, N replication streams, and
a failover unit of one partition. The reference gets the same shape from
HBase region splits keyed on its rowkey design (SURVEY.md §2.3); here
the router is explicit and its topology is served at ``/storage.json``.

Records are JSON payloads in PEL2 CRC frames (``partlog/framing.py``):

- ``{"t": "ev", "a": app, "c": chan, "e": {event api dict}}``
- ``{"t": "del", "a": app, "c": chan, "id": event_id}`` — tombstone
- ``{"t": "rm", "a": app, "c": chan}`` — channel purge

Reads serve from an in-memory materialized view replayed from the logs
at open (last-write-wins by event id, tombstones subtract) — the same
read-your-writes contract as the memory backend, rebuilt from disk on
every reopen and on every promoted follower (``partlog/failover.py``).

Registry type: ``PIO_STORAGE_SOURCES_<N>_TYPE=partlog`` (+ ``_PATH``
dir). Knobs: ``PIO_TPU_PARTLOG_PARTITIONS`` (manifest wins on reopen),
``PIO_TPU_PARTLOG_SEGMENT_BYTES``, ``PIO_TPU_PARTLOG_REPLICAS``,
``PIO_TPU_REPL_MIN_ACKS``, ``PIO_TPU_REPL_ACK_TIMEOUT_S``, plus the
global ``PIO_TPU_DURABILITY`` matrix (docs/storage.md).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from pio_tpu_torch.utils import knobs
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event, _parse_time
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.durability import (
    IntervalSyncer, fsync_fileobj, mode, replace_durable,
)
from pio_tpu_torch.storage.memory import _match
from pio_tpu_torch.storage.partlog import compaction, framing, replication
from pio_tpu_torch.storage.partlog.segments import SegmentLog
from pio_tpu_torch.utils.timeutil import to_micros

PARTITIONS_VAR = "PIO_TPU_PARTLOG_PARTITIONS"
DEFAULT_PARTITIONS = 4
MANIFEST_NAME = "MANIFEST.json"


def partition_of(entity_id: str, partitions: int) -> int:
    """The partition router: stable hash of the entity id."""
    return zlib.crc32(entity_id.encode("utf-8")) % partitions


def _event_from_api(d: dict) -> Event:
    """Wire dict → Event WITHOUT validation: records were validated on
    their original ingest; replay must not reject what an older rule set
    accepted."""
    return Event(
        event=d["event"],
        entity_type=d["entityType"],
        entity_id=d["entityId"],
        target_entity_type=d.get("targetEntityType"),
        target_entity_id=d.get("targetEntityId"),
        properties=DataMap(d.get("properties") or {}),
        event_time=_parse_time(d.get("eventTime")),
        tags=tuple(d.get("tags") or ()),
        pr_id=d.get("prId"),
        event_id=d.get("eventId"),
        creation_time=_parse_time(d.get("creationTime")),
    )


class _View:
    """Materialized read state replayed from the partition logs.

    ``buckets[(app, chan)][event_id] = (partition, pseq, Event)`` where
    ``pseq`` is the record's 1-based index within its partition — the
    coordinate compaction watermarks are measured in."""

    def __init__(self):
        self.lock = threading.RLock()
        self.buckets: Dict[Tuple[int, Optional[int]], dict] = {}
        #: records applied per partition (the head pseq)
        self.pcounts: Dict[int, int] = {}

    def apply(self, rec: dict, k: int) -> None:
        with self.lock:
            pseq = self.pcounts.get(k, 0) + 1
            self.pcounts[k] = pseq
            key = (rec["a"], rec["c"])
            t = rec["t"]
            if t == "ev":
                e = _event_from_api(rec["e"])
                self.buckets.setdefault(key, {})[e.event_id] = (k, pseq, e)
            elif t == "del":
                self.buckets.setdefault(key, {}).pop(rec["id"], None)
            elif t == "rm":
                # partition-scoped: remove() fans one rm record into
                # EVERY partition, and each clears only the entries its
                # own partition contributed (collectively the N records
                # still clear the bucket). Replay walks partitions
                # sequentially, so a bucket-wide pop here would delete
                # events acked AFTER the purge that routed to a lower-
                # numbered partition — replayed first, then wiped by a
                # later partition's rm record.
                bucket = self.buckets.get(key)
                if bucket is not None:
                    for eid in [
                        eid for eid, row in bucket.items() if row[0] == k
                    ]:
                        del bucket[eid]
                    if not bucket:
                        self.buckets.pop(key, None)
            else:
                raise base.StorageError(
                    f"unknown partlog record type {t!r}"
                )


class _ProbeAll:
    """Duck-typed ``GroupCommitter`` for the event server's liveness
    probe (``_check_group_commit`` looks for a ``_gc`` attribute): a
    partitioned log has N commit locks, and ANY of them wedged means a
    slice of the keyspace can no longer ack."""

    def __init__(self, committers):
        self._committers = committers

    def probe(self, timeout: float = 0.5):
        for k, gc in enumerate(self._committers):
            ok, msg = gc.probe(timeout=timeout)
            if not ok:
                return False, f"partition {k}: {msg}"
        return True, (
            f"all {len(self._committers)} partition commit locks "
            "acquirable"
        )


class PartitionedEventLog(base.LEvents):
    """LEvents over N hash-partitioned segment logs (+ bulk methods the
    :class:`~pio_tpu_torch.storage.base.PEventsAdapter` maps onto PEvents)."""

    def __init__(self, root: str, partitions: Optional[int] = None):
        from pio_tpu_torch.storage.groupcommit import GroupCommitter

        self.root = root
        os.makedirs(root, exist_ok=True)
        self.partitions = self._load_or_init_manifest(partitions)
        self._syncer = IntervalSyncer()
        self._segs = [
            SegmentLog(
                os.path.join(root, f"p{k:03d}"),
                partition=k, syncer=self._syncer,
            )
            for k in range(self.partitions)
        ]
        self._view = _View()
        self._replay()
        # one committer per partition: N independent fsync queues. The
        # store label feeds the groupcommit failpoint, so chaos specs
        # target one leader with `groupcommit.flush.partlog-p0=crash`
        # or the whole router with `groupcommit.flush.partlog*=...`
        self._committers = [
            GroupCommitter(
                (lambda payloads, k=k: self._flush_partition(k, payloads)),
                store=f"partlog-p{k}",
            )
            for k in range(self.partitions)
        ]
        self._gc = _ProbeAll(self._committers)
        self._delete_lock = threading.RLock()
        self._snapshots: Dict[int, Optional[dict]] = {}
        addrs = replication.replica_addrs()
        self._replicator = (
            replication.Replicator(self, addrs) if addrs else None
        )

    # -- manifest ------------------------------------------------------------
    def _load_or_init_manifest(self, partitions: Optional[int]) -> int:
        path = os.path.join(self.root, MANIFEST_NAME)
        if os.path.exists(path):
            with open(path) as f:
                manifest = json.load(f)
            n = int(manifest["partitions"])
            # the manifest wins: repartitioning an existing root would
            # strand every record routed under the old N
            return n
        n = partitions if partitions is not None else knobs.knob_int(
            PARTITIONS_VAR
        )
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "partitions": n}, f)
            fsync_fileobj(f)
        replace_durable(tmp, path)
        return n

    # -- replay / view -------------------------------------------------------
    def _replay(self) -> None:
        for k, seg in enumerate(self._segs):
            for payload in seg.payloads():
                self._view.apply(json.loads(payload.decode()), k)

    # -- replication owner duck type ----------------------------------------
    def committed(self, k: int) -> int:
        return self._segs[k].committed

    def read_range(self, k: int, start: int, end: int) -> bytes:
        return self._segs[k].read_range(start, end)

    # -- encode --------------------------------------------------------------
    @staticmethod
    def _frame_rec(rec: dict) -> bytes:
        return framing.frame(
            json.dumps(rec, separators=(",", ":")).encode()
        )

    def _encode_event(self, event: Event, app_id: int,
                      channel_id) -> Tuple[str, dict, bytes]:
        eid = event.event_id or Event.new_event_id()
        e = event.with_event_id(eid)
        rec = {"t": "ev", "a": app_id, "c": channel_id,
               "e": e.to_api_dict()}
        return eid, rec, self._frame_rec(rec)

    # -- the partition flush (called by each GroupCommitter leader) ----------
    def _flush_partition(self, k: int, payloads) -> List[object]:
        """Append every payload's framed bytes in ONE write, gate on
        follower acks per the durability mode, then advance the view.
        Each payload is a GROUP ``[(result, rec_dict, framed), ...]`` —
        a single insert submits a one-member group, ``insert_batch``
        submits its whole per-partition slice as one payload — so EVERY
        write path serializes through the committer's commit lock and
        segment order always matches view order."""
        from pio_tpu_torch.storage.groupcommit import PartialFlushOutcome

        members = [m for group in payloads for m in group]
        blob = b"".join(framed for _, _, framed in members)
        _, end = self._segs[k].append(blob)
        ack_exc = None
        if self._replicator is not None:
            self._replicator.notify()
            if mode() == "commit":
                # an ack here means min_acks follower DISKS have the
                # bytes; a timeout must fail the WHOLE batch fast. The
                # blob is already on the leader's segment log, so the
                # committer's generic solo retry would re-append every
                # payload — PartialFlushOutcome assigns the error
                # verbatim instead (persisted-but-unacked is never
                # blind-retried).
                try:
                    self._replicator.wait_acked(k, end)
                except base.StorageError as exc:
                    ack_exc = exc
        # the view advances even when acks timed out: the bytes ARE on
        # the leader's disk and a reopen would replay them — the live
        # view and the segment chain must never disagree
        for _, rec, _ in members:
            self._view.apply(rec, k)
        if ack_exc is not None:
            raise PartialFlushOutcome([ack_exc] * len(payloads))
        return [
            [result for result, _, _ in group] for group in payloads
        ]

    # -- LEvents -------------------------------------------------------------
    def init_channel(self, app_id: int, channel_id=None) -> bool:
        return True  # partitions appear on first append

    def insert(self, event: Event, app_id: int, channel_id=None) -> str:
        eid, rec, framed = self._encode_event(event, app_id, channel_id)
        k = partition_of(rec["e"]["entityId"], self.partitions)
        return self._committers[k].submit([(eid, rec, framed)])[0]

    def insert_batch(self, events, app_id: int, channel_id=None):
        """Route the batch by partition, then ONE committer submit per
        partition touched — the whole per-partition slice is one group
        payload, so it lands as one append (the records are self-framed,
        so a concatenation is a valid append sequence — same contract as
        the eventlog backend) and cannot interleave with a concurrent
        committer-led flush on the same partition."""
        if not events:
            return []
        ids: List[str] = []
        groups: Dict[int, list] = {}
        for e in events:
            eid, rec, framed = self._encode_event(e, app_id, channel_id)
            ids.append(eid)
            k = partition_of(rec["e"]["entityId"], self.partitions)
            groups.setdefault(k, []).append((eid, rec, framed))
        for k, members in groups.items():
            self._committers[k].submit(members)
        return ids

    def get(self, event_id: str, app_id: int, channel_id=None):
        with self._view.lock:
            hit = self._view.buckets.get(
                (app_id, channel_id), {}
            ).get(event_id)
        return hit[2] if hit is not None else None

    def delete(self, event_id: str, app_id: int, channel_id=None) -> bool:
        # lock across check + tombstone so two concurrent deletes of one
        # id can't both observe it live (matches the other backends)
        with self._delete_lock:
            ev = self.get(event_id, app_id, channel_id)
            if ev is None:
                return False
            rec = {"t": "del", "a": app_id, "c": channel_id,
                   "id": event_id}
            k = partition_of(ev.entity_id, self.partitions)
            return self._committers[k].submit(
                [(True, rec, self._frame_rec(rec))]
            )[0]

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
        failpoint("partlog.scan")
        with self._view.lock:
            rows = list(
                self._view.buckets.get((app_id, channel_id), {}).values()
            )
        evs = [
            e for _, _, e in rows
            if _match(
                e, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )
        ]
        evs.sort(key=lambda e: e.event_time, reverse=reversed_order)
        if limit is not None and limit >= 0:
            evs = evs[:limit]
        return evs

    def remove(self, app_id: int, channel_id=None) -> bool:
        rec = {"t": "rm", "a": app_id, "c": channel_id}
        for k in range(self.partitions):
            self._committers[k].submit(
                [(True, rec, self._frame_rec(rec))]
            )
        return True

    # -- bulk methods (PEventsAdapter maps these onto PEvents) ---------------
    def write(self, events, app_id: int, channel_id=None) -> None:
        self.insert_batch(list(events), app_id, channel_id)

    def delete_bulk(self, event_ids, app_id: int, channel_id=None) -> None:
        """Blind bulk tombstones, batched per partition. A tombstone for
        an absent id is a no-op on read (last-write-wins), identical to
        the eventlog backend's contract."""
        groups: Dict[int, list] = {}
        with self._view.lock:
            bucket = self._view.buckets.get((app_id, channel_id), {})
            for eid in dict.fromkeys(event_ids):
                hit = bucket.get(eid)
                if hit is None:
                    continue
                rec = {"t": "del", "a": app_id, "c": channel_id,
                       "id": eid}
                k = partition_of(hit[2].entity_id, self.partitions)
                groups.setdefault(k, []).append(
                    (True, rec, self._frame_rec(rec))
                )
        for k, members in groups.items():
            self._committers[k].submit(members)

    # -- compaction / snapshot-aware aggregation -----------------------------
    def compact(self) -> Dict[int, int]:
        """Fold each partition's ``$set/$unset/$delete`` chains into a
        per-entity snapshot segment (manifest + sha256 — the model-blob
        verify-and-fallback discipline). Returns {partition: entities}.
        Serving continues throughout: the snapshot is written beside the
        segment chain and swapped in atomically."""
        failpoint("partlog.compact")
        out: Dict[int, int] = {}
        with self._view.lock:
            watermarks = dict(self._view.pcounts)
            per_part = self._special_events_by_partition()
        for k in range(self.partitions):
            watermark = watermarks.get(k, 0)
            entities = compaction.fold_entities(per_part.get(k, {}))
            compaction.write_snapshot(
                self._segs[k].pdir, partition=k,
                watermark=watermark, entities=entities,
            )
            self._snapshots.pop(k, None)  # re-verify on next read
            out[k] = len(entities)
        return out

    def _special_events_by_partition(self) -> Dict[int, dict]:
        """partition → {(app, chan, etype, eid): [(pseq, Event), ...]}
        for every special event in the view (caller holds the lock)."""
        from pio_tpu_torch.data.event import SPECIAL_EVENTS

        per: Dict[int, dict] = {}
        for (a, c), bucket in self._view.buckets.items():
            for k, pseq, e in bucket.values():
                if e.event in SPECIAL_EVENTS:
                    per.setdefault(k, {}).setdefault(
                        (a, c, e.entity_type, e.entity_id), []
                    ).append((pseq, e))
        return per

    def _snapshot(self, k: int) -> Optional[dict]:
        if k not in self._snapshots:
            self._snapshots[k] = compaction.load_snapshot(
                self._segs[k].pdir
            )
        return self._snapshots[k]

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id=None,
        start_time=None,
        until_time=None,
        required=None,
    ) -> dict:
        """Snapshot-aware fold: entities untouched since the compaction
        watermark come straight from the snapshot; entities with newer
        events resume the fold from the snapshot state; anything the
        snapshot cannot prove consistent (out-of-order suffix event,
        rewritten history, checksum mismatch) falls back to the exact
        full-history fold — correctness never rides the cache."""
        if start_time is not None or until_time is not None:
            # snapshots materialize the FULL-range fold only
            return super().aggregate_properties(
                app_id, entity_type, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                required=required,
            )
        snaps = {k: self._snapshot(k) for k in range(self.partitions)}
        if all(s is None for s in snaps.values()):
            return super().aggregate_properties(
                app_id, entity_type, channel_id=channel_id,
                required=required,
            )
        from pio_tpu_torch.data.event import SPECIAL_EVENTS

        with self._view.lock:
            by_entity: Dict[str, list] = {}
            bucket = self._view.buckets.get((app_id, channel_id), {})
            for k, pseq, e in bucket.values():
                if e.event in SPECIAL_EVENTS and e.entity_type == entity_type:
                    by_entity.setdefault(e.entity_id, []).append(
                        (k, pseq, e)
                    )
        out: dict = {}
        for eid, rows in by_entity.items():
            k = rows[0][0]
            pm = compaction.resume_fold(
                snaps[k], app_id, channel_id, entity_type, eid, rows,
            )
            if pm is not None:
                out[eid] = pm
        if required:
            req = set(required)
            out = {
                eid: pm for eid, pm in out.items()
                if req.issubset(pm.keys())
            }
        return out

    # -- topology ------------------------------------------------------------
    # pio: endpoint=/storage.json
    def topology(self) -> dict:
        """The ``/storage.json`` payload: router + per-partition stream
        state + replication positions."""
        parts = []
        for k, seg in enumerate(self._segs):
            with self._view.lock:
                records = self._view.pcounts.get(k, 0)
            snap = self._snapshot(k)
            parts.append({
                "partition": k,
                "committed_bytes": seg.committed,
                "records": records,
                "segments": seg.segments(),
                "snapshot_watermark": (
                    snap["watermark"] if snap else None
                ),
            })
        repl = None
        if self._replicator is not None:
            committed = {
                str(p["partition"]): p["committed_bytes"] for p in parts
            }
            followers = self._replicator.lag_snapshot()
            # per-follower lag and per-partition min-acked as
            # first-class fields — the fleet aggregator and its router
            # read the durable floor straight off /storage.json
            for f in followers:
                f["lag"] = {
                    k: max(committed.get(k, 0) - pos, 0)
                    for k, pos in (f.get("acked") or {}).items()
                }
            min_acked = {}
            for k in committed:
                acks = [
                    (f.get("acked") or {}).get(k)
                    for f in followers
                ]
                acks = [a for a in acks if a is not None]
                min_acked[k] = min(acks) if acks else None
            repl = {
                "replicas": [
                    link.label for link in self._replicator._links
                ],
                "min_acks": self._replicator.min_acks,
                "ack_timeout_s": self._replicator.ack_timeout_s,
                "followers": followers,
                "min_acked": min_acked,
            }
        return {
            "backend": "partlog",
            "role": "leader",
            "root": self.root,
            "partitions": self.partitions,
            "router": "crc32(entity_id) % partitions",
            "durability": mode(),
            "partition_detail": parts,
            "replication": repl,
        }

    def close(self) -> None:
        if self._replicator is not None:
            self._replicator.stop()
        for seg in self._segs:
            seg.close()
