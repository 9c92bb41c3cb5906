"""Snapshot compaction: fold ``$set/$unset`` chains into entity state.

Training reads aggregate entity properties by replaying every special
event since the beginning of time (``data/aggregation.py``). Compaction
folds each partition's chains ONCE, up to a watermark (the partition's
record count at compaction time), into a per-entity snapshot segment:

    p003/snapshot.json            — the folded state
    p003/snapshot.manifest.json   — sha256 + watermark

written with the model-blob verify-and-fallback discipline: temp file +
fsync + durable rename, and a read that fails sha256 verification falls
back — loudly, with a counter — to the exact full-history fold.
Correctness never rides the cache:

- an entity with NO events past the watermark serves straight from the
  snapshot;
- an entity with newer events RESUMES the fold from snapshot state —
  valid only while the suffix stays in event-time order, so any suffix
  event older than the entity's folded ``max_t_us`` forces a full
  re-fold (``out_of_order``);
- a tombstone or overwrite that rewrote pre-watermark history is caught
  by the per-entity event count (``history_rewritten``) and also
  re-folds.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

from pio_tpu_torch.data.datamap import PropertyMap
from pio_tpu_torch.obs import REGISTRY
from pio_tpu_torch.storage.durability import fsync_fileobj, replace_durable
from pio_tpu_torch.utils.timeutil import from_micros, to_micros

log = logging.getLogger("pio_tpu_torch.partlog")

SNAPSHOT_NAME = "snapshot.json"
SNAPSHOT_MANIFEST_NAME = "snapshot.manifest.json"

_COMPACTIONS = REGISTRY.counter(
    "pio_tpu_partlog_compactions_total",
    "Snapshot compactions completed per partition",
    ("partition",),
)
_FALLBACKS = REGISTRY.counter(
    "pio_tpu_partlog_snapshot_fallback_total",
    "Aggregation reads that bypassed the snapshot, by cause",
    ("reason",),
)


class _FoldState:
    """Resumable twin of ``aggregation._PropState`` tracking the extra
    bookkeeping a snapshot needs (max folded event time, event count)."""

    __slots__ = ("fields", "first_us", "last_us", "max_t_us", "n")

    def __init__(self):
        self.fields: Optional[dict] = None
        self.first_us: Optional[int] = None
        self.last_us: Optional[int] = None
        self.max_t_us: Optional[int] = None
        self.n = 0

    @classmethod
    def from_entry(cls, entry: dict) -> "_FoldState":
        s = cls()
        s.fields = (
            dict(entry["fields"]) if entry["fields"] is not None else None
        )
        s.first_us = entry["first_us"]
        s.last_us = entry["last_us"]
        s.max_t_us = entry["max_t_us"]
        s.n = entry["n"]
        return s

    def step(self, e) -> None:
        t_us = to_micros(e.event_time)
        self.n += 1
        if self.max_t_us is None or t_us > self.max_t_us:
            self.max_t_us = t_us
        if e.event == "$set":
            if self.fields is None:
                self.fields = e.properties.to_dict()
                self.first_us = t_us
            else:
                self.fields.update(e.properties.to_dict())
            self.last_us = t_us
        elif e.event == "$unset":
            if self.fields is not None:
                for key in e.properties.keys():
                    self.fields.pop(key, None)
                self.last_us = t_us
        elif e.event == "$delete":
            self.fields = None
            self.first_us = None
            self.last_us = None

    def result(self) -> Optional[PropertyMap]:
        if self.fields is None:
            return None
        return PropertyMap(
            self.fields, from_micros(self.first_us),
            from_micros(self.last_us),
        )


def _fold(rows) -> _FoldState:
    """rows: [(pseq, Event)] in view order; fold in stable time order
    (identical ordering to ``aggregation.fold_properties``)."""
    state = _FoldState()
    for _, e in sorted(rows, key=lambda r: r[1].event_time):
        state.step(e)
    return state


def fold_entities(groups: Dict[Tuple, list]) -> List[dict]:
    """{(app, chan, etype, eid): [(pseq, Event)]} → snapshot entries.
    Entities whose folded state is deleted/never-set are kept (with
    ``fields: null``) so a resumed fold starts from the right state."""
    out = []
    for (a, c, et, ei), rows in groups.items():
        s = _fold(rows)
        out.append({
            "a": a, "c": c, "et": et, "ei": ei,
            "fields": s.fields, "first_us": s.first_us,
            "last_us": s.last_us, "max_t_us": s.max_t_us, "n": s.n,
        })
    return out


def write_snapshot(pdir: str, *, partition: int, watermark: int,
                   entities: List[dict]) -> None:
    """Durably write ``snapshot.json`` + its sha256 manifest."""
    body = json.dumps(
        {
            "version": 1,
            "partition": partition,
            "watermark": watermark,
            "entities": entities,
        },
        sort_keys=True, separators=(",", ":"),
    ).encode()
    digest = hashlib.sha256(body).hexdigest()
    path = os.path.join(pdir, SNAPSHOT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(body)
        fsync_fileobj(f)
    replace_durable(tmp, path)
    mpath = os.path.join(pdir, SNAPSHOT_MANIFEST_NAME)
    mtmp = mpath + ".tmp"
    with open(mtmp, "w") as f:
        json.dump({
            "version": 1,
            "sha256": digest,
            "watermark": watermark,
            "entities": len(entities),
        }, f)
        fsync_fileobj(f)
    replace_durable(mtmp, mpath)
    _COMPACTIONS.inc(partition=str(partition))


def load_snapshot(pdir: str) -> Optional[dict]:
    """Verified snapshot → ``{"watermark": int, "entities": {key: entry}}``
    or None (no snapshot, or one that fails verification — the latter is
    loud and counted, never silently served)."""
    mpath = os.path.join(pdir, SNAPSHOT_MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None  # cold: never compacted
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        with open(os.path.join(pdir, SNAPSHOT_NAME), "rb") as f:
            body = f.read()
    except (OSError, ValueError) as e:
        log.warning(
            "partlog snapshot in %s unreadable (%s); falling back to "
            "full-history fold", pdir, e,
        )
        _FALLBACKS.inc(reason="unreadable")
        return None
    if hashlib.sha256(body).hexdigest() != manifest.get("sha256"):
        log.warning(
            "partlog snapshot in %s fails sha256 verification; falling "
            "back to full-history fold", pdir,
        )
        _FALLBACKS.inc(reason="checksum")
        return None
    data = json.loads(body.decode())
    if data.get("watermark") != manifest.get("watermark"):
        log.warning(
            "partlog snapshot in %s disagrees with its manifest "
            "watermark; falling back to full-history fold", pdir,
        )
        _FALLBACKS.inc(reason="checksum")
        return None
    entities = {
        (e["a"], e["c"], e["et"], e["ei"]): e
        for e in data["entities"]
    }
    return {"watermark": data["watermark"], "entities": entities}


def resume_fold(snap: Optional[dict], app_id: int, channel_id,
                entity_type: str, entity_id: str,
                rows: list) -> Optional[PropertyMap]:
    """Fold one entity's special events using the snapshot when it can
    be proven consistent; exact full fold otherwise. ``rows`` is
    ``[(partition, pseq, Event)]`` in view order."""
    pairs = [(pseq, e) for _, pseq, e in rows]
    if snap is None:
        return _fold(pairs).result()
    wm = snap["watermark"]
    prefix = [p for p in pairs if p[0] <= wm]
    suffix = [p for p in pairs if p[0] > wm]
    entry = snap["entities"].get(
        (app_id, channel_id, entity_type, entity_id)
    )
    if entry is None:
        if prefix:
            # pre-watermark events the snapshot never saw: the snapshot
            # predates a rewrite it cannot represent
            _FALLBACKS.inc(reason="history_rewritten")
            return _fold(pairs).result()
        return _fold(suffix).result()  # entity born after the watermark
    if len(prefix) != entry["n"]:
        # a tombstone (or id overwrite) changed pre-watermark history
        _FALLBACKS.inc(reason="history_rewritten")
        return _fold(pairs).result()
    if entry["max_t_us"] is not None and any(
        to_micros(e.event_time) < entry["max_t_us"] for _, e in suffix
    ):
        # an out-of-order suffix event folds BEFORE snapshot state in
        # the exact ordering — resumption would be wrong
        _FALLBACKS.inc(reason="out_of_order")
        return _fold(pairs).result()
    state = _FoldState.from_entry(entry)
    for _, e in sorted(suffix, key=lambda p: p[1].event_time):
        state.step(e)
    return state.result()
