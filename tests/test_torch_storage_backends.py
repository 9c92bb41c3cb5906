"""The port's event and model stores against the reference's: the native
event log, Parquet shards, the searchable SQLite + FTS5 store and the
content-addressed blob store, on the CPU at a small size.

- The same seeded events (fixed ids and creation times) written through
  each package's backend, each into its own directory or file, read back
  equal: ``find`` under every filter, ``find_frame`` (every column,
  ``event_time_us`` exact), ``count``, ``get``, ``delete``, ``compact``
  and ``search``.
- The on-disk formats cross-read both ways, and the event-log files are
  byte-identical; a v1 log that ``pel_repair`` upgrades, a torn tail, and
  the 64 KiB field limit behave alike.
- The blob store: the same object and ref keys and bytes, cross-read of a
  root, overwrite and delete garbage collection, and the blob daemon
  serving either package's client.
- ``IntervalSyncer`` and ``replace_durable`` under ``commit``, ``batch``
  and ``os``; the group committer's partial-flush outcome and ``probe``.
- The failpoints by name, and the registry's wiring of every type and
  alias against the reference's, ``partlog`` included.
- The recommendation template trained on the CPU from each store gives
  the memory store's factors bit for bit.
"""

import datetime as dt
import os
import struct

import numpy as np
import pyarrow.dataset as pa_ds
import pytest
import torch

from pio_tpu import faults as R
from pio_tpu.data.event import Event as JaxEvent
from pio_tpu.server.blob_server import create_blob_server as jax_blob_server
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.storage import blobstore as jblob
from pio_tpu.storage import durability as jdur
from pio_tpu.storage import eventlog as jlog
from pio_tpu.storage import parquet as jpq
from pio_tpu.storage import records as jrec
from pio_tpu.storage import searchable as jsearch
from pio_tpu.storage.base import PEventsAdapter as JaxPEventsAdapter
from pio_tpu.storage.base import StorageError as JaxStorageError
from pio_tpu_torch import faults as F
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.blob_server import create_blob_server
from pio_tpu_torch.storage import blobstore as tblob
from pio_tpu_torch.storage import durability as tdur
from pio_tpu_torch.storage import eventlog as tlog
from pio_tpu_torch.storage import parquet as tpq
from pio_tpu_torch.storage import records as trec
from pio_tpu_torch.storage import searchable as tsearch
from pio_tpu_torch.storage.base import PEventsAdapter, StorageError
from pio_tpu_torch.storage.groupcommit import (
    FlushProtocolError,
    GroupCommitter,
    PartialFlushOutcome,
)
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance, run_train
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
APP = 3
FRAME_COLS = ("event", "entity_type", "entity_id", "target_entity_type",
              "target_entity_id")


def api_events(seed=0, n=60):
    """Wire-format events from a seed: rates, views and ``$set`` over a
    few users and items, tags, two events that share a time; ids and
    creation times fixed, so that both packages store the same bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = str(rng.choice(["rate", "view", "$set"], p=[0.5, 0.3, 0.2]))
        d = {"eventId": f"e{k:03d}", "event": kind, "entityType": "user",
             "entityId": f"u{int(rng.integers(6))}",
             "eventTime": (T0 + dt.timedelta(
                 seconds=k if k != 11 else 10,
                 microseconds=int(rng.integers(1000)))).isoformat(),
             "creationTime": (T0 + dt.timedelta(days=1)).isoformat()}
        if kind != "$set":
            d["targetEntityType"] = "item"
            d["targetEntityId"] = f"i{int(rng.integers(5))}"
            if kind == "rate":
                d["properties"] = {"rating": float(rng.integers(1, 6)),
                                   "note": f"good w{k % 4}"}
            d["tags"] = ["web"] if rng.random() < 0.3 else []
        else:
            d["properties"] = {"plan": str(rng.choice(["gold", "basic"]))}
        out.append(d)
    return out


def both(api):
    return ([JaxEvent.from_api_dict(d) for d in api],
            [Event.from_api_dict(d) for d in api])


def dicts(events):
    return [e.to_api_dict() for e in events]


def same_frame(a, b):
    for c in FRAME_COLS:
        assert list(getattr(a, c)) == list(getattr(b, c)), c
    assert a.event_time_us.dtype == b.event_time_us.dtype == np.int64
    np.testing.assert_array_equal(a.event_time_us, b.event_time_us)
    assert list(a.properties) == list(b.properties)


#: the read filters every store is asked, as find(**kw) / find_frame(**kw)
FILTERS = [
    {},
    {"entity_type": "user", "entity_id": "u2"},
    {"event_names": ["rate"]},
    {"event_names": []},
    {"event_names": ["rate", "view"], "target_entity_id": "i3"},
    {"target_entity_type": "item"},
    {"start_time": T0 + dt.timedelta(seconds=10),
     "until_time": T0 + dt.timedelta(seconds=30)},
    {"entity_id": ""},
]


# ------------------------------------------------------------ the event log
@pytest.fixture()
def logs(tmp_path):
    return jlog.EventLogEvents(str(tmp_path / "ref")), \
        tlog.EventLogEvents(str(tmp_path / "port"))


def write_logs(jl, tl, api, channel_id=None):
    """Each store's three write paths: single inserts (group commit), one
    batch insert, and the bulk write."""
    a, b = len(api) // 3, 2 * len(api) // 3
    for store, evs in zip((jl, tl), both(api)):
        for e in evs[:a]:
            store.insert(e, APP, channel_id)
        store.insert_batch(evs[a:b], APP, channel_id)
        store.write(evs[b:], APP, channel_id)


def log_bytes(store, channel_id=None):
    with open(store._path(APP, channel_id), "rb") as f:
        return f.read()


def test_event_log_reads_match_reference(logs):
    jl, tl = logs
    write_logs(jl, tl, api_events())
    write_logs(jl, tl, [dict(d, eventId="c" + d["eventId"])
                        for d in api_events(1, 12)], channel_id=5)
    for kw in FILTERS:
        for rev in (False, True):
            for limit in (None, 7):
                got = tl.find(APP, reversed_order=rev, limit=limit, **kw)
                want = jl.find(APP, reversed_order=rev, limit=limit, **kw)
                assert dicts(got) == dicts(want), (kw, rev, limit)
        same_frame(tl.find_frame(APP, **kw), jl.find_frame(APP, **kw))
    assert dicts(tl.find(APP, channel_id=5)) == dicts(jl.find(APP, channel_id=5))
    assert tl.count(APP) == jl.count(APP) == 60
    assert tl.get("e007", APP).to_api_dict() == jl.get("e007", APP).to_api_dict()
    assert tl.get("e007", APP, 5) is None and jl.get("e007", APP, 5) is None
    # delete tombstones, delete_bulk, an upsert, then compact
    assert tl.delete("e007", APP) and jl.delete("e007", APP)
    assert not tl.delete("e007", APP) and not jl.delete("e007", APP)
    tl.delete_bulk(["e001", "e002", "nope", "e001"], APP)
    jl.delete_bulk(["e001", "e002", "nope", "e001"], APP)
    up = dict(api_events()[5], properties={"rating": 1.0})
    tl.insert(Event.from_api_dict(up), APP)
    jl.insert(JaxEvent.from_api_dict(up), APP)
    assert tl.count(APP) == jl.count(APP) == 57
    assert log_bytes(tl) == log_bytes(jl)
    assert tl.compact(APP) == jl.compact(APP) > 0
    assert tl.compact(APP) == jl.compact(APP) == 0
    assert log_bytes(tl) == log_bytes(jl)
    assert dicts(tl.find(APP)) == dicts(jl.find(APP))
    same_frame(tl.find_frame(APP), jl.find_frame(APP))
    # PEvents through the adapter, as the registry builds it
    assert dicts(PEventsAdapter(tl).find(APP)) == \
        dicts(JaxPEventsAdapter(jl).find(APP))
    same_frame(PEventsAdapter(tl).find_frame(APP, event_names=["rate"]),
               JaxPEventsAdapter(jl).find_frame(APP, event_names=["rate"]))
    assert tl.remove(APP) and jl.remove(APP)
    assert tl.count(APP) == jl.count(APP) == 0


def test_event_logs_cross_read_and_are_byte_identical(logs, tmp_path):
    jl, tl = logs
    write_logs(jl, tl, api_events(2))
    assert log_bytes(tl) == log_bytes(jl)
    # each package reads the other's directory
    tl_on_ref = tlog.EventLogEvents(jl.root)
    jl_on_port = jlog.EventLogEvents(tl.root)
    assert dicts(tl_on_ref.find(APP)) == dicts(jl.find(APP))
    assert dicts(jl_on_port.find(APP)) == dicts(tl.find(APP))
    same_frame(tl_on_ref.find_frame(APP), jl.find_frame(APP))
    # and appends to it in the other's format
    extra = api_events(3, 5)
    tl_on_ref.write([Event.from_api_dict(d) for d in extra], APP)
    jl_on_port.write([JaxEvent.from_api_dict(d) for d in extra], APP)
    assert log_bytes(tl) == log_bytes(jl)


def v1_log(path, api):
    """A v1 log ("PEL1" magic, records without a crc) of these events, as
    an older build wrote it."""
    blob = b"PEL1\0\0\0\0"
    for e in (JaxEvent.from_api_dict(d) for d in api):
        rec = jlog.EventLogEvents._encode_event(e)[1]
        (plen,) = struct.unpack("<I", rec[:4])
        blob += rec[:4 + plen]  # drop the crc trailer
    with open(path, "wb") as f:
        f.write(blob)


def test_v1_log_upgrade_and_torn_tail_match_reference(logs):
    jl, tl = logs
    api = api_events(4, 20)
    for store in (jl, tl):
        v1_log(store._path(APP), api[:15])
        assert store.count(APP) == 15  # v1 stays readable
    assert dicts(tl.find(APP)) == dicts(jl.find(APP))
    # the first append repairs: the v1 file becomes v2, then appends
    write_logs(jl, tl, api[15:])
    assert log_bytes(tl)[:4] == b"PEL2" and log_bytes(tl) == log_bytes(jl)
    # a torn tail (a prefix of a framed record) is skipped on read and
    # truncated by the next append's repair
    torn = tlog.EventLogEvents._encode_event(
        Event.from_api_dict(api_events(5, 1)[0]))[1][:23]
    for store in (jl, tl):
        with open(store._path(APP), "ab") as f:
            f.write(torn)
        assert store.count(APP) == 20
    assert log_bytes(tl) == log_bytes(jl)
    fresh_t, fresh_j = tlog.EventLogEvents(tl.root), jlog.EventLogEvents(jl.root)
    fresh_t.write([Event.from_api_dict(api[0])], APP)
    fresh_j.write([JaxEvent.from_api_dict(api[0])], APP)
    assert log_bytes(tl) == log_bytes(jl)
    assert tl.count(APP) == jl.count(APP) == 20  # the upsert replaced e000


def test_field_limit_and_corruption_raise_like_the_reference(logs):
    jl, tl = logs
    big = dict(api_events()[0], entityId="u" * 0x10000)
    for store, cls, err in ((jl, JaxEvent, JaxStorageError),
                            (tl, Event, StorageError)):
        with pytest.raises(err, match="64 KiB"):
            store.insert(cls.from_api_dict(big), APP)
        ok = dict(big, entityId="u" * 0xFFFF)
        store.write([cls.from_api_dict(ok)], APP)
        assert store.get("e000", APP).entity_id == "u" * 0xFFFF
        with open(store._path(APP), "r+b") as f:  # garble the magic
            f.write(b"XXXX")
        with pytest.raises(err, match="corrupt"):
            store.find(APP)


# ------------------------------------------------------------- parquet
def test_parquet_reads_match_reference_and_cross_read(tmp_path):
    jp, tp = jpq.ParquetPEvents(str(tmp_path / "ref")), \
        tpq.ParquetPEvents(str(tmp_path / "port"))
    api = api_events(6)
    for store, evs in zip((jp, tp), both(api)):
        store.write(evs[:30], APP)
        store.write(evs[30:], APP)
        store.write(evs[:5], APP, 2)
    # an empty event_names and an empty string are the event log's edge
    # filters; pyarrow refuses an empty isin() in both packages
    for kw in FILTERS[:3] + FILTERS[4:-1]:
        assert dicts(tp.find(APP, **kw)) == dicts(jp.find(APP, **kw)), kw
        same_frame(tp.find_frame(APP, **kw), jp.find_frame(APP, **kw))
    assert dicts(tp.find(APP, 2)) == dicts(jp.find(APP, 2))
    # the shards hold the same rows under the same schema
    def table(root, app=APP):
        return pa_ds.dataset(os.path.join(root, f"app_{app}", "channel_0"),
                             format="parquet").to_table().sort_by("id")
    assert table(tp.root).equals(table(jp.root))
    # each package reads the other's directory
    assert dicts(tpq.ParquetPEvents(jp.root).find(APP)) == dicts(jp.find(APP))
    assert dicts(jpq.ParquetPEvents(tp.root).find(APP)) == dicts(tp.find(APP))
    # bulk delete and compaction
    tp.delete(["e003", "e040", "nope"], APP)
    jp.delete(["e003", "e040", "nope"], APP)
    tp.write([Event.from_api_dict(api[3])], APP)
    jp.write([JaxEvent.from_api_dict(api[3])], APP)
    assert len(os.listdir(tp._dir(APP, None))) == 2
    tp.compact(APP)
    jp.compact(APP)
    assert len(os.listdir(tp._dir(APP, None))) == 1
    assert dicts(tp.find(APP)) == dicts(jp.find(APP))
    assert len(tp.find(APP)) == 59
    assert tp.find(7) == [] and len(tp.find_frame(7)) == 0


# ------------------------------------------------------------ searchable
SEARCHES = ["gold", "rate", "good AND w1", "web OR basic", '"good w2"',
            "i3*", "u1 NOT rate"]


def test_searchable_store_matches_reference_and_cross_reads(tmp_path):
    jc = jsearch.SearchableClient(str(tmp_path / "ref.db"))
    tc = tsearch.SearchableClient(str(tmp_path / "port.db"))
    je, te = jsearch.SearchableEvents(jc), tsearch.SearchableEvents(tc)
    api = api_events(7)
    for store, evs in zip((je, te), both(api)):
        for e in evs[:10]:
            store.insert(e, APP)
        store.write(evs[10:], APP)
        store.delete("e004", APP)
    # an upsert through the bulk write replaces the row and its index row;
    # a single insert after it is indexed by the insert trigger
    up = dict(api[3], properties={"note": "zircon"})
    late = dict(api[0], eventId="late", properties={"note": "zircon late"})
    for store, cls in ((je, JaxEvent), (te, Event)):
        store.write([cls.from_api_dict(up)], APP)
        store.insert(cls.from_api_dict(late), APP)
    assert [e.event_id for e in te.search(APP, "zircon")] == \
        [e.event_id for e in je.search(APP, "zircon")] and \
        sorted(e.event_id for e in te.search(APP, "zircon")) == ["e003", "late"]
    # a bulk write that fails inside its transaction (a NOT NULL column)
    # leaves the rows, the index and the trigger as they were
    bad = Event.from_api_dict(dict(api[6], eventId="bad"))
    object.__setattr__(bad, "event", None)
    with pytest.raises(Exception, match="NOT NULL"):
        te.write([Event.from_api_dict(dict(api[5], eventId="new")), bad], APP)
    assert len(te.find(APP)) == len(je.find(APP))
    assert tc.conn().execute("SELECT count(*) FROM sqlite_master WHERE "
                             "name = 'events_fts_ai'").fetchone() == (1,)
    assert dicts(te.find(APP)) == dicts(je.find(APP))
    for q in SEARCHES:
        for limit in (None, 3):
            got = te.search(APP, q, limit=limit)
            assert dicts(got) == dicts(je.search(APP, q, limit=limit)), q
    assert len(te.search(APP, "gold")) > 0
    with pytest.raises(tsearch.SearchError):
        te.search(APP, "gold AND")
    with pytest.raises(tsearch.SearchError):
        te.search(APP, "nosuchcolumn:x")
    # metadata search
    for c, rec, mod in ((jc, jrec, jsearch), (tc, trec, tsearch)):
        apps = mod.SearchableApps(c)
        apps.insert(rec.App(0, "shop", "sells gold rings"))
        apps.insert(rec.App(0, "blog", "posts"))
    assert [a.name for a in tsearch.SearchableApps(tc).search("gold")] == \
        [a.name for a in jsearch.SearchableApps(jc).search("gold")] == ["shop"]
    # each package searches the other's file; the rebuilt index agrees
    cross_t = tsearch.SearchableEvents(tsearch.SearchableClient(jc.path))
    cross_j = jsearch.SearchableEvents(jsearch.SearchableClient(tc.path))
    for q in SEARCHES:
        assert dicts(cross_t.search(APP, q)) == dicts(je.search(APP, q))
        assert dicts(cross_j.search(APP, q)) == dicts(te.search(APP, q))
    tc.rebuild_index()
    assert dicts(te.search(APP, "gold")) == dicts(je.search(APP, "gold"))


# ------------------------------------------------------------------ blobs
def blob_keys(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def blob_script(models, rec):
    """Insert, dedupe, overwrite (the old object collected), delete."""
    models.insert(rec.Model("m/1", b"alpha"))
    models.insert(rec.Model("m_1", b"alpha"))  # same bytes: one object
    models.insert(rec.Model("m2", b"beta"))
    models.insert(rec.Model("m2", b"gamma"))  # beta is collected
    assert models.delete("m_1") and not models.delete("nope")


def test_blob_roots_match_reference_and_cross_read(tmp_path):
    jm = jblob.BlobModels(jblob.open_blob_backend(f"file://{tmp_path}/ref"))
    tm = tblob.BlobModels(tblob.open_blob_backend(f"file://{tmp_path}/port"))
    blob_script(jm, jrec)
    blob_script(tm, trec)
    assert blob_keys(tmp_path / "port") == blob_keys(tmp_path / "ref")
    assert len(blob_keys(tmp_path / "port")) == 4  # 2 refs, 2 objects
    cross = tblob.BlobModels(tblob.open_blob_backend(str(tmp_path / "ref")))
    assert cross.get("m/1").models == b"alpha" and cross.get("m_1") is None
    back = jblob.BlobModels(jblob.open_blob_backend(str(tmp_path / "port")))
    assert back.get("m2").models == b"gamma"
    # a corrupt object is an error, not a wrong model
    obj = next(k for k in blob_keys(tmp_path / "port") if "objects" in k)
    with open(tmp_path / "port" / obj, "wb") as f:
        f.write(b"tampered")
    with pytest.raises(StorageError, match="digest mismatch|missing"):
        for mid in ("m/1", "m2"):
            tm.get(mid)
    with pytest.raises(StorageError, match="escapes the root"):
        tm._b.get("../x")
    with pytest.raises(StorageError, match="no blob backend"):
        tblob.open_blob_backend("gs://bucket/p")
    tblob.register_blob_scheme("mem", lambda loc: tblob.FileBlobBackend(
        str(tmp_path / "mem" / loc)))
    assert isinstance(tblob.open_blob_backend("mem://x"), tblob.FileBlobBackend)


@pytest.mark.parametrize("server", ["port", "ref"])
def test_blob_daemon_serves_either_client(tmp_path, server):
    make = create_blob_server if server == "port" else jax_blob_server
    srv = make(str(tmp_path / "root"), host="127.0.0.1", port=0,
               access_key="sekret")
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}?accessKey=sekret"
        for blob, rec in ((tblob, trec), (jblob, jrec)):
            models = blob.BlobModels(blob.open_blob_backend(url))
            payload = os.urandom(3 << 20)  # above the 1 MiB read chunk
            models.insert(rec.Model("run-1", payload))
            assert models.get("run-1").models == payload
            assert models.get("absent") is None
            assert models.delete("run-1") and models.get("run-1") is None
        wrong = tblob.HTTPBlobBackend(f"http://127.0.0.1:{srv.port}",
                                      access_key="bad")
        with pytest.raises(StorageError, match="HTTP 401"):
            wrong.put("k", b"x")
        assert not os.path.exists(tmp_path / "root" / "k")
    finally:
        srv.stop()


# ---------------------------------------------------------- durability
@pytest.mark.parametrize("mode", ["commit", "batch", "os"])
def test_durability_helpers_match_reference(monkeypatch, tmp_path, mode):
    monkeypatch.setenv("PIO_TPU_DURABILITY", mode)
    syncs = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: syncs.append(fd) or real(fd))
    counts = {}
    for name, dur in (("port", tdur), ("ref", jdur)):
        del syncs[:]
        s = dur.IntervalSyncer(interval_s=3600.0)
        seen = [s.due("a")]
        s.mark("a")
        seen += [s.due("a"), s.due("b")]
        tmp = tmp_path / f"{name}.tmp"
        with open(tmp, "wb") as f:
            f.write(b"x")
            dur.fsync_fileobj(f)
        dur.replace_durable(str(tmp), str(tmp_path / name))
        counts[name] = (seen, len(syncs))
        assert (tmp_path / name).read_bytes() == b"x" and not tmp.exists()
    assert counts["port"] == counts["ref"]
    want = {"commit": [True, True, True], "batch": [True, False, True],
            "os": [False, False, False]}[mode]
    assert counts["port"] == (want, 0 if mode == "os" else 2)
    assert tdur.BATCH_SYNC_INTERVAL_S == jdur.BATCH_SYNC_INTERVAL_S
    monkeypatch.setenv("PIO_TPU_DURABILITY", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        tdur.mode()


def test_group_committer_partial_outcomes_and_probe():
    landed = []

    def flush(payloads):
        out = []
        for p in payloads:
            if p == "bad":
                out.append(StorageError("bad payload"))
            else:
                landed.append(p)
                out.append(p.upper())
        if any(isinstance(o, Exception) for o in out):
            raise PartialFlushOutcome(out)
        return out

    gc = GroupCommitter(flush, store="t")
    assert gc.submit("a") == "A"
    with pytest.raises(StorageError, match="bad payload"):
        gc.submit("bad")
    assert landed == ["a"]  # no blind retry of a partial flush
    short = GroupCommitter(lambda ps: [1] * (len(ps) - 1) or iter(()),
                           store="s")
    with pytest.raises(FlushProtocolError):
        short.submit("x")
    assert gc.probe(timeout=0.01) == (True, "commit lock acquirable")
    gc._commit_lock.acquire()
    try:
        ok, msg = gc.probe(timeout=0.01)
        assert not ok and "commit lock held" in msg
    finally:
        gc._commit_lock.release()


# ----------------------------------------------------------- failpoints
@pytest.fixture()
def armed():
    yield lambda spec: (F.install(spec), R.install(spec))
    F.uninstall()
    R.uninstall()


def test_event_log_failpoints_match_reference(logs, armed):
    jl, tl = logs
    api = api_events(8, 6)
    write_logs(jl, tl, api[:3])
    pairs = ((jl, JaxEvent, JaxStorageError, R.FaultInjected),
             (tl, Event, StorageError, F.FaultInjected))
    armed("eventlog.append.before_write=torn-write:once")
    for store, cls, serr, _ in pairs:
        with pytest.raises(serr, match="injected torn write"):
            store.write([cls.from_api_dict(api[3])], APP)
        assert store.count(APP) == 3  # the torn prefix is not a record
    armed("eventlog.flush.before_write=error:once")
    for store, cls, _, _ in pairs:
        # the batched flush fails once; the committer's solo retry lands it
        assert store.insert(cls.from_api_dict(api[4]), APP) == "e004"
    assert (F.trigger_counts()[("eventlog.flush.before_write", "error")] ==
            R.trigger_counts()[("eventlog.flush.before_write", "error")] == 1)
    armed("eventlog.append.after_write=error:once")
    for store, cls, _, ferr in pairs:
        with pytest.raises(ferr):  # the bytes landed before the fault
            store.write([cls.from_api_dict(api[5])], APP)
    armed("eventlog.scan=error:once")
    for store, _, _, ferr in pairs:
        with pytest.raises(ferr):
            store.find(APP)
    assert (F.trigger_counts()[("eventlog.scan", "error")] ==
            R.trigger_counts()[("eventlog.scan", "error")] == 1)
    F.uninstall()
    R.uninstall()
    assert log_bytes(tl) == log_bytes(jl)
    assert dicts(tl.find(APP)) == dicts(jl.find(APP))
    assert tl.count(APP) == 5  # api[:3], the retried insert, api[5]


def test_blobstore_failpoint_publishes_nothing(tmp_path, armed):
    armed("storage.blobstore.persist=error:once")
    for name, blob, rec, ferr in (("port", tblob, trec, F.FaultInjected),
                                  ("ref", jblob, jrec, R.FaultInjected)):
        models = blob.BlobModels(blob.FileBlobBackend(str(tmp_path / name)))
        with pytest.raises(ferr):
            models.insert(rec.Model("m", b"bytes"))
        assert models.get("m") is None
    assert blob_keys(tmp_path / "port") == blob_keys(tmp_path / "ref") == {}


# ------------------------------------------------------------- registry
GETTERS = ("get_meta_data_apps", "get_meta_data_access_keys",
           "get_meta_data_engine_instances", "get_levents", "get_pevents",
           "get_model_data_models")
TYPES = ("sqlite", "memory", "eventlog", "parquet", "searchable", "fts",
         "elasticsearch", "localfs", "blob", "partlog")


def wiring(storage, getter, type_, tmp_path, monkeypatch):
    """The class a getter builds from a source of this type, or the
    error's class name."""
    repo = {"get_levents": "EVENTDATA", "get_pevents": "EVENTDATA",
            "get_model_data_models": "MODELDATA"}.get(getter, "METADATA")
    monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "SRC")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SRC_TYPE", type_)
    path = tmp_path / storage.__module__.split(".")[0] / type_
    path.mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SRC_PATH", str(
        path / "db" if type_ in ("sqlite", "searchable", "fts",
                                 "elasticsearch") else path))
    storage.reset()
    try:
        obj = getattr(storage, getter)()
    except Exception as e:
        return type(e).__name__
    if type(obj).__name__ == "PEventsAdapter":
        return "PEventsAdapter(" + type(obj._b).__name__ + ")"
    return type(obj).__name__


@pytest.mark.parametrize("type_", TYPES)
def test_registry_wires_every_type_as_the_reference(type_, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path / "home"))
    try:
        for getter in GETTERS:
            got = wiring(Storage, getter, type_, tmp_path, monkeypatch)
            want = wiring(JaxStorage, getter, type_, tmp_path, monkeypatch)
            assert got == want, getter
        # every repository is on this source now
        if type_ == "partlog":
            assert type(Storage.get_pevents()._b).__name__ == \
                "PartitionedEventLog"
        elif type_ in ("searchable", "fts", "elasticsearch"):
            clients = Storage.sqlite_clients()
            assert sorted(clients) == sorted(JaxStorage.sqlite_clients()) == \
                ["EVENTDATA", "METADATA", "MODELDATA"]
            assert {type(c).__name__ for c in clients.values()} == \
                {"SearchableClient"}
        assert Storage.verify_all_data_objects().keys() == \
            JaxStorage.verify_all_data_objects().keys()
    finally:
        Storage.reset()
        JaxStorage.reset()


# ------------------------------------------- the template from each store
VARIANT = {
    "id": "rec-stores", "engineFactory": "templates.recommendation",
    "datasource": {"params": {"app_name": "stores"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "num_iterations": 5, "lambda_": 0.1, "seed": 3}}],
}


def rating_events(n=300):
    rng = np.random.default_rng(11)
    return [Event("rate", "user", f"u{int(rng.integers(30))}", "item",
                  f"i{int(rng.integers(20))}",
                  properties={"rating": float(rng.integers(1, 6))},
                  event_time=T0 + dt.timedelta(seconds=k))
            for k in range(n)]


def factors_from(type_, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path / type_))
    for repo in ("METADATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "EV")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_EV_TYPE", type_)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_EV_PATH", str(
        tmp_path / type_ / ("s.db" if type_ == "searchable" else "ev")))
    Storage.reset()
    try:
        app_id = Storage.get_meta_data_apps().insert(trec.App(0, "stores"))
        Storage.get_pevents().write(rating_events(), app_id)
        variant = variant_from_dict(VARIANT)
        engine, ep = build_engine(variant)
        ctx = ComputeContext.create(seed=0, device="cpu")
        iid = run_train(engine, ep, variant, ctx=ctx)
        f = load_models_for_instance(iid, engine, ep, ctx)[0].factors
        return f.user_factors.clone(), f.item_factors.clone()
    finally:
        Storage.reset()


def test_recommendation_trains_the_memory_stores_factors_from_each_store(
        tmp_path, monkeypatch):
    want = factors_from("memory", tmp_path, monkeypatch)
    for type_ in ("eventlog", "parquet", "searchable"):
        got = factors_from(type_, tmp_path, monkeypatch)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            type_


def test_bulk_write_restores_the_page_cache(tmp_path):
    """A bulk write holds the large page cache only for its own
    transaction; statement journals stay in memory on every connection."""
    from pio_tpu_torch.storage import sqlite as tsql

    for client, events_cls in (
            (tsql.SQLiteClient(str(tmp_path / "a.db")), tsql.SQLiteEvents),
            (tsearch.SearchableClient(str(tmp_path / "b.db")),
             tsearch.SearchableEvents)):
        conn = client.conn()
        before = conn.execute("PRAGMA cache_size").fetchone()
        events_cls(client).write(both(api_events(9, 20))[1], APP)
        assert conn.execute("PRAGMA cache_size").fetchone() == before
        assert conn.execute("PRAGMA temp_store").fetchone() == (2,)  # MEMORY
        assert len(events_cls(client).find(APP)) == 20
