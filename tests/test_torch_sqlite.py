"""The port's SQLite store against the reference's: the same events and
metadata written through ``pio_tpu.storage.sqlite`` and through
``pio_tpu_torch.storage.sqlite``, each into its own file, read back equal
(every ``find`` filter, ``aggregate_properties``, ``find_frame``, every
metadata round trip, the schema); a file written by either package reads
back the same through the other; the durability mode's sync level; and the
group committer's acknowledgement (an insert returns only after its
transaction committed)."""

import dataclasses
import datetime as dt
import sqlite3
import sys
import threading

import numpy as np
import pytest

from pio_tpu.data.event import Event as JaxEvent
from pio_tpu.storage import records as jrec
from pio_tpu.storage import sqlite as jsql
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.storage import records as trec
from pio_tpu_torch.storage import sqlite as tsql
from pio_tpu_torch.storage.groupcommit import GroupCommitter
from pio_tpu_torch.storage.retry import ATTEMPTS, retrying

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
APP = 3
CHANNEL = 7


def api_events(seed=0, n=80):
    """Wire-format events from a seed: rates and views over a few users
    and items, $set/$unset/$delete of user properties, tags, and two
    events that share a time (the creation time is fixed, so that both
    stores hold the same rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = rng.choice(["rate", "view", "$set", "$unset", "$delete"],
                          p=[0.4, 0.3, 0.18, 0.08, 0.04])
        user = f"u{int(rng.integers(6))}"
        d = {"eventId": f"e{k:03d}", "event": str(kind),
             "entityType": "user", "entityId": user,
             "eventTime": (T0 + dt.timedelta(
                 seconds=int(k if k != 11 else 10),
                 microseconds=int(rng.integers(1000)) * 1000)).isoformat(),
             "creationTime": T0.isoformat()}
        if kind in ("rate", "view"):
            d["targetEntityType"] = "item"
            d["targetEntityId"] = f"i{int(rng.integers(5))}"
            if kind == "rate":
                d["properties"] = {"rating": float(rng.integers(1, 6))}
            d["tags"] = ["web"] if rng.random() < 0.3 else []
        elif kind == "$set":
            d["properties"] = {"plan": str(rng.choice(["a", "b"])),
                               "n": int(rng.integers(9))}
        elif kind == "$unset":
            d["properties"] = {"n": None}
        out.append(d)
    return out


def write_both(jev, tev, api, channel_id=None):
    """The same events through each store's three write paths: single
    inserts (group commit), one batch insert, and the bulk write."""
    a, b = len(api) // 3, 2 * len(api) // 3
    for store, cls in ((jev, JaxEvent), (tev, Event)):
        evs = [cls.from_api_dict(d) for d in api]
        for e in evs[:a]:
            store.insert(e, APP, channel_id)
        store.insert_batch(evs[a:b], APP, channel_id)
        store.write(evs[b:], APP, channel_id)


@pytest.fixture()
def stores(tmp_path):
    jc = jsql.SQLiteClient(str(tmp_path / "ref.db"))
    tc = tsql.SQLiteClient(str(tmp_path / "port.db"))
    yield jc, tc
    jc.close()
    tc.close()


def wire(events):
    return [e.to_api_dict() for e in events]


FILTERS = [
    {},
    {"entity_type": "user", "entity_id": "u1"},
    {"event_names": ["rate"]},
    {"event_names": ["rate", "view"], "target_entity_type": "item",
     "target_entity_id": "i2"},
    {"start_time": T0 + dt.timedelta(seconds=20),
     "until_time": T0 + dt.timedelta(seconds=50)},
    {"limit": 7},
    {"limit": 5, "reversed_order": True},
    {"reversed_order": True, "event_names": ["view"]},
    {"limit": 0},
]


@pytest.mark.parametrize("filters", FILTERS, ids=[str(f) for f in range(len(FILTERS))])
@pytest.mark.parametrize("channel_id", [None, CHANNEL], ids=["default", "channel"])
def test_find_matches_reference(stores, filters, channel_id):
    jc, tc = stores
    jev, tev = jsql.SQLiteEvents(jc), tsql.SQLiteEvents(tc)
    write_both(jev, tev, api_events(1), channel_id)
    want = wire(jev.find(APP, channel_id=channel_id, **filters))
    got = wire(tev.find(APP, channel_id=channel_id, **filters))
    assert got == want
    # the other channel holds nothing
    other = CHANNEL if channel_id is None else None
    assert tev.find(APP, channel_id=other) == []


def test_get_delete_remove_match_reference(stores):
    jc, tc = stores
    jev, tev = jsql.SQLiteEvents(jc), tsql.SQLiteEvents(tc)
    write_both(jev, tev, api_events(2))
    for eid in ("e000", "e040", "nope"):
        j, t = jev.get(eid, APP), tev.get(eid, APP)
        assert (t and t.to_api_dict()) == (j and j.to_api_dict())
    assert tev.delete("e005", APP) == jev.delete("e005", APP) is True
    assert tev.delete("e005", APP) == jev.delete("e005", APP) is False
    jsql.SQLitePEvents(jev).delete(["e006", "e007"], APP)
    tsql.SQLitePEvents(tev).delete(["e006", "e007"], APP)
    assert wire(tev.find(APP)) == wire(jev.find(APP))
    assert tev.remove(APP) and jev.remove(APP)
    assert tev.find(APP) == jev.find(APP) == []


def test_aggregate_properties_and_frame_match_reference(stores):
    jc, tc = stores
    jev, tev = jsql.SQLiteEvents(jc), tsql.SQLiteEvents(tc)
    write_both(jev, tev, api_events(3, n=120))
    jp, tp = jsql.SQLitePEvents(jev), tsql.SQLitePEvents(tev)
    for required in (None, ["plan"]):
        want = jp.aggregate_properties(APP, "user", required=required)
        got = tp.aggregate_properties(APP, "user", required=required)
        assert sorted(got) == sorted(want) and want
        for k in want:
            assert got[k].to_dict() == want[k].to_dict()
            assert got[k].first_updated == want[k].first_updated
            assert got[k].last_updated == want[k].last_updated
    for filters in ({}, {"event_names": ["rate"]}):
        jf = jp.find_frame(APP, **filters)
        tf = tp.find_frame(APP, **filters)
        for col in ("event", "entity_type", "entity_id", "target_entity_type",
                    "target_entity_id", "event_time_us"):
            np.testing.assert_array_equal(getattr(tf, col), getattr(jf, col))
        assert tf.properties == jf.properties


def _metadata(rec):
    """The same metadata records, built from one package's classes."""
    start = T0 + dt.timedelta(minutes=1)
    return dict(
        apps=[rec.App(0, "shop", "a shop"), rec.App(9, "blog")],
        keys=[rec.AccessKey("k1", 1, ()), rec.AccessKey("k2", 1, ("rate", "buy"))],
        channels=[rec.Channel(0, "mobile", 1), rec.Channel(5, "web-2", 9)],
        instances=[rec.EngineInstance(
            id="ei1", status="COMPLETED", start_time=start, end_time=start,
            engine_id="e", engine_version="1", engine_variant="engine.json",
            engine_factory="templates.recommendation", batch="b",
            env={"train_seconds": "1.0"}, jax_conf={"x": 1},
            data_source_params='{"app_name": "shop"}',
            algorithms_params='[{"name": "als"}]')],
        evals=[rec.EvaluationInstance(
            id="ev1", status="COMPLETED", start_time=start, end_time=start,
            evaluation_class="m:ev", evaluator_results="MSE: 1.0",
            evaluator_results_json='{"best": 1}', env={"a": "b"})],
        models=[rec.Model("ei1", b"\x00blob\xff"), rec.Model("ei1.manifest", b"{}")],
    )


def _write_metadata(mod, client, rec):
    md = _metadata(rec)
    apps, keys = mod.SQLiteApps(client), mod.SQLiteAccessKeys(client)
    chans = mod.SQLiteChannels(client)
    insts = mod.SQLiteEngineInstances(client)
    evals = mod.SQLiteEvaluationInstances(client)
    models = mod.SQLiteModels(client)
    out = {
        "app_ids": [apps.insert(a) for a in md["apps"]],
        "dup_app": apps.insert(rec.App(0, "shop")),
        "key_ids": [keys.insert(k) for k in md["keys"]],
        "dup_key": keys.insert(md["keys"][0]),
        "chan_ids": [chans.insert(c) for c in md["channels"]],
        "bad_chan": chans.insert(rec.Channel(0, "bad name!", 1)),
        "inst_ids": [insts.insert(i) for i in md["instances"]],
        "eval_ids": [evals.insert(e) for e in md["evals"]],
    }
    for m in md["models"]:
        models.insert(m)
    return out


def _read_metadata(mod, client):
    apps, keys = mod.SQLiteApps(client), mod.SQLiteAccessKeys(client)
    chans = mod.SQLiteChannels(client)
    insts = mod.SQLiteEngineInstances(client)
    evals = mod.SQLiteEvaluationInstances(client)
    models = mod.SQLiteModels(client)
    def asd(record):
        return record and dataclasses.asdict(record)

    return {
        "apps": [asd(a) for a in apps.get_all()],
        "by_name": asd(apps.get_by_name("blog")),
        "keys": sorted(asd(k)["key"] for k in keys.get_all()),
        "key2": asd(keys.get("k2")),
        "keys_app1": sorted(k.key for k in keys.get_by_app_id(1)),
        "chans": [asd(c) for c in chans.get_by_app_id(1)],
        "chan5": asd(chans.get(5)),
        "insts": [asd(i) for i in insts.get_all()],
        "latest": asd(insts.get_latest_completed("e", "1", "engine.json")),
        "evals": [asd(e) for e in evals.get_completed()],
        "model": asd(models.get("ei1")),
        "missing": models.get("nope"),
    }


def _mutate_metadata(mod, client, rec):
    apps, keys = mod.SQLiteApps(client), mod.SQLiteAccessKeys(client)
    insts = mod.SQLiteEngineInstances(client)
    return [
        apps.update(rec.App(1, "shop2", "renamed")),
        keys.update(rec.AccessKey("k1", 1, ("view",))),
        keys.delete("k2"), keys.delete("k2"),
        mod.SQLiteChannels(client).delete(5),
        insts.update(dataclasses.replace(insts.get("ei1"), status="FAILED")),
        mod.SQLiteEvaluationInstances(client).delete("ev1"),
        mod.SQLiteModels(client).delete("ei1.manifest"),
        apps.delete(9),
    ]


def test_metadata_round_trips_match_reference(stores):
    jc, tc = stores
    assert _write_metadata(tsql, tc, trec) == _write_metadata(jsql, jc, jrec)
    assert _read_metadata(tsql, tc) == _read_metadata(jsql, jc)
    assert _mutate_metadata(tsql, tc, trec) == _mutate_metadata(jsql, jc, jrec)
    assert _read_metadata(tsql, tc) == _read_metadata(jsql, jc)
    # a generated key is the reference's shape: 43 url-safe characters
    k = tsql.SQLiteAccessKeys(tc).insert(trec.AccessKey("", 1))
    assert len(k) == len(jsql.SQLiteAccessKeys(jc).insert(jrec.AccessKey("", 1)))


def test_schema_matches_reference(stores):
    jc, tc = stores
    assert tsql.SCHEMA_VERSION == jsql.SCHEMA_VERSION
    assert (tsql.SQLiteClient.schema_version(tc.conn())
            == jsql.SQLiteClient.schema_version(jc.conn()) == 1)
    q = "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name"
    assert tc.conn().execute(q).fetchall() == jc.conn().execute(q).fetchall()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    path = str(tmp_path / "pio.db")
    wmod, rmod = (jsql, tsql) if writer == "reference" else (tsql, jsql)
    wrec = jrec if writer == "reference" else trec
    wcls = JaxEvent if writer == "reference" else Event
    wc = wmod.SQLiteClient(path)
    ev = wmod.SQLiteEvents(wc)
    api = api_events(4)
    for d in api[:10]:
        ev.insert(wcls.from_api_dict(d), APP)
    ev.insert_batch([wcls.from_api_dict(d) for d in api[10:]], APP, CHANNEL)
    written = _write_metadata(wmod, wc, wrec)
    before = _read_metadata(wmod, wc)
    want = (wire(ev.find(APP)), wire(ev.find(APP, channel_id=CHANNEL)))
    wc.close()
    rc = rmod.SQLiteClient(path)
    rev = rmod.SQLiteEvents(rc)
    assert (wire(rev.find(APP)), wire(rev.find(APP, channel_id=CHANNEL))) == want
    assert _read_metadata(rmod, rc) == before and written["app_ids"] == [1, 9]
    rc.close()


@pytest.mark.parametrize("mode, level", [("commit", 2), ("batch", 1), ("os", 0)])
def test_durability_mode_sets_the_sync_level(tmp_path, monkeypatch, mode, level):
    monkeypatch.setenv("PIO_TPU_DURABILITY", mode)
    tc = tsql.SQLiteClient(str(tmp_path / "port.db"))
    jc = jsql.SQLiteClient(str(tmp_path / "ref.db"))
    got = tc.conn().execute("PRAGMA synchronous").fetchone()[0]
    assert got == level == jc.conn().execute("PRAGMA synchronous").fetchone()[0]
    assert tc.conn().execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    tc.close()
    jc.close()


def test_unknown_durability_mode_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_DURABILITY", "sometimes")
    with pytest.raises(ValueError, match="PIO_TPU_DURABILITY"):
        tsql.SQLiteClient(str(tmp_path / "port.db"))


def test_unset_durability_is_batch(tmp_path, monkeypatch):
    monkeypatch.delenv("PIO_TPU_DURABILITY", raising=False)
    tc = tsql.SQLiteClient(str(tmp_path / "port.db"))
    assert tc.conn().execute("PRAGMA synchronous").fetchone()[0] == 1
    tc.close()


def test_group_commit_acknowledges_after_commit(tmp_path):
    """More inserting threads than cores, with a short switch interval:
    every insert returns, and each event is visible to ANOTHER connection
    (so committed) the moment its insert returned."""
    path = str(tmp_path / "port.db")
    tc = tsql.SQLiteClient(path)
    ev = tsql.SQLiteEvents(tc)
    n_threads, per_thread = 16, 12
    missing, errors = [], []

    def worker(t):
        reader = sqlite3.connect(path, timeout=30)
        try:
            for k in range(per_thread):
                e = Event("view", "user", f"u{t}", "item", f"i{k}",
                          event_time=T0 + dt.timedelta(seconds=k))
                eid = ev.insert(e, APP)
                row = reader.execute(
                    "SELECT id FROM events WHERE app_id=? AND id=?",
                    (APP, eid)).fetchone()
                if row is None:
                    missing.append(eid)
        except Exception as exc:  # reported below, with its thread
            errors.append((t, exc))
        finally:
            reader.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == [] and missing == []
    assert len(ev.find(APP, limit=-1)) == n_threads * per_thread
    tc.close()


def test_group_committer_isolates_a_poisoned_payload():
    calls = []

    def flush(payloads):
        calls.append(list(payloads))
        if "bad" in payloads:
            raise ValueError("poisoned")
        return [p.upper() for p in payloads]

    gc = GroupCommitter(flush)
    assert gc.submit("ok") == "OK"
    with pytest.raises(ValueError, match="poisoned"):
        gc.submit("bad")
    assert calls == [["ok"], ["bad"], ["bad"]]


def test_retrying_retries_only_transient_errors():
    calls = []

    def flaky(errors):
        def fn():
            calls.append(1)
            if len(calls) <= errors:
                raise sqlite3.OperationalError("database is locked")
            return "done"
        return fn

    assert retrying(flaky(ATTEMPTS - 1)) == "done"
    assert len(calls) == ATTEMPTS
    calls.clear()
    with pytest.raises(sqlite3.OperationalError, match="locked"):
        retrying(flaky(ATTEMPTS))
    assert len(calls) == ATTEMPTS
    calls.clear()

    def broken():
        calls.append(1)
        raise sqlite3.OperationalError("no such table: events")

    with pytest.raises(sqlite3.OperationalError, match="no such table"):
        retrying(broken)
    assert len(calls) == 1
