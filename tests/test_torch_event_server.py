"""The port's event server against the reference's: both run in-process on
port 0, each over its own SQLite file (its own ``$PIO_TPU_HOME``), and the
same requests go to each — single and batch ingest, the batch cap, bad
bodies, missing, unknown and whitelisted keys, channels, get, delete and
find with filters. Status codes and bodies must be equal, apart from
generated event ids, and so must the stored events. Also: the positive
access-key cache is dropped by ``Storage.reset()``, a 201 is committed
when it is answered, and the registry's reset hooks stay bounded however
many services are built."""

import gc
import http.client
import json
import sqlite3

import pytest

from pio_tpu.server.event_server import create_event_server as jax_create
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.storage.records import AccessKey as JaxAccessKey
from pio_tpu.storage.records import App as JaxApp
from pio_tpu.storage.records import Channel as JaxChannel
from pio_tpu_torch.server.event_server import (
    EventServerService,
    create_event_server,
)
from pio_tpu_torch.storage.records import AccessKey, App, Channel
from pio_tpu_torch.storage.registry import Storage

KEY, WL_KEY, OTHER_KEY = "key-all", "key-rate-only", "key-app2"


def seed_meta(storage, app_cls, key_cls, chan_cls):
    """Two apps, three keys (one with a whitelist), one channel."""
    apps = storage.get_meta_data_apps()
    a1 = apps.insert(app_cls(0, "shop"))
    a2 = apps.insert(app_cls(0, "blog"))
    keys = storage.get_meta_data_access_keys()
    keys.insert(key_cls(KEY, a1, ()))
    keys.insert(key_cls(WL_KEY, a1, ("rate",)))
    keys.insert(key_cls(OTHER_KEY, a2, ()))
    storage.get_meta_data_channels().insert(chan_cls(0, "web", a1))
    return a1, a2


def rate(k, **extra):
    d = {"event": "rate", "entityType": "user", "entityId": f"u{k % 7}",
         "targetEntityType": "item", "targetEntityId": f"i{k % 5}",
         "properties": {"rating": float(1 + k % 5)},
         "eventTime": f"2026-01-01T00:{k // 60 % 60:02d}:{k % 60:02d}.000Z",
         "creationTime": "2026-01-02T00:00:00.000Z"}
    d.update(extra)
    return d


def requests_script():
    """(method, path, body) — body None, bytes (sent raw) or JSON."""
    ev = "/events.json?accessKey=" + KEY
    batch = "/batch/events.json?accessKey=" + KEY
    good50 = [rate(k) for k in range(50)]
    mixed = [rate(100), {"event": "$set", "entityType": "user",
                         "entityId": "u1", "targetEntityType": "item",
                         "targetEntityId": "i1", "properties": {"a": 1}},
             "not an object", rate(101, eventTime="yesterday"),
             {"event": "view", "entityType": "user"}, rate(102, eventId="ev-b")]
    return [
        ("GET", "/", None),
        ("POST", ev, rate(1, eventId="ev-1")),
        ("POST", ev, rate(2)),
        ("POST", batch, good50),
        ("POST", batch, [rate(k) for k in range(51)]),
        ("POST", batch, mixed),
        ("POST", batch, {"not": "a list"}),
        ("POST", batch, []),
        ("POST", ev, b"{not json"),
        ("POST", ev, b"[1, 2]"),
        ("POST", ev, {"event": "$set", "entityType": "user",
                      "entityId": "u1",
                      "eventTime": "2026-01-01T01:00:00.000Z",
                      "creationTime": "2026-01-02T00:00:00.000Z"}),
        ("POST", ev, {"event": "$set", "entityType": "user", "entityId": "u1",
                      "properties": {"plan": "pro"},
                      "eventTime": "2026-01-01T02:00:00.000Z",
                      "creationTime": "2026-01-02T00:00:00.000Z",
                      "eventId": "ev-set"}),
        ("POST", ev, {"event": "$bogus", "entityType": "user",
                      "entityId": "u1"}),
        ("POST", ev, {"event": "$set", "entityType": "user", "entityId": "u1",
                      "targetEntityType": "item", "targetEntityId": "i1",
                      "properties": {"a": 1}}),
        ("POST", "/events.json", rate(3)),
        ("POST", "/events.json?accessKey=nope", rate(3)),
        ("GET", "/events.json?accessKey=nope", None),
        ("POST", "/events.json?accessKey=" + WL_KEY, rate(4, eventId="ev-wl")),
        ("POST", "/events.json?accessKey=" + WL_KEY,
         {**rate(5), "event": "buy"}),
        ("POST", "/batch/events.json?accessKey=" + WL_KEY,
         [rate(6, eventId="ev-wl2"), {**rate(7), "event": "view"}]),
        ("POST", ev + "&channel=web", rate(8, eventId="ev-ch")),
        ("POST", ev + "&channel=nope", rate(9)),
        ("POST", "/events.json?accessKey=" + OTHER_KEY, rate(10, eventId="ev-o")),
        ("GET", "/events/ev-1.json?accessKey=" + KEY, None),
        ("GET", "/events/ev-ch.json?accessKey=" + KEY, None),
        ("GET", "/events/ev-ch.json?accessKey=" + KEY + "&channel=web", None),
        ("GET", "/events/ev-1.json?accessKey=" + OTHER_KEY, None),
        ("GET", "/events/ev-missing.json?accessKey=" + KEY, None),
        ("DELETE", "/events/ev-b.json?accessKey=" + KEY, None),
        ("DELETE", "/events/ev-b.json?accessKey=" + KEY, None),
        ("GET", "/events/ev-b.json?accessKey=" + KEY, None),
        ("GET", ev, None),
        ("GET", ev + "&limit=-1", None),
        ("GET", ev + "&limit=5&reversed=false", None),
        ("GET", ev + "&entityType=user&entityId=u3&limit=-1", None),
        ("GET", ev + "&event=%24set", None),
        ("GET", ev + "&targetEntityType=item&targetEntityId=i2&limit=-1", None),
        ("GET", ev + "&startTime=2026-01-01T00:00:10Z"
                     "&untilTime=2026-01-01T00:00:20Z", None),
        ("GET", ev + "&channel=web", None),
        ("GET", ev + "&limit=abc", None),
        ("GET", ev + "&limit=-2", None),
        ("GET", ev + "&startTime=yesterday", None),
        ("GET", "/nowhere.json", None),
        ("PUT", ev, rate(11)),
    ]


def send(port, script):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    out = []
    try:
        for method, path, body in script:
            data = None
            if body is not None:
                data = body if isinstance(body, bytes) else json.dumps(body).encode()
            conn.request(method, path, data,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out.append((resp.status, json.loads(resp.read())))
    finally:
        conn.close()
    return out


def normalize(obj):
    """Generated event ids (32 hex characters) → a placeholder."""
    if isinstance(obj, dict):
        return {k: ("<id>" if k == "eventId" and not str(v).startswith("ev-")
                    else normalize(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalize(v) for v in obj]
    return obj


def stored(storage, apps):
    out = []
    for app_id, channel_id in apps:
        evs = storage.get_levents().find(app_id, channel_id=channel_id,
                                         limit=-1, reversed_order=False)
        out.append(normalize([e.to_api_dict() for e in evs]))
    return out


@pytest.fixture()
def fresh(tmp_path, monkeypatch):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE",
                           raising=False)
    Storage.reset()
    JaxStorage.reset()
    yield tmp_path
    Storage.reset()
    JaxStorage.reset()


def run_session(monkeypatch, home, storage, classes, create):
    monkeypatch.setenv("PIO_TPU_HOME", str(home))
    a1, a2 = seed_meta(storage, *classes)
    server = create(host="127.0.0.1", port=0)
    server.start()
    try:
        answers = send(server.port, requests_script())
    finally:
        server.stop()
    chan = storage.get_meta_data_channels().get_by_app_id(a1)[0].id
    return answers, stored(storage, [(a1, None), (a1, chan), (a2, None)])


def test_answers_and_stored_events_match_reference(fresh, monkeypatch):
    want, want_db = run_session(monkeypatch, fresh / "ref", JaxStorage,
                                (JaxApp, JaxAccessKey, JaxChannel), jax_create)
    got, got_db = run_session(monkeypatch, fresh / "port", Storage,
                              (App, AccessKey, Channel), create_event_server)
    assert [s for s, _ in got] == [s for s, _ in want]
    for k, (g, w) in enumerate(zip(got, want)):
        assert normalize(g) == normalize(w), (k, requests_script()[k][:2])
    assert got_db == want_db
    assert len(got_db[0]) == 1 + 1 + 50 + 2 + 1 + 1 + 1  # what was acked
    assert (fresh / "port" / "pio.db").exists()


def test_deleted_key_is_refused_after_a_reset(fresh, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(fresh))
    seed_meta(Storage, App, AccessKey, Channel)
    server = create_event_server(host="127.0.0.1", port=0).start()
    try:
        assert send(server.port, [("POST", "/events.json?accessKey=" + KEY,
                                   rate(1))])[0][0] == 201
        Storage.get_meta_data_access_keys().delete(KEY)
        # within the cache's TTL the positive lookup still answers ...
        assert send(server.port, [("POST", "/events.json?accessKey=" + KEY,
                                   rate(2))])[0][0] == 201
        # ... and a reset of the registry drops it
        Storage.reset()
        status, body = send(server.port, [
            ("POST", "/events.json?accessKey=" + KEY, rate(3))])[0]
        assert (status, body) == (401, {"message": "invalid accessKey"})
    finally:
        server.stop()


def test_a_201_is_committed_when_answered(fresh, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(fresh))
    monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
    a1, _ = seed_meta(Storage, App, AccessKey, Channel)
    server = create_event_server(host="127.0.0.1", port=0).start()
    reader = sqlite3.connect(str(fresh / "pio.db"))
    try:
        for k in range(5):
            status, body = send(server.port, [
                ("POST", "/events.json?accessKey=" + KEY, rate(k))])[0]
            assert status == 201
            row = reader.execute("SELECT app_id FROM events WHERE id=?",
                                 (body["eventId"],)).fetchone()
            assert row == (a1,)
    finally:
        reader.close()
        server.stop()


def test_reset_hooks_stay_bounded(fresh):
    before = len(Storage._reset_hooks)
    for k in range(200):
        EventServerService()
        if k % 20 == 19:
            gc.collect()  # a service's router holds its bound methods
    gc.collect()
    EventServerService()
    assert len(Storage._reset_hooks) <= before + 21
    hook = EventServerService().invalidate_auth_cache
    n = len(Storage._reset_hooks)
    Storage.add_reset_hook(hook)  # registered twice: kept once
    assert len(Storage._reset_hooks) == n


def test_reset_runs_live_hooks_and_drops_dead_ones(fresh):
    calls = []

    def plain():
        calls.append("plain")

    Storage.add_reset_hook(plain)
    Storage.add_reset_hook(plain)
    service = EventServerService()
    service._auth_cache["k"] = (1e18, object())
    Storage.reset()
    assert calls == ["plain"] and service._auth_cache == {}
    del service
    gc.collect()
    Storage.reset()
    assert all(ref() is not None for ref in Storage._reset_hooks)


# ------------------------------------------------- /events/search.json
def search_script():
    s = "/events/search.json?accessKey=" + KEY
    return [
        ("POST", "/batch/events.json?accessKey=" + KEY,
         [rate(k, eventId=f"ev-s{k}",
               properties={"rating": float(1 + k % 5),
                           "note": "gold" if k % 3 else "plain"})
          for k in range(12)]),
        ("POST", "/events.json?accessKey=" + KEY + "&channel=web",
         rate(20, eventId="ev-sw", properties={"note": "gold"})),
        ("GET", s + "&q=gold", None),
        ("GET", s + "&q=gold&limit=2", None),
        ("GET", s + "&q=gold%20AND%20u1", None),
        ("GET", s + "&q=plain%20OR%20u3&limit=-1", None),
        ("GET", s + "&q=gold&channel=web", None),
        ("GET", s + "&q=nothinglikethis", None),
        ("GET", s, None),
        ("GET", s + "&q=", None),
        ("GET", s + "&q=gold%20AND", None),
        ("GET", s + "&q=nosuchcolumn%3Ax", None),
        ("GET", s + "&q=gold&limit=-2", None),
        ("GET", "/events/search.json?accessKey=nope&q=gold", None),
        ("GET", "/events/ev-s1.json?accessKey=" + KEY, None),
    ]


def search_run(monkeypatch, home, storage, classes, create, type_):
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "EV")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_EV_TYPE", type_)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_EV_PATH", str(
        home / ("s.db" if type_ == "searchable" else "ev")))
    monkeypatch.setenv("PIO_TPU_HOME", str(home))
    seed_meta(storage, *classes)
    server = create(host="127.0.0.1", port=0)
    server.start()
    try:
        return send(server.port, search_script())
    finally:
        server.stop()


@pytest.mark.parametrize("type_", ["searchable", "eventlog", "sqlite"])
def test_search_route_matches_reference(fresh, monkeypatch, type_):
    want = search_run(monkeypatch, fresh / "ref", JaxStorage,
                          (JaxApp, JaxAccessKey, JaxChannel), jax_create, type_)
    got = search_run(monkeypatch, fresh / "port", Storage,
                         (App, AccessKey, Channel), create_event_server, type_)
    assert [s for s, _ in got] == [s for s, _ in want]
    for k, (g, w) in enumerate(zip(got, want)):
        assert normalize(g) == normalize(w), (k, search_script()[k][:2])
    codes = [s for s, _ in got[2:14]]
    if type_ == "searchable":
        assert codes == [200] * 6 + [400] * 5 + [401]
        hits = [e["eventId"] for e in got[2][1]]
        assert len(hits) == 8 and "ev-sw" not in hits  # its channel only
        assert [e["eventId"] for e in got[6][1]] == ["ev-sw"]
    else:
        # a store that cannot search: 501 once the query is well formed
        assert codes == [501] * 6 + [400, 400, 501, 501, 501, 401]
    assert got[14][0] == 200  # an event id still resolves past the route
