"""The port's partitioned, replicated event log against the reference's.

``pio_tpu_torch/storage/partlog`` is held to ``pio_tpu/storage/partlog``:
frames, segment files and snapshots byte for byte; a directory written by
one package opened by the other with the same reads; replication across
the packages in both directions (the wire is the reference's); the same
failover winners; the same ack-gating errors; ``/storage.json`` of a
partlog event server and of the follower sidecar, and the fleet
aggregator's ``partlog`` roll-up of them. The reference's own
``tests/test_partlog.py`` cases run here through the port (the classes
below ``# -- the reference's cases``). Tolerance: bitwise throughout.
Inputs are made from a seed with numpy."""

import datetime as dt
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from pio_tpu import faults as r_faults
from pio_tpu.data.datamap import DataMap as RDataMap
from pio_tpu.data.event import Event as REvent
from pio_tpu.obs import metrics as r_metrics
from pio_tpu.obs.fleet import FleetAggregator as RFleet
from pio_tpu.server import fleetd as r_fleetd
from pio_tpu.server.event_server import create_event_server as r_create
from pio_tpu.storage import Storage as RStorage
from pio_tpu.storage import base as r_base
from pio_tpu.storage.partlog import failover as r_failover
from pio_tpu.storage.partlog import framing as r_framing
from pio_tpu.storage.partlog import partitioned as r_partitioned
from pio_tpu.storage.partlog import replication as r_replication
from pio_tpu.storage.partlog import segments as r_segments
from pio_tpu.storage.records import AccessKey as RAccessKey
from pio_tpu.storage.records import App as RApp
from pio_tpu_torch import faults
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.faults.registry import CRASH_EXIT_CODE, ENV_VAR
from pio_tpu_torch.obs import metrics as p_metrics
from pio_tpu_torch.obs import monotonic_s
from pio_tpu_torch.obs.fleet import FleetAggregator as PFleet
from pio_tpu_torch.obs.fleet import parse_targets
from pio_tpu_torch.server import fleetd as p_fleetd
from pio_tpu_torch.server.event_server import create_event_server
from pio_tpu_torch.storage import base as p_base
from pio_tpu_torch.storage.base import StorageError
from pio_tpu_torch.storage.partlog import (
    PartitionedEventLog, compaction, failover, framing, partition_of,
    replication,
)
from pio_tpu_torch.storage.partlog import partitioned as p_partitioned
from pio_tpu_torch.storage.partlog import segments as p_segments
from pio_tpu_torch.storage.partlog.segments import SegmentLog
from pio_tpu_torch.storage.records import AccessKey, App
from pio_tpu_torch.storage.registry import Storage

PKGS = {
    "port": types.SimpleNamespace(
        framing=framing, segments=p_segments,
        failover=failover, replication=replication,
        partitioned=p_partitioned, base=p_base, Event=Event,
        DataMap=DataMap, faults=faults, fleetd=p_fleetd,
    ),
    "ref": types.SimpleNamespace(
        framing=r_framing, segments=r_segments,
        failover=r_failover, replication=r_replication,
        partitioned=r_partitioned, base=r_base, Event=REvent,
        DataMap=RDataMap, faults=r_faults, fleetd=r_fleetd,
    ),
}
OTHER = {"port": "ref", "ref": "port"}
T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    for pkg in PKGS.values():
        pkg.faults.uninstall()
    yield
    for pkg in PKGS.values():
        pkg.faults.uninstall()


def T(h):
    return dt.datetime(2026, 3, 1, h, tzinfo=dt.timezone.utc)


def ev(name, t, eid="u1", etype="user", target=None, props=None):
    return Event(
        name, etype, eid,
        target_entity_type="item" if target else None,
        target_entity_id=target,
        properties=props or {},
        event_time=t,
    )


def event_rows(seed, n=80, users=12):
    """A seeded mix of ``$set``/``$unset``/``$delete`` and interaction
    events with explicit ids and creation times (so both packages write
    the same bytes)."""
    rng = np.random.default_rng(seed)
    kinds = ["$set", "$unset", "$delete", "rate", "view"]
    rows = []
    for i in range(n):
        kind = kinds[int(rng.choice(5, p=[0.4, 0.1, 0.05, 0.3, 0.15]))]
        props, target = {}, None
        if kind == "$set":
            props = {f"p{int(rng.integers(0, 4))}": int(rng.integers(0, 99)),
                     "plan": ["free", "pro"][int(rng.integers(0, 2))]}
        elif kind == "$unset":
            props = {f"p{int(rng.integers(0, 4))}": None}
        elif kind == "rate":
            target = f"i{int(rng.integers(0, 30))}"
            props = {"rating": float(rng.integers(1, 6))}
        else:
            target = None if kind == "$delete" else \
                f"i{int(rng.integers(0, 30))}"
        rows.append({
            "event": kind, "entity_type": "user",
            "entity_id": f"u{int(rng.integers(0, users))}",
            "target_entity_type": "item" if target else None,
            "target_entity_id": target, "properties": props,
            "event_time": T0 + dt.timedelta(
                minutes=int(rng.integers(0, 5000))),
            "event_id": f"e{seed}-{i}", "creation_time": T0,
        })
    return rows


def events(pkg, rows):
    return [PKGS[pkg].Event(**{**r, "properties": PKGS[pkg].DataMap(
        r["properties"])}) for r in rows]


def reads(log, app=1):
    """What the store serves: every event as its API dict, in find order,
    and the aggregated ``user`` properties with their times."""
    found = [e.to_api_dict() for e in log.find(app)]
    agg = {k: (v.to_dict(), v.first_updated, v.last_updated)
           for k, v in sorted(log.aggregate_properties(app, "user").items())}
    return found, agg


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------------ parity: bytes
def test_frames_scan_and_router_match_reference():
    rng = np.random.default_rng(0)
    payloads = [rng.bytes(int(n)) for n in rng.integers(0, 300, 64)]
    for p in payloads:
        assert framing.frame(p) == r_framing.frame(p)
    data = b"".join(framing.frame(p) for p in payloads)
    torn = data + framing.frame(b"torn")[:-3]
    for buf in (data, torn, data[:-1], b""):
        assert framing.scan(buf) == r_framing.scan(buf)
    ids = [f"user-{int(i)}" for i in rng.integers(0, 10 ** 9, 10_000)]
    for n in (1, 3, 4, 16):
        got = np.array([partition_of(i, n) for i in ids])
        want = np.array([r_partitioned.partition_of(i, n) for i in ids])
        assert np.array_equal(got, want)


def test_segment_files_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    blobs = [b"".join(framing.frame(rng.bytes(int(m)))
                      for m in rng.integers(1, 90, int(k)))
             for k in rng.integers(1, 5, 40)]
    for name, mod in (("port", p_segments), ("ref", r_segments)):
        s = mod.SegmentLog(str(tmp_path / name), partition=0, seg_bytes=256)
        offs = [s.append(b) for b in blobs]
        assert offs[-1][1] == s.committed == sum(map(len, blobs))
        assert s.read_range(100, 900) == b"".join(blobs)[100:900]
        s.close()
    got, want = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "ref")
    assert len(got) > 3 and got == want


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_directory_opens_across_packages(tmp_path, writer):
    """One package writes (with deletes, a purge and compaction); the
    other opens the root with the same reads, before and after its own
    compaction, and the snapshot reads as a full replay does."""
    reader = OTHER[writer]
    roots = {p: str(tmp_path / p) for p in PKGS}
    for pkg in PKGS:   # the same writes in both, for the byte check
        log = PKGS[pkg].partitioned.PartitionedEventLog(
            roots[pkg], partitions=4)
        evs = events(pkg, event_rows(2))
        log.insert_batch(evs[:50], 1)
        for e in evs[50:]:
            log.insert(e, 1)
        log.insert_batch(events(pkg, event_rows(3, n=10)), 2)
        assert log.delete("e2-7", 1) and not log.delete("nope", 1)
        log.delete_bulk(["e2-8", "e2-9", "absent"], 1)
        assert log.remove(2)
        log.close()
    assert tree_bytes(roots["port"]) == tree_bytes(roots["ref"])
    w = PKGS[writer].partitioned.PartitionedEventLog(roots[writer])
    want = reads(w)
    r = PKGS[reader].partitioned.PartitionedEventLog(roots[writer])
    assert reads(r) == want and len(want[0]) == 77
    assert r.find(2) == []
    assert r.compact() == w.compact()
    assert reads(r) == reads(w) == want  # the snapshot reads as replay
    r.close()
    w.close()
    again = PKGS[reader].partitioned.PartitionedEventLog(roots[writer])
    assert reads(again) == want  # cold: the snapshot read from disk
    again.close()
    # a root compacted by each package: byte-identical snapshots
    other = PKGS[writer].partitioned.PartitionedEventLog(roots[reader])
    other.compact()
    other.close()
    assert tree_bytes(roots["port"]) == tree_bytes(roots["ref"])


@pytest.mark.parametrize("leader", ["port", "ref"])
def test_replication_across_packages(tmp_path, monkeypatch, leader):
    """A leader of one package streams to a follower of the other at
    ``commit`` durability: every acknowledged insert is on the mirror,
    the mirrors of both directions agree byte for byte with the leader's
    segment chain, and the follower sidecar of each package reports the
    same positions."""
    follower_pkg = OTHER[leader]
    f = PKGS[follower_pkg].replication.FollowerServer(str(tmp_path / "f"))
    monkeypatch.setenv("PIO_TPU_PARTLOG_REPLICAS", f"127.0.0.1:{f.port}")
    monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
    log = PKGS[leader].partitioned.PartitionedEventLog(
        str(tmp_path / "leader"), partitions=3)
    try:
        evs = events(leader, event_rows(4, n=30))
        for e in evs[:10]:
            log.insert(e, 1)
        log.insert_batch(evs[10:], 1)
        topo = log.topology()
        for k in range(3):
            mirror = failover.follower_path(str(tmp_path / "f"), k)
            with open(mirror, "rb") as fh:
                assert fh.read() == log.read_range(k, 0, log.committed(k))
        repl = topo["replication"]
        assert repl["min_acks"] == 1
        assert repl["min_acked"] == {
            str(p["partition"]): p["committed_bytes"]
            for p in topo["partition_detail"]}
        answers = []
        for pkg in PKGS:
            service = PKGS[pkg].fleetd.FollowerStatusService(f)
            status, body = service.storage_json(None)
            assert status == 200
            answers.append(body)
        assert answers[0] == answers[1]
        assert answers[0]["positions"] == {
            str(k): log.committed(k) for k in range(3)}
    finally:
        log.close()
        f.stop()
    # the same stream replayed by a promoted follower serves the same
    promoted = str(tmp_path / "promoted")
    PKGS[follower_pkg].failover.promote([str(tmp_path / "f")], promoted)
    a = PartitionedEventLog(promoted)
    b = r_partitioned.PartitionedEventLog(str(tmp_path / "leader"))
    assert reads(a) == reads(b)
    a.close()
    b.close()


def test_elect_and_promote_match_reference(tmp_path):
    """Candidate mirrors of different lengths, one with a torn tail that
    holds more raw bytes: both packages elect the same winner per
    partition and promote byte-identical roots."""
    rng = np.random.default_rng(5)
    stream = [framing.frame(rng.bytes(int(m)))
              for m in rng.integers(1, 60, 24)]
    cands = []
    for c, cut in enumerate(([18, 6, 24], [12, 20, 24], [18, 3, 9])):
        root = tmp_path / f"c{c}"
        root.mkdir()
        (root / "MANIFEST.json").write_text(
            json.dumps({"version": 1, "partitions": 3}))
        for k, n in enumerate(cut):
            # more raw bytes than any other candidate, but torn
            torn = framing.frame(bytes(2000))[:-2] if (c, k) == (2, 1) \
                else b""
            (root / f"p{k:03d}.repl").write_bytes(
                b"".join(stream[:n]) + torn)
        cands.append(str(root))
    got, want = failover.elect(cands), r_failover.elect(cands)
    assert got == want
    assert [got[k]["winner"] for k in range(3)] == \
        [cands[0], cands[1], cands[0]]
    for pkg in PKGS:
        res = PKGS[pkg].failover.promote(cands, str(tmp_path / f"d-{pkg}"))
        assert res["election"] == want
    assert tree_bytes(tmp_path / "d-port") == tree_bytes(tmp_path / "d-ref")


@pytest.mark.parametrize("case", ["ack_timeout", "min_acks_above_replicas"])
def test_ack_gating_errors_match_reference(tmp_path, monkeypatch, case):
    monkeypatch.setenv("PIO_TPU_PARTLOG_REPLICAS",
                       f"127.0.0.1:{dead_port()}")
    monkeypatch.setenv("PIO_TPU_REPL_ACK_TIMEOUT_S", "0.2")
    monkeypatch.setenv("PIO_TPU_REPL_CONNECT_DEADLINE_S", "0.2")
    monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
    if case == "min_acks_above_replicas":
        monkeypatch.setenv("PIO_TPU_REPL_MIN_ACKS", "2")
    messages = {}
    for pkg in PKGS:
        mod = PKGS[pkg]
        root = str(tmp_path / pkg)
        if case == "min_acks_above_replicas":
            with pytest.raises(mod.base.StorageError) as ei:
                mod.partitioned.PartitionedEventLog(root, partitions=2)
        else:
            log = mod.partitioned.PartitionedEventLog(root, partitions=1)
            t0 = monotonic_s()
            with pytest.raises(mod.base.StorageError) as ei:
                log.insert_batch(events(pkg, event_rows(6, n=8)), 1)
            assert monotonic_s() - t0 < 2.0  # one wait for the batch
            assert len(log.find(1)) == 8  # persisted once, unacked
            log.close()
        messages[pkg] = str(ei.value)
    assert messages["port"] == messages["ref"]


@pytest.mark.parametrize("point", ["partlog.scan", "partlog.compact",
                                   "partlog.seal", "repl.connect"])
def test_failpoints_fire_like_reference(tmp_path, monkeypatch, point):
    """Each partlog failpoint the reference arms in its chaos specs, armed
    in both packages: the same call fails, and the store recovers."""
    for pkg in PKGS:
        mod = PKGS[pkg]
        root = tmp_path / pkg
        if point == "repl.connect":
            f = mod.replication.FollowerServer(str(root / "f"))
            monkeypatch.setenv("PIO_TPU_PARTLOG_REPLICAS",
                               f"127.0.0.1:{f.port}")
            monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
            mod.faults.install(f"{point}=error:once")
            log = mod.partitioned.PartitionedEventLog(str(root / "l"),
                                                      partitions=2)
            log.insert_batch(events(pkg, event_rows(7, n=6)), 1)
            assert mod.faults.snapshot()["rules"][0]["triggered"] == 1
            assert log.topology()["replication"]["followers"][0][
                "connected"]
            log.close()
            f.stop()
            continue
        log = mod.partitioned.PartitionedEventLog(str(root / "l"),
                                                  partitions=2)
        if point == "partlog.seal":
            seg = mod.segments.SegmentLog(str(root / "s"), partition=0,
                                          seg_bytes=8)
            mod.faults.install(f"{point}=error:once")
            with pytest.raises(Exception, match=point):
                seg.append(mod.framing.frame(b"crosses-the-roll"))
            mod.faults.uninstall()
            seg.append(mod.framing.frame(b"next"))
            assert seg.payloads() == [b"crosses-the-roll", b"next"]
            seg.close()
            log.close()
            continue
        log.insert_batch(events(pkg, event_rows(7, n=6)), 1)
        mod.faults.install(f"{point}=error:once")
        call = log.find if point == "partlog.scan" else \
            (lambda _app: log.compact())
        with pytest.raises(Exception, match=point):
            call(1)
        assert len(log.find(1)) == 6
        log.close()


# --------------------------------------------- /storage.json and the fleet
def _http(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return (resp.status, json.loads(resp.read() or b"null"),
                    {k.lower(): v for k, v in resp.headers.items()})
    except urllib.error.HTTPError as e:
        return (e.code, json.loads(e.read() or b"null"),
                {k.lower(): v for k, v in e.headers.items()})


def _partlog_env(monkeypatch, home, pkg):
    monkeypatch.setenv("PIO_TPU_HOME", str(home))
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "PL")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_PL_TYPE", "partlog")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_PL_PATH", str(home / pkg))
    monkeypatch.setenv("PIO_TPU_PARTLOG_PARTITIONS", "3")


def _neutral(payload, follower, root):
    """A topology with the run's own addresses and paths named."""
    text = json.dumps(payload, sort_keys=True)
    return json.loads(text.replace(follower, "FOLLOWER")
                      .replace(root, "ROOT"))


def test_storage_json_and_fleet_rollup_match_reference(tmp_path,
                                                       monkeypatch):
    """A partlog event server of each package with one follower of its
    own: ``/storage.json`` has the reference's keys and values, its
    ``/metrics`` the ``pio_tpu_partlog_`` / ``pio_tpu_repl_`` families,
    and each package's fleet aggregator rolls the payloads up into the
    same ``partlog`` block."""
    monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
    got = {}
    families = {}
    for pkg, storage, create, app_cls, key_cls in (
            ("port", Storage, create_event_server, App, AccessKey),
            ("ref", RStorage, r_create, RApp, RAccessKey)):
        f = PKGS[pkg].replication.FollowerServer(str(tmp_path / f"f-{pkg}"))
        follower = f"127.0.0.1:{f.port}"
        monkeypatch.setenv("PIO_TPU_PARTLOG_REPLICAS", follower)
        _partlog_env(monkeypatch, tmp_path, pkg)
        storage.reset()
        server = None
        try:
            app_id = storage.get_meta_data_apps().insert(app_cls(0, "topo"))
            storage.get_meta_data_access_keys().insert(key_cls("", app_id))
            storage.get_levents().insert_batch(
                events(pkg, event_rows(8, n=24)), app_id)
            server = create(host="127.0.0.1", port=0).start()
            url = f"http://127.0.0.1:{server.port}"
            status, topo, _ = _http("GET", f"{url}/storage.json")
            assert status == 200
            got[pkg] = _neutral(topo, follower, str(tmp_path / pkg))
            with urllib.request.urlopen(f"{url}/metrics", timeout=15) as r:
                families[pkg] = {
                    line.split()[2] for line in r.read().decode().splitlines()
                    if line.startswith("# TYPE pio_tpu_partlog_")
                    or line.startswith("# TYPE pio_tpu_repl_")}
        finally:
            if server is not None:
                server.stop()
            storage.reset()
            f.stop()
    assert got["port"] == got["ref"]
    assert got["port"]["role"] == "leader"
    assert got["port"]["replication"]["followers"][0]["lag"] == {
        "0": 0, "1": 0, "2": 0}
    assert families["port"] == families["ref"]
    assert "pio_tpu_repl_acks_total" in families["port"]

    class Fake:
        def fetch(self, url, timeout):
            if url.endswith("/storage.json"):
                return json.dumps(got["ref"]).encode()
            if url.endswith("/metrics"):
                return b"# TYPE pio_tpu_up gauge\npio_tpu_up 1\n"
            raise urllib.error.HTTPError(url, 404, "absent", {}, None)

    rolls = []
    for cls, metrics in ((PFleet, p_metrics), (RFleet, r_metrics)):
        agg = cls(parse_targets("pl:1"), registry=metrics.MetricsRegistry(),
                  interval_s=0.05, fetch=Fake().fetch)
        agg.scrape_once()
        rolls.append(agg.fleet_payload()["partlog"])
    assert rolls[0] == rolls[1]
    assert rolls[0]["leaders"][0]["partitions"] == 3


# ------------------------------------------- the reference's cases, on the port
class TestFraming:
    def test_roundtrip(self, tmp_path):
        data = b"".join(framing.frame(f"p{i}".encode()) for i in range(5))
        payloads, verified, total = framing.scan(data, origin="mem")
        assert payloads == [f"p{i}".encode() for i in range(5)]
        assert verified == total == len(data)

    def test_torn_tail_is_tolerated(self):
        data = framing.frame(b"good") + framing.frame(b"torn")[:-3]
        payloads, verified, total = framing.scan(data, origin="mem")
        assert payloads == [b"good"]
        assert verified == len(framing.frame(b"good")) and total == len(data)

    def test_mid_file_corruption_raises(self):
        a, b = framing.frame(b"aaaa"), framing.frame(b"bbbb")
        bad = bytearray(a + b)
        bad[6] ^= 0xFF  # corrupt frame 0's payload; frame 1 follows whole
        with pytest.raises(StorageError, match="not a torn tail"):
            framing.scan(bytes(bad), origin="mem")

    def test_repair_truncates_loudly(self, tmp_path, caplog):
        p = tmp_path / "seg.log"
        p.write_bytes(framing.frame(b"keep") + b"\x99\x98garbage")
        with caplog.at_level("WARNING", logger="pio_tpu_torch.partlog"):
            dropped = framing.repair(str(p))
        assert dropped == len(b"\x99\x98garbage")
        assert "truncating torn tail" in caplog.text
        assert p.read_bytes() == framing.frame(b"keep")
        assert framing.repair(str(p)) == 0  # already clean: silent no-op

    def test_verified_prefix_of_missing_file(self, tmp_path):
        assert framing.verified_prefix(str(tmp_path / "nope")) == 0


class TestSegmentLog:
    def test_append_offsets_and_sealing(self, tmp_path):
        s = SegmentLog(str(tmp_path / "p"), partition=0, seg_bytes=64)
        offs = [s.append(framing.frame(bytes(24))) for _ in range(4)]
        assert offs[0][0] == 0 and all(
            a[1] == b[0] for a, b in zip(offs, offs[1:])
        )
        segs = s.segments()
        assert len(segs) >= 2  # 32-byte frames against a 64-byte roll
        assert [g["start"] for g in segs] == sorted(
            g["start"] for g in segs
        )
        assert sum(g["bytes"] for g in segs) == s.committed
        assert len(s.payloads()) == 4
        s.close()

    def test_read_range_spans_segments(self, tmp_path):
        s = SegmentLog(str(tmp_path / "p"), partition=0, seg_bytes=40)
        whole = b""
        for i in range(6):
            f = framing.frame(f"payload-{i}".encode())
            s.append(f)
            whole += f
        assert s.read_range(0, s.committed) == whole
        assert s.read_range(13, 57) == whole[13:57]
        assert s.read_range(0, 10 ** 9) == whole  # end clamps to committed
        s.close()

    def test_reopen_repairs_torn_tail(self, tmp_path):
        pdir = tmp_path / "p"
        s = SegmentLog(str(pdir), partition=0)
        s.append(framing.frame(b"acked"))
        s.close()
        # simulate a crash mid-append: raw torn bytes past the last frame
        with (pdir / "seg-00000001.log").open("ab") as fh:
            fh.write(b"\x07\x00\x00")
        s2 = SegmentLog(str(pdir), partition=0)
        assert s2.payloads() == [b"acked"]
        s2.close()

    def test_injected_torn_write_heals_before_next_append(self, tmp_path):
        s = SegmentLog(str(tmp_path / "p"), partition=0)
        s.append(framing.frame(b"first"))
        faults.install("partlog.append.before_write=torn_write:once")
        with pytest.raises(StorageError, match="torn write"):
            s.append(framing.frame(b"wounded"))
        faults.uninstall()
        # the torn bytes are on disk past committed; the next append
        # must repair them away so the new record scans
        s.append(framing.frame(b"second"))
        assert s.payloads() == [b"first", b"second"]
        s.close()


class TestRouter:
    def test_stable_and_spread(self):
        ids = [f"user-{i}" for i in range(200)]
        first = [partition_of(i, 4) for i in ids]
        assert first == [partition_of(i, 4) for i in ids]
        assert set(first) == {0, 1, 2, 3}  # every partition takes load

    def test_same_entity_same_partition(self, tmp_path):
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=4)
        for h in range(1, 9):
            log.insert(ev("rate", T(h), eid="sticky"), 1)
        k = partition_of("sticky", 4)
        with log._view.lock:
            assert all(
                row[0] == k
                for row in log._view.buckets[(1, None)].values()
            )
        log.close()

    def test_manifest_wins_over_env(self, tmp_path, monkeypatch):
        root = str(tmp_path / "pl")
        PartitionedEventLog(root, partitions=3).close()
        monkeypatch.setenv("PIO_TPU_PARTLOG_PARTITIONS", "8")
        reopened = PartitionedEventLog(root)
        assert reopened.partitions == 3  # repartitioning would strand keys
        reopened.close()

    def test_reopen_replays_view(self, tmp_path):
        root = str(tmp_path / "pl")
        log = PartitionedEventLog(root, partitions=3)
        ids = [
            log.insert(ev("rate", T(h), eid=f"u{h}"), 1)
            for h in range(1, 6)
        ]
        assert log.delete(ids[0], 1)
        log.close()
        again = PartitionedEventLog(root)
        assert {e.event_id for e in again.find(1)} == set(ids[1:])
        again.close()

    def test_post_remove_writes_survive_reopen(self, tmp_path):
        """A channel purge fans one rm record into every partition, but
        replay walks partitions sequentially: each rm must clear only
        its own partition's pre-purge entries."""
        root = str(tmp_path / "pl")
        log = PartitionedEventLog(root, partitions=4)
        for h in range(1, 6):
            log.insert(ev("rate", T(h), eid=f"old{h}"), 1)
        assert log.remove(1)
        ids = [
            log.insert(ev("rate", T(h), eid=f"new{h}"), 1)
            for h in range(1, 9)
        ]
        assert {e.event_id for e in log.find(1)} == set(ids)
        log.close()
        again = PartitionedEventLog(root)
        assert {e.event_id for e in again.find(1)} == set(ids)
        again.close()

    def test_batch_writes_ride_the_committer(self, tmp_path):
        """insert_batch and delete_bulk go through the partition's
        GroupCommitter (one group payload per partition touched)."""
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=2)
        submitted = []
        for k, gc in enumerate(log._committers):
            gc.submit = (
                lambda payload, _k=k, _orig=gc.submit:
                submitted.append((_k, len(payload))) or _orig(payload)
            )
        evs = [ev("rate", T(h), eid=f"u{h}") for h in range(1, 9)]
        ids = log.insert_batch(evs, 1)
        assert len(ids) == 8
        assert sum(n for _, n in submitted) == 8
        assert {k for k, _ in submitted} == {
            partition_of(f"u{h}", 2) for h in range(1, 9)
        }
        submitted.clear()
        log.delete_bulk(ids[:3], 1)
        assert sum(n for _, n in submitted) == 3
        assert len(log.find(1)) == 5
        log.close()


class TestReplication:
    def test_follower_mirrors_leader_stream(self, tmp_path, monkeypatch):
        froot = str(tmp_path / "follower")
        f = replication.FollowerServer(froot)
        monkeypatch.setenv(
            "PIO_TPU_PARTLOG_REPLICAS", f"127.0.0.1:{f.port}"
        )
        monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
        log = PartitionedEventLog(str(tmp_path / "leader"), partitions=2)
        for h in range(1, 7):
            log.insert(ev("rate", T(h), eid=f"u{h}"), 1)
        # commit durability: insert returned ⇒ the follower acked
        for k in range(2):
            mirror = os.path.join(froot, f"p{k:03d}.repl")
            want = log.read_range(k, 0, log.committed(k))
            assert framing.verified_prefix(mirror) == len(want)
            with open(mirror, "rb") as fh:
                assert fh.read(len(want)) == want
        log.close()
        f.stop()

    def test_ack_timeout_fails_fast(self, tmp_path, monkeypatch):
        monkeypatch.setenv(
            "PIO_TPU_PARTLOG_REPLICAS", f"127.0.0.1:{dead_port()}"
        )
        monkeypatch.setenv("PIO_TPU_REPL_ACK_TIMEOUT_S", "0.2")
        monkeypatch.setenv("PIO_TPU_REPL_CONNECT_DEADLINE_S", "0.2")
        monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
        log = PartitionedEventLog(str(tmp_path / "leader"), partitions=2)
        from pio_tpu_torch.storage.retry import is_transient

        t0 = monotonic_s()
        with pytest.raises(StorageError,
                           match="replication ack timeout") as ei:
            log.insert(ev("rate", T(1)), 1)
        assert not is_transient(ei.value)
        assert monotonic_s() - t0 < 5.0
        log.close()

    def test_ack_timeout_does_not_duplicate_appends(
        self, tmp_path, monkeypatch
    ):
        monkeypatch.setenv(
            "PIO_TPU_PARTLOG_REPLICAS", f"127.0.0.1:{dead_port()}"
        )
        monkeypatch.setenv("PIO_TPU_REPL_ACK_TIMEOUT_S", "0.2")
        monkeypatch.setenv("PIO_TPU_REPL_CONNECT_DEADLINE_S", "0.2")
        monkeypatch.setenv("PIO_TPU_DURABILITY", "commit")
        log = PartitionedEventLog(str(tmp_path / "leader"), partitions=1)
        evs = [ev("rate", T(h), eid=f"u{h}") for h in range(1, 7)]
        t0 = monotonic_s()
        with pytest.raises(StorageError, match="replication ack timeout"):
            log.insert_batch(evs, 1)
        assert monotonic_s() - t0 < 2.0
        assert len(log._segs[0].payloads()) == 6
        assert len(log.find(1)) == 6
        log.close()
        again = PartitionedEventLog(str(tmp_path / "leader"))
        assert len(again.find(1)) == 6
        again.close()

    def test_min_acks_above_replica_count_raises(
        self, tmp_path, monkeypatch
    ):
        monkeypatch.setenv("PIO_TPU_PARTLOG_REPLICAS", "127.0.0.1:9")
        monkeypatch.setenv("PIO_TPU_REPL_MIN_ACKS", "3")
        with pytest.raises(StorageError, match="PIO_TPU_REPL_MIN_ACKS"):
            PartitionedEventLog(str(tmp_path / "leader"), partitions=2)

    def test_reconnect_catches_up(self, tmp_path, monkeypatch):
        """A follower that was down during the writes reconnects and
        pulls the whole backlog."""
        froot = str(tmp_path / "follower")
        port = dead_port()  # the follower starts here later
        monkeypatch.setenv("PIO_TPU_PARTLOG_REPLICAS", f"127.0.0.1:{port}")
        monkeypatch.setenv("PIO_TPU_DURABILITY", "batch")  # no ack gate
        monkeypatch.setenv("PIO_TPU_REPL_CONNECT_DEADLINE_S", "15")
        log = PartitionedEventLog(str(tmp_path / "leader"), partitions=2)
        for h in range(1, 7):
            log.insert(ev("rate", T(h), eid=f"u{h}"), 1)
        f = replication.FollowerServer(froot, port=port)
        want = {k: log.committed(k) for k in range(2)}
        deadline = monotonic_s() + 20
        while monotonic_s() < deadline:
            got = {
                k: framing.verified_prefix(
                    os.path.join(froot, f"p{k:03d}.repl")
                )
                for k in range(2)
            }
            if got == want:
                break
            time.sleep(0.05)
        assert got == want, f"follower never caught up: {got} != {want}"
        log.close()
        f.stop()


_CRASH_WRITER = textwrap.dedent("""
    import datetime as dt
    import os
    import sys

    root, ackfile = sys.argv[1], sys.argv[2]

    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.storage.partlog import PartitionedEventLog

    b = PartitionedEventLog(root)
    t = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    ack = open(ackfile, "w")
    for i in range(12):
        eid = b.insert(
            Event(event="e", entity_type="u", entity_id=f"u{i}",
                  event_time=t),
            1,
        )
        # an id reaches this file only after insert returned (the 201),
        # fsynced so the parent can trust it
        ack.write(eid + "\\n")
        ack.flush()
        os.fsync(ack.fileno())

    from pio_tpu_torch import faults
    faults.install("groupcommit.flush.partlog*=crash:once")
    b.insert(
        Event(event="e", entity_type="u", entity_id="boom", event_time=t),
        1,
    )
    print("UNREACHABLE")
""")


def _run_writer(script, *argv, env_extra=None):
    env = dict(os.environ)
    env.pop(ENV_VAR, None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", script, *argv],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )


class TestCrashFailover:
    @pytest.mark.parametrize("level", ["commit", "batch", "os"])
    def test_sigkill_leader_mid_commit_with_two_followers(
        self, tmp_path, level
    ):
        """The leader process dies inside a partition group-commit flush
        with two live followers; the longest verified prefix is
        promoted; at ``commit`` durability it serves every acked write."""
        froot1 = str(tmp_path / "f1")
        froot2 = str(tmp_path / "f2")
        f1 = replication.FollowerServer(froot1)
        f2 = replication.FollowerServer(froot2)
        root = str(tmp_path / "leader")
        ackfile = str(tmp_path / "acks")
        try:
            proc = _run_writer(
                _CRASH_WRITER, root, ackfile,
                env_extra={
                    "PIO_TPU_DURABILITY": level,
                    "PIO_TPU_PARTLOG_PARTITIONS": "3",
                    "PIO_TPU_PARTLOG_REPLICAS":
                        f"127.0.0.1:{f1.port},127.0.0.1:{f2.port}",
                },
            )
        finally:
            f1.stop()
            f2.stop()
        assert proc.returncode == CRASH_EXIT_CODE, proc.stderr
        assert "injected crash" in proc.stderr
        assert "UNREACHABLE" not in proc.stdout
        with open(ackfile) as f:
            acked = [line.strip() for line in f if line.strip()]
        assert len(acked) == 12

        dest = str(tmp_path / "promoted")
        res = failover.promote([froot1, froot2], dest)
        assert res["partitions"] == 3
        b = PartitionedEventLog(dest)
        got = {e.event_id for e in b.find(1)}
        if level == "commit":
            assert set(acked) <= got, (
                f"lost acked events: {set(acked) - got}"
            )
            assert "boom" not in {e.entity_id for e in b.find(1)}
        n = len(b.find(1))
        b.insert(ev("e", T(9), eid="after-failover"), 1)
        assert len(b.find(1)) == n + 1
        b.close()


class TestElection:
    def _mk_follower_root(self, path, streams, torn=b""):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "MANIFEST.json"), "w") as f:
            json.dump({"version": 1, "partitions": len(streams)}, f)
        for k, payloads in enumerate(streams):
            with open(os.path.join(path, f"p{k:03d}.repl"), "wb") as f:
                for p in payloads:
                    f.write(framing.frame(p))
                f.write(torn)

    def test_longest_verified_prefix_wins_per_partition(self, tmp_path):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        self._mk_follower_root(a, [[b"x", b"y"], [b"q"]])
        self._mk_follower_root(b, [[b"x"], [b"q", b"r", b"s"]])
        out = failover.elect([a, b])
        assert out[0]["winner"] == a
        assert out[1]["winner"] == b
        assert out[0]["position"] == len(framing.frame(b"x") * 2)
        assert set(out[0]["candidates"]) == {a, b}

    def test_torn_tail_never_scores_and_promote_drops_it(
        self, tmp_path, caplog
    ):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        self._mk_follower_root(a, [[b"x", b"y"]])
        self._mk_follower_root(b, [[b"x"]], torn=framing.frame(b"t")[:-2])
        out = failover.elect([a, b])
        assert out[0]["winner"] == a
        dest = str(tmp_path / "dest")
        with caplog.at_level("WARNING", logger="pio_tpu_torch.partlog"):
            failover.promote([b], dest)  # only the torn candidate left
        assert "torn bytes" in caplog.text
        seg = os.path.join(dest, "p000", "seg-00000001.log")
        with open(seg, "rb") as fh:
            assert fh.read() == framing.frame(b"x")

    def test_no_manifest_anywhere_raises(self, tmp_path):
        with pytest.raises(StorageError, match="MANIFEST"):
            failover.elect([str(tmp_path / "empty")])

    def test_promote_refuses_nonempty_dest(self, tmp_path):
        a = str(tmp_path / "a")
        self._mk_follower_root(a, [[b"x"]])
        dest = str(tmp_path / "dest")
        os.makedirs(os.path.join(dest, "p000"))
        with open(
            os.path.join(dest, "p000", "seg-00000002.log"), "wb"
        ) as f:
            f.write(framing.frame(b"stale"))
        with pytest.raises(StorageError, match="not empty"):
            failover.promote([a], dest)
        dest2 = str(tmp_path / "dest2")
        os.makedirs(dest2)
        res = failover.promote([a], dest2)
        assert res["partitions"] == 1


class TestCompaction:
    def _fill(self, log):
        log.insert(ev("$set", T(1), "u1", props={"a": 1, "plan": "free"}), 1)
        log.insert(ev("$set", T(2), "u1", props={"plan": "pro"}), 1)
        log.insert(ev("$unset", T(3), "u1", props={"a": None}), 1)
        log.insert(ev("$set", T(1), "u2", props={"b": 2}), 1)
        log.insert(ev("$delete", T(2), "u2"), 1)
        log.insert(ev("$set", T(1), "u3", props={"c": 3}), 1)
        log.insert(ev("rate", T(4), "u1", target="i1"), 1)

    @staticmethod
    def _dump(agg):
        return {
            k: (v.to_dict(), v.first_updated, v.last_updated)
            for k, v in sorted(agg.items())
        }

    def test_snapshot_read_identical_to_full_replay(self, tmp_path):
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=3)
        self._fill(log)
        before = log.aggregate_properties(1, "user")
        log.compact()
        topo = log.topology()
        assert all(
            p["snapshot_watermark"] == p["records"]
            for p in topo["partition_detail"] if p["records"]
        )
        after = log.aggregate_properties(1, "user")
        assert self._dump(before) == self._dump(after)
        log.close()
        again = PartitionedEventLog(str(tmp_path / "pl"))
        assert self._dump(again.aggregate_properties(1, "user")) == \
            self._dump(before)
        again.close()

    def test_resume_fold_past_watermark(self, tmp_path):
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=3)
        self._fill(log)
        log.compact()
        log.insert(ev("$set", T(5), "u1", props={"tier": "gold"}), 1)
        log.insert(ev("$set", T(5), "u9", props={"new": True}), 1)
        agg = log.aggregate_properties(1, "user")
        assert agg["u1"].to_dict() == {"plan": "pro", "tier": "gold"}
        assert agg["u9"].to_dict() == {"new": True}  # born post-watermark
        log.close()

    def test_checksum_fallback_is_loud_and_exact(self, tmp_path, caplog):
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=2)
        self._fill(log)
        want = self._dump(log.aggregate_properties(1, "user"))
        log.compact()
        fell = compaction._FALLBACKS.value("checksum")
        for k in range(2):
            p = os.path.join(
                str(tmp_path / "pl"), f"p{k:03d}", "snapshot.json"
            )
            with open(p, "rb") as fh:
                raw = bytearray(fh.read())
            raw[len(raw) // 2] ^= 0xFF
            with open(p, "wb") as fh:
                fh.write(bytes(raw))
        log._snapshots.clear()
        with caplog.at_level("WARNING", logger="pio_tpu_torch.partlog"):
            got = self._dump(log.aggregate_properties(1, "user"))
        assert got == want  # fallback is the exact full fold
        assert "sha256" in caplog.text
        assert compaction._FALLBACKS.value("checksum") > fell
        log.close()

    def test_rewritten_history_falls_back(self, tmp_path):
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=2)
        self._fill(log)
        log.compact()
        doomed = [
            e for e in log.find(1, entity_id="u1", event_names=["$set"])
            if e.properties.get("plan") == "pro"
        ]
        assert log.delete(doomed[0].event_id, 1)
        fell = compaction._FALLBACKS.value("history_rewritten")
        agg = log.aggregate_properties(1, "user")
        assert agg["u1"].to_dict() == {"plan": "free"}  # re-folded truth
        assert compaction._FALLBACKS.value("history_rewritten") > fell
        log.close()

    def test_out_of_order_suffix_falls_back(self, tmp_path):
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=2)
        log.insert(ev("$set", T(5), "u1", props={"plan": "pro"}), 1)
        log.compact()
        log.insert(ev("$set", T(2), "u1", props={"plan": "free"}), 1)
        fell = compaction._FALLBACKS.value("out_of_order")
        agg = log.aggregate_properties(1, "user")
        assert agg["u1"].to_dict() == {"plan": "pro"}  # T(5) still wins
        assert compaction._FALLBACKS.value("out_of_order") > fell
        log.close()

    def test_time_windowed_reads_bypass_snapshot(self, tmp_path):
        log = PartitionedEventLog(str(tmp_path / "pl"), partitions=2)
        self._fill(log)
        log.compact()
        agg = log.aggregate_properties(1, "user", until_time=T(2))
        assert agg["u1"].to_dict() == {"a": 1, "plan": "free"}
        log.close()


@pytest.fixture()
def partlog_server_env(tmp_path, monkeypatch):
    _partlog_env(monkeypatch, tmp_path, "partlog")
    Storage.reset()
    yield monkeypatch
    Storage.reset()


class TestStorageEndpoint:
    def test_partlog_topology(self, partlog_server_env):
        app_id = Storage.get_meta_data_apps().insert(App(0, "topo"))
        key = Storage.get_meta_data_access_keys().insert(
            AccessKey("", app_id)
        )
        server = create_event_server(host="127.0.0.1", port=0).start()
        try:
            url = f"http://127.0.0.1:{server.port}"
            e = {"event": "rate", "entityType": "user", "entityId": "u1",
                 "eventTime": "2026-03-01T10:00:00Z"}
            assert _http(
                "POST", f"{url}/events.json?accessKey={key}", e
            )[0] == 201
            status, topo, _ = _http("GET", f"{url}/storage.json")
            assert status == 200
            assert topo["backend"] == "partlog"
            assert topo["role"] == "leader" and topo["partitions"] == 3
            assert len(topo["partition_detail"]) == 3
            assert sum(
                p["records"] for p in topo["partition_detail"]
            ) == 1
            assert topo["replication"] is None  # no replicas configured
        finally:
            server.stop()

    def test_non_partlog_backend_reports_type(self, tmp_home, monkeypatch):
        monkeypatch.setenv(
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEM"
        )
        monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
        monkeypatch.setenv(
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEM"
        )
        Storage.reset()
        server = create_event_server(host="127.0.0.1", port=0).start()
        try:
            status, body, _ = _http(
                "GET", f"http://127.0.0.1:{server.port}/storage.json"
            )
            assert status == 200
            assert body == {"backend": "MemLEvents", "topology": None}
        finally:
            server.stop()
            Storage.reset()


class TestBreakerShedsDeadPartition:
    def test_dead_replica_opens_breaker_503(self, partlog_server_env):
        """Commit-durability inserts against a replica that never acks
        fail fast, trip the storage breaker, and later writes shed 503 +
        Retry-After."""
        mp = partlog_server_env
        mp.setenv("PIO_TPU_PARTLOG_REPLICAS", f"127.0.0.1:{dead_port()}")
        mp.setenv("PIO_TPU_REPL_ACK_TIMEOUT_S", "0.2")
        mp.setenv("PIO_TPU_REPL_CONNECT_DEADLINE_S", "0.2")
        mp.setenv("PIO_TPU_DURABILITY", "commit")
        Storage.reset()
        app_id = Storage.get_meta_data_apps().insert(App(0, "breaker"))
        key = Storage.get_meta_data_access_keys().insert(
            AccessKey("", app_id)
        )
        server = create_event_server(
            host="127.0.0.1", port=0,
            qos="rps=1000,fail_rate=0.5,fail_window=4,"
                "cooldown=60s,probes=1",
        ).start()
        try:
            url = f"http://127.0.0.1:{server.port}"
            e = {"event": "rate", "entityType": "user", "entityId": "u1",
                 "eventTime": "2026-03-01T10:00:00Z"}
            for _ in range(4):
                status, _, _ = _http(
                    "POST", f"{url}/events.json?accessKey={key}", e
                )
                assert status == 500  # ack timeout surfaces, not hangs
            status, body, headers = _http(
                "POST", f"{url}/events.json?accessKey={key}", e
            )
            assert status == 503
            assert "breaker" in body["message"]
            assert int(headers["retry-after"]) >= 1
            snap = _http("GET", f"{url}/qos.json")[1]
            assert snap["breakers"]["storage"]["state"] == "open"
            assert snap["shed"]["breaker"] >= 1
        finally:
            server.stop()
