"""The port's failpoints (``pio_tpu_torch/faults``) against the JAX
package's, on the CPU.

- ``parse_faults`` over a table of specs: the same rules for the valid
  ones, the same error type for the invalid ones.
- ``snapshot()``, ``trigger_counts()`` and the exposition lines equal the
  reference's after the same triggers (probability 1, ``once``, and a
  probability under one seed of ``random`` in both).
- Every failpoint site of the modules the port has, under the
  reference's name, in the counterpart of the reference's module (an AST
  inventory of both packages).
- Drills: ``torn-write`` at ``storage.localfs.persist`` leaves the same
  files in both packages; an injected ``error`` at
  ``storage.sqlite.commit`` or ``groupcommit.flush.*`` is retried by the
  group committer's solo retry and the events read back equal the
  reference's under the same drill; ``retrying()`` retries
  ``FaultInjected``; the device and training watches' failpoints raise
  where they sit.
- ``--faults`` with a bad spec exits non-zero in both CLIs; a good one is
  exported and installed.
- ``GET /faults.json`` on the port's query and event servers gives the
  reference's payload, and ``/metrics`` carries
  ``pio_tpu_fault_triggered_total``; the query server's dispatch
  failpoints count their triggers.
"""

import argparse
import ast
import http.client
import json
import os
import pathlib
import random
import subprocess
import sys

import pytest

from pio_tpu import faults as R
from pio_tpu.storage import sqlite as jsql
from pio_tpu.storage.localfs import LocalFSModels as JaxLocalFS
from pio_tpu.storage.records import Model as JaxModel
from pio_tpu_torch import faults as F
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.storage import sqlite as tsql
from pio_tpu_torch.storage.localfs import LocalFSModels
from pio_tpu_torch.storage.records import Model
from pio_tpu_torch.storage.retry import retrying
from test_torch_similarproduct import memory_storage  # noqa: F401
from test_torch_sqlite import APP, api_events, wire

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv("PIO_TPU_FAULTS", raising=False)
    F.uninstall()
    R.uninstall()
    yield
    F.uninstall()
    R.uninstall()


# ---------------------------------------------------------------- grammar
VALID = [
    "eventlog.flush.*=error:0.1,storage.sqlite.commit=latency:200ms,"
    "worker.serve=crash:once",
    "p=torn_write", "p=torn-write:once", "p=latency:10ms:0.5",
    "p=latency:1.5s", "p=latency:3us:once", "a.b=error", " a = error : 1 ",
    "x=CRASH", "p=latency:2m,q=latency:1h,r=latency:1d", ",p=error,,",
    "", "stream.*=error:once",
]
INVALID = [
    "nope", "p=explode", "p=latency", "p=latency:soon", "p=error:0",
    "p=error:1.5", "p=error:maybe", "p=error:0.5:once", "=error", "p=",
    "p=latency:", "p=latency:10ms:once:1",
]


@pytest.mark.parametrize("spec", VALID)
def test_valid_specs_parse_as_the_reference_does(spec):
    got = [r.to_dict() for r in F.parse_faults(spec)]
    want = [r.to_dict() for r in R.parse_faults(spec)]
    assert got == want


@pytest.mark.parametrize("spec", INVALID)
def test_invalid_specs_raise_as_the_reference_does(spec):
    with pytest.raises(R.FaultError) as want:
        R.parse_faults(spec)
    with pytest.raises(F.FaultError) as got:
        F.parse_faults(spec)
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)


def _drive(mod, spec, points, seed=None):
    """Install ``spec`` and hit every point of ``points`` in order
    (errors caught); the registry's snapshot, counts and exposition."""
    mod.install(spec)
    if seed is not None:
        random.seed(seed)
    for p in points:
        try:
            mod.failpoint(p)
        except mod.FaultInjected:
            pass
    return mod.snapshot(), mod.trigger_counts(), mod.exposition_lines()


@pytest.mark.parametrize("spec,points,seed", [
    ("a=error,b.*=latency:1us", ["a", "b.x", "b.y", "a", "c"], None),
    ("a=error:once,a=latency:1us", ["a", "a", "a"], None),
    ("s.*=latency:0us:once,s.put=error", ["s.put", "s.put", "s.enc"], None),
    ("p=error:0.5,q=latency:0us:0.3", ["p", "q"] * 40, 1234),
])
def test_snapshot_counts_and_exposition_match_reference(spec, points, seed):
    assert _drive(F, spec, points, seed) == _drive(R, spec, points, seed)
    # a reinstall keeps the counts, uninstall clears them, in both
    F.install("")
    R.install("")
    assert F.snapshot() == R.snapshot()
    assert F.trigger_counts() == R.trigger_counts() != {}
    F.uninstall()
    R.uninstall()
    assert F.snapshot() == R.snapshot() and F.exposition_lines() == []


def test_torn_write_returns_a_strict_prefix_as_the_reference_does():
    data = bytes(range(200))
    F.install("p=torn-write")
    R.install("p=torn-write")
    random.seed(7)
    got = [F.failpoint("p", data) for _ in range(5)]
    random.seed(7)
    want = [R.failpoint("p", data) for _ in range(5)]
    assert got == want and all(len(g) < len(data) for g in got)


def test_env_arms_at_install_as_the_reference_does(monkeypatch):
    monkeypatch.setenv("PIO_TPU_FAULTS", "w.serve=latency:0us")
    assert [r.to_dict() for r in F.install()] == \
        [r.to_dict() for r in R.install()]
    assert F.snapshot()["spec"] == "w.serve=latency:0us"


# ------------------------------------------------------- the site inventory
#: port module → reference module, and the failpoints they share
SITES = {
    "obs/devicewatch.py": ("obs/devicewatch.py", [
        "devicewatch.sample", "devicewatch.payload"]),
    "obs/trainwatch.py": ("obs/trainwatch.py", [
        "trainwatch.record", "trainwatch.payload", "trainwatch.append"]),
    "server/query_server.py": ("server/query_server.py", [
        "shard.place", "scorer.dispatch.packed", "scorer.dispatch.solo",
        "scorer.dispatch.batch"]),
    "server/batchlane.py": ("server/batchlane.py", [
        "batchlane.submit", "batchlane.drain"]),
    "server/worker_pool.py": ("server/worker_pool.py", ["worker.serve"]),
    "server/residency.py": ("server/residency.py", [
        "scorer.h2d.ship", "scorer.donate.dispatch"]),
    "storage/groupcommit.py": ("storage/groupcommit.py", [
        "groupcommit.flush.*"]),
    "storage/sqlite.py": ("storage/sqlite.py", ["storage.sqlite.commit"]),
    "storage/localfs.py": ("storage/localfs.py", ["storage.localfs.persist"]),
    "storage/eventlog.py": ("storage/eventlog.py", [
        "eventlog.append.before_write", "eventlog.append.after_write",
        "eventlog.flush.before_write", "eventlog.scan"]),
    "storage/blobstore.py": ("storage/blobstore.py", [
        "storage.blobstore.persist"]),
    "workflow/shard_store.py": ("workflow/shard_store.py", [
        "shard.reshard"]),
    "parallel/stream.py": ("parallel/stream.py", [
        "stream.encode", "stream.put", "stream.dispatch"]),
    "router/core.py": ("router/core.py", [
        "router.pick", "router.forward", "router.forward.hedge"]),
    "router/deploy.py": ("router/deploy.py", ["router.verify"]),
    "router/rollout.py": ("router/rollout.py", [
        "rollout.mirror", "rollout.judge", "rollout.promote",
        "rollout.rollback"]),
}


def _failpoints(path: pathlib.Path) -> list:
    """The point names of every ``failpoint(...)`` call in a module (an
    f-string's literal head, then ``*``)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not (isinstance(node, ast.Call) and node.args and getattr(
                node.func, "id", getattr(node.func, "attr", None))
                == "failpoint"):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant):
            names.append(arg.value)
        elif isinstance(arg, ast.JoinedStr):
            names.append(arg.values[0].value + "*")
    return sorted(names)


@pytest.mark.parametrize("module", sorted(SITES))
def test_every_reference_site_has_its_port_site(module):
    ref_module, points = SITES[module]
    got = _failpoints(REPO / "pio_tpu_torch" / module)
    want = _failpoints(REPO / "pio_tpu" / ref_module)
    assert sorted(points) == got
    assert set(points) <= set(want)


def test_no_module_still_says_failpoints_are_not_ported():
    for path in (REPO / "pio_tpu_torch").rglob("*.py"):
        text = path.read_text().lower()
        assert "failpoints are not ported" not in text, path
        assert "failpoints (faults are not ported)" not in text, path


# ------------------------------------------------------------------ drills
def test_torn_write_at_localfs_persist_leaves_the_same_files(tmp_path):
    payload = b"model-bytes-" * 64
    out = {}
    for name, mod, store_cls, model_cls in (
            ("port", F, LocalFSModels, Model),
            ("ref", R, JaxLocalFS, JaxModel)):
        root = tmp_path / name
        store = store_cls(str(root))
        store.insert(model_cls("good", b"v1"))
        mod.install("storage.localfs.persist=torn-write:once")
        with pytest.raises(mod.FaultInjected, match="torn-write"):
            store.insert(model_cls("doomed", payload))
        assert store.get("doomed") is None
        assert store.get("good").models == b"v1"
        out[name] = {p.name: p.read_bytes() for p in sorted(root.iterdir())}
        assert mod.trigger_counts() == {
            ("storage.localfs.persist", "torn-write"): 1}
    assert out["port"] == out["ref"]
    assert out["port"]["doomed.bin.tmp"] == payload


@pytest.mark.parametrize("spec", [
    "storage.sqlite.commit=error:once",
    "groupcommit.flush.*=error:once",
    "groupcommit.flush.sqlite=error:once,storage.sqlite.commit=error:once",
])
def test_sqlite_commit_errors_are_retried(tmp_path, spec):
    """Single inserts go through the group committer: an injected error
    in the flush rolls back and the payload is retried alone, so the
    insert lands; where the retry fails too (both points armed) the
    insert raises, in both packages. Both read back the same events."""
    jc = jsql.SQLiteClient(str(tmp_path / "ref.db"))
    tc = tsql.SQLiteClient(str(tmp_path / "port.db"))
    try:
        jev, tev = jsql.SQLiteEvents(jc), tsql.SQLiteEvents(tc)
        api = api_events(2, n=12)
        from pio_tpu.data.event import Event as JaxEvent

        F.install(spec)
        R.install(spec)
        raised = []
        for d in api:
            for mod, store, cls in ((F, tev, Event), (R, jev, JaxEvent)):
                try:
                    store.insert(cls.from_api_dict(d), APP)
                except mod.FaultInjected:
                    raised.append((mod.__name__, d["eventId"]))
        assert F.trigger_counts() == R.trigger_counts()
        assert sum(F.trigger_counts().values()) == spec.count("once")
        lost = spec.count("once") - 1  # both armed: the first insert fails
        assert [e for _, e in raised] == [api[0]["eventId"]] * 2 * lost
        assert wire(tev.find(APP)) == wire(jev.find(APP))
        assert len(tev.find(APP)) == len(api) - lost
    finally:
        jc.close()
        tc.close()


def test_retrying_retries_an_injected_error():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise F.FaultInjected("storage.sqlite.commit")
        return "ok"

    assert retrying(flaky) == "ok" and len(calls) == 3


def test_watch_failpoints_raise_where_they_sit(tmp_path):
    import torch

    from pio_tpu_torch.obs import devicewatch, trainwatch

    watch = devicewatch.DeviceWatch(device=torch.device("cpu"))
    rec = trainwatch.StepRecorder("drill")
    F.install("devicewatch.payload=error:once,trainwatch.payload=error:once,"
              "trainwatch.append=error:once,trainwatch.record=error:once,"
              "devicewatch.sample=error:once")
    for call in (watch.payload, watch.sample, rec.payload,
                 lambda: rec.record_steps(1),
                 lambda: trainwatch.append_run({"engine_id": "e"},
                                               str(tmp_path / "r.jsonl"))):
        with pytest.raises(F.FaultInjected):
            call()
    assert not (tmp_path / "r.jsonl").exists()
    # each once: everything runs clean afterwards
    watch.payload()
    assert rec.payload()["runId"] == "drill"
    assert len(F.trigger_counts()) == 5


# -------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("argv", [
    ["train", "--faults", "stream.put=explode"],
    ["deploy", "--faults", "worker.serve=error:2"],
    ["eventserver", "--faults", "storage.sqlite.commit=latency"],
])
def test_bad_faults_spec_exits_non_zero_in_both_clis(tmp_path, argv):
    """Before anything starts (the reference's deploy reads its
    engine.json first: one is there)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_TPU_FAULTS")}
    env.update(PIO_TPU_HOME=str(tmp_path), JAX_PLATFORMS="cpu")
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "faults", "engineFactory": "templates.classification",
        "datasource": {"params": {"app_name": "none"}},
        "algorithms": [{"name": "naivebayes", "params": {}}]}))
    for cli in (["-m", "pio_tpu_torch"], ["-m", "pio_tpu.tools.cli"]):
        proc = subprocess.run(
            [sys.executable, *cli, *argv], capture_output=True, text=True,
            timeout=120, env={**env, "PYTHONPATH": str(REPO)},
            cwd=str(tmp_path))
        assert proc.returncode != 0, (cli, proc.stdout, proc.stderr)
        assert "fault" in proc.stderr.lower(), proc.stderr
        assert "listening" not in proc.stdout


def test_good_faults_spec_is_exported_and_installed(monkeypatch):
    from pio_tpu_torch.tools import cli

    monkeypatch.delenv("PIO_TPU_FAULTS", raising=False)
    # in a verb's scope, as cli.main runs a verb: armed while it lasts,
    # disarmed and unexported after, for the later tests of this process
    with cli.verb_scope():
        cli._arm_faults(argparse.Namespace(faults="worker.serve=latency:0us"))
        assert os.environ["PIO_TPU_FAULTS"] == "worker.serve=latency:0us"
        assert F.snapshot()["enabled"] is True
        cli._arm_faults(argparse.Namespace(faults=None))  # no flag: untouched
        assert F.snapshot()["spec"] == "worker.serve=latency:0us"
    assert F.snapshot()["enabled"] is False
    assert "PIO_TPU_FAULTS" not in os.environ
    # a registry armed before the scope is armed as it was after it
    F.install("a=latency:0us")
    with cli.verb_scope():
        cli._arm_faults(argparse.Namespace(faults="b=error"))
        assert F.snapshot()["spec"] == "b=error"
    assert F.snapshot()["spec"] == "a=latency:0us"
    F.uninstall()
    parser = cli.build_parser()
    for verb in ("train", "deploy", "eventserver"):
        args = parser.parse_args([verb, "--faults", "a=error"])
        assert args.faults == "a=error"


# ----------------------------------------------------- /faults.json, /metrics
def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/queries.json", json.dumps(body).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_query_server_faults_json_and_metrics(memory_storage, monkeypatch):
    from test_torch_classification import APP as CLS_APP
    from test_torch_classification import train_port, user_rows
    from test_torch_similarproduct import seed_events

    from pio_tpu_torch.server.query_server import create_query_server

    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    seed_events(user_rows(), app=CLS_APP, reference=False)
    engine, ep, models = train_port("naivebayes")
    spec = "scorer.dispatch.*=latency:0us,scorer.h2d.ship=latency:0us"
    server = create_query_server(engine, ep, models, port=0, device="cpu")
    with server:
        status, body = _get(server.port, "/faults.json")
        assert status == 200 and json.loads(body) == F.snapshot() \
            == R.snapshot()
        F.install(spec)
        R.install(spec)
        for q in ({"attr0": 8, "attr1": 1, "attr2": 0},
                  {"attrs": [0.5, 2.0, 5.5]}):
            status, _ = _post(server.port, q)
            assert status == 200
            R.failpoint("scorer.dispatch.solo")
            R.failpoint("scorer.h2d.ship")
        status, body = _get(server.port, "/faults.json")
        assert json.loads(body) == R.snapshot()
        assert F.trigger_counts() == {("scorer.dispatch.solo", "latency"): 2,
                                      ("scorer.h2d.ship", "latency"): 2}
        status, text = _get(server.port, "/metrics")
        assert status == 200
        for line in R.exposition_lines():
            assert line in text.splitlines()


def test_event_server_faults_json(memory_storage):
    from pio_tpu_torch.server.event_server import create_event_server

    server = create_event_server(host="127.0.0.1", port=0)
    server.start()
    try:
        status, body = _get(server.port, "/faults.json")
        assert status == 200 and json.loads(body)["enabled"] is False
        F.install("p.q=latency:1ms")
        R.install("p.q=latency:1ms")
        F.failpoint("p.q")
        R.failpoint("p.q")
        status, body = _get(server.port, "/faults.json")
        assert json.loads(body) == R.snapshot()
        assert json.loads(body)["triggered"] == [
            {"point": "p.q", "action": "latency", "count": 1}]
    finally:
        server.stop()
