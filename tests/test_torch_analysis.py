"""The port's static analysis and debug locks against the reference's.

``pio_tpu_torch/analysis`` is held to ``pio_tpu/analysis``: one fixture
source tree, laid out under ``pio_tpu/`` for the reference and under
``pio_tpu_torch/`` for the port (each package names its modules by its own
root), gives both linters the same ``(rule, relative path, line, col)``
findings, rule by rule for every registered rule; ``lint --list-rules``
names the same rules; armed locks taken in opposite orders raise
``LockOrderInversion`` naming the same two locks in both packages, ``log``
mode records the inversion without raising, disarmed factories hand out
plain ``threading`` primitives, and a contended lock in a traced request
gives the trace a ``lock.<name>`` span under the reference's name.

The fixture sources live in string literals, so both packages' lint gates
(which lint ``tests/``) see only constants here. Tolerance: exact sets.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request

import pytest

from pio_tpu.analysis import core as r_core
from pio_tpu.analysis import runtime as r_runtime
from pio_tpu.server.event_server import create_event_server as r_create
from pio_tpu.storage import Storage as RStorage
from pio_tpu.storage.records import AccessKey as RAccessKey
from pio_tpu.storage.records import App as RApp
from pio_tpu.utils.knobs import Knob as RKnob
from pio_tpu_torch.analysis import core as p_core
from pio_tpu_torch.analysis import runtime as p_runtime
from pio_tpu_torch.server.event_server import create_event_server
from pio_tpu_torch.storage.records import AccessKey, App
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.utils.knobs import Knob as PKnob

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOTS = {"ref": "pio_tpu", "port": "pio_tpu_torch"}

#: path under the package root (or ``/``-rooted under the repo root) ->
#: source; ``PKG`` is replaced by the package's name
FIXTURES = {
    "conc/cv.py": '''
        import threading

        cv = threading.Condition()


        def poke():
            cv.notify_all()


        class Q:
            def __init__(self):
                self._cv = threading.Condition()
                self.items = []

            def take(self):
                with self._cv:
                    if not self.items:
                        self._cv.wait()
                    return self.items.pop()
    ''',
    "conc/locks.py": '''
        import threading
        import time


        class C:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def ab(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def ba(self):
                with self._b_lock:
                    with self._a_lock:
                        time.sleep(0.01)
    ''',
    "obs/payload.py": '''
        # pio: endpoint=/thing.json
        def thing_payload():
            return {"alpha": 1, "beta": {"gamma": 2}}
    ''',
    "tools/view.py": '''
        import json
        import urllib.request


        def show(base):
            with urllib.request.urlopen(base + "/thing.json") as r:
                body = json.load(r)
            return body["alpha"], body.get("betta"), body["beta"]["delta"]
    ''',
    "obs/tracing.py": '''
        def add_active_span(stage, dur_s):
            return stage, dur_s
    ''',
    "obs/fleet.py": '''
        FAMILIES = ("pio_tpu_fleet_real_total",)
    ''',
    "obs/register.py": '''
        from PKG.obs.metrics import REGISTRY

        A = REGISTRY.counter("pio_tpu_fixture_hits", "hits")
        B = REGISTRY.gauge("fixture_depth", "depth")
        C = REGISTRY.counter("pio_tpu_undocumented_total", "x")
        D = REGISTRY.counter("pio_tpu_ok_total", "ok")
    ''',
    "server/headers.py": '''
        def respond(handler):
            handler.send_header("X-Pio-Only-Written", "1")


        def read(req):
            return req.headers.get("X-Pio-Only-Read")
    ''',
    "server/spans.py": '''
        from PKG.obs.tracing import add_active_span

        EVENT_STAGES = ("parse", "Bad Stage")


        def run(tracer):
            add_active_span("store.flush", 0.1)
            with tracer.span("Not-A-Stage"):
                pass
    ''',
    "server/hot.py": '''
        import json
        import time


        # pio: hotpath
        def serve(q):
            helper(q)


        def helper(q):
            time.sleep(0.01)


        # pio: hotpath=zerocopy
        def decode(frame):
            return json.loads(frame)
    ''',
    "server/admit.py": '''
        def handler(gate, req):
            admission = gate.admit(req)
            do_work(req)
            admission.release()


        def do_work(req):
            return req
    ''',
    "native/frames.py": '''
        import struct


        def write(m, n, k):
            struct.pack_into("<II", m, 0, n, k)  # pio: frame=hdr


        def read(m):
            return struct.unpack_from("<III", m, 0)  # pio: frame=hdr
    ''',
    "utils/conf.py": '''
        import os
        import time

        from PKG.utils.envutil import env_int
        from PKG.utils.knobs import knob_str

        DEPTH = int(os.environ.get("FIXTURE_DEPTH", "3"))


        def knobs():
            n = env_int("PIO_TPU_FIXTURE_N", 8)
            x = os.environ.get("PIO_TPU_UNDECLARED")
            s = knob_str("PIO_TPU_FIXTURE_N")
            return n, x, s, time.time()
    ''',
    "storage/points.py": '''
        from PKG.faults import failpoint


        def write():
            failpoint("storage.never_armed")
            failpoint("storage.armed")
            failpoint("bogus.point")
            failpoint("storage.dup")


        def again():
            failpoint("storage.dup")
    ''',
    "/tests/test_points.py": '''
        SPEC = "storage.armed=error:once"
    ''',
    "/docs/observability.md": '''
        | `pio_tpu_fleet_real_total` | counter | live |
        | `pio_tpu_fleet_phantom_total` | counter | documented, never registered |
    ''',
}

#: the knob table both linters read (the reference's docs/operations.md,
#: the port's pio_tpu_torch/KNOBS.md): a wrong default and a stale row
KNOB_TABLE = '''
    | Knob | Type | Default | Description |
    | --- | --- | --- | --- |
    | `PIO_TPU_FIXTURE_N` | int | `5` | fixture count |
    | `PIO_TPU_FIXTURE_GONE` | str | `(empty)` | removed |
'''
KNOB_DOC = {"ref": "docs/operations.md", "port": "pio_tpu_torch/KNOBS.md"}
CATALOG = {"pio_tpu_fixture_hits", "pio_tpu_ok_total", "fixture_depth"}


def registry(pkg):
    knob = RKnob if pkg == "ref" else PKnob
    return {
        "PIO_TPU_FIXTURE_N": knob("PIO_TPU_FIXTURE_N", "int", 4, "count"),
        "PIO_TPU_FIXTURE_S": knob("PIO_TPU_FIXTURE_S", "str", "", "s"),
    }


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The fixture tree once per package: ``<root>/<pkg>/...``."""
    out = {}
    for pkg, name in ROOTS.items():
        root = tmp_path_factory.mktemp(pkg)
        for rel, src in FIXTURES.items():
            path = root / (rel[1:] if rel.startswith("/")
                           else os.path.join(name, rel))
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(textwrap.dedent(src).lstrip("\n")
                            .replace("PKG", name))
        doc = root / KNOB_DOC[pkg]
        doc.parent.mkdir(parents=True, exist_ok=True)
        doc.write_text(textwrap.dedent(KNOB_TABLE).lstrip("\n"))
        out[pkg] = root
    return out


def findings(pkg, root, rule=None):
    core = r_core if pkg == "ref" else p_core
    got = core.run_lint(
        [str(root / ROOTS[pkg]), str(root / "tests")],
        rule_ids=None if rule is None else [rule],
        catalog=CATALOG, repo_root=str(root),
        knob_registry=registry(pkg))
    out = set()
    for f in got:
        rel = os.path.relpath(f.path, root) if os.path.isabs(f.path) \
            else f.path
        rel = rel.replace(KNOB_DOC[pkg], "KNOB_DOC")
        parts = rel.split(os.sep)
        if parts[0] == ROOTS[pkg]:
            parts[0] = "PKG"
        out.add((f.rule, "/".join(parts), f.line, f.col))
    return out


RULE_IDS = sorted(r_core.all_rules())


@pytest.mark.parametrize("rule", RULE_IDS)
def test_each_rule_finds_what_the_reference_finds(trees, rule):
    want = findings("ref", trees["ref"], rule)
    got = findings("port", trees["port"], rule)
    assert want, f"the fixture tree gives {rule} nothing to find"
    assert got == want


def test_all_rules_together_match_reference(trees):
    got = findings("port", trees["port"])
    want = findings("ref", trees["ref"])
    assert got == want
    assert {r for r, *_ in got} == set(RULE_IDS)


def test_list_rules_names_the_same_rules():
    outs = []
    for mod in ("pio_tpu.tools.cli", "pio_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", mod, "lint", "--list-rules"],
            capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
        )
        assert proc.returncode == 0, proc.stderr
        outs.append([line.split()[0] for line in proc.stdout.splitlines()])
    assert outs[0] == outs[1] == sorted(p_core.all_rules())


def test_module_names_key_on_each_package(trees):
    for pkg, core in (("ref", r_core), ("port", p_core)):
        path = trees[pkg] / ROOTS[pkg] / "obs" / "payload.py"
        assert core._module_name(str(path)) == f"{ROOTS[pkg]}.obs.payload"
    # the other package's tree is not the port's: its modules are stems
    path = trees["ref"] / "pio_tpu" / "obs" / "payload.py"
    assert p_core._module_name(str(path)) == "payload"


# --------------------------------------------------------------- debug locks
RUNTIMES = {"ref": r_runtime, "port": p_runtime}


@pytest.fixture()
def armed(monkeypatch):
    def arm(mode):
        monkeypatch.setenv("PIO_TPU_DEBUG_SYNC", mode)
        for rt in RUNTIMES.values():
            rt.sync_debugger().reset()
    yield arm
    for rt in RUNTIMES.values():
        rt.sync_debugger().reset()


def _invert(rt):
    """Take two debug locks in one order, then in the other: the seeded
    inversion the runtime detector must catch (the static rule sees it
    too, hence the suppression)."""
    a = rt.make_lock("fixture.alpha")
    b = rt.make_rlock("fixture.beta")
    with a:
        with b:  # pio: disable=lock-order-cycle
            pass
    with b:
        with a:
            pass


def test_armed_inversion_raises_naming_the_same_locks(armed):
    armed("1")
    messages, edges = {}, {}
    for pkg, rt in RUNTIMES.items():
        with pytest.raises(rt.LockOrderInversion) as ei:
            _invert(rt)
        messages[pkg] = str(ei.value)
        edges[pkg] = rt.sync_debugger().edges()
    assert messages["port"] == messages["ref"]
    assert edges["port"] == edges["ref"]
    assert "`fixture.alpha`" in messages["port"]
    assert "`fixture.beta`" in messages["port"]


def test_log_mode_records_without_raising(armed):
    armed("log")
    recorded = {}
    for pkg, rt in RUNTIMES.items():
        _invert(rt)
        recorded[pkg] = rt.sync_debugger().inversions()
        assert len(recorded[pkg]) == 1
    assert recorded["port"] == recorded["ref"]


def test_condition_waits_release_through_the_wrapper(armed):
    armed("raise")
    cond = p_runtime.make_condition("fixture.cv")
    other = p_runtime.make_lock("fixture.other")
    done = []

    def waiter():
        with cond:
            while not done:
                cond.wait(timeout=1.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with other:   # other -> cv while the waiter sleeps in wait()
        with cond:
            done.append(1)
            cond.notify_all()
    t.join(timeout=5)
    assert not t.is_alive()
    assert p_runtime.sync_debugger().inversions() == []


@pytest.mark.parametrize("mode", ["", "0", "off"])
def test_disarmed_factories_are_plain_primitives(monkeypatch, mode):
    monkeypatch.setenv("PIO_TPU_DEBUG_SYNC", mode)
    for rt in RUNTIMES.values():
        assert type(rt.make_lock("x")) is type(threading.Lock())
        assert type(rt.make_rlock("x")) is type(threading.RLock())
        cond = rt.make_condition("x")
        assert type(cond) is threading.Condition
        assert type(cond._lock) is type(threading.RLock())


def test_serving_locks_are_created_through_the_factories(armed):
    """Armed, the port's serving locks are debug locks under the
    reference's names."""
    from pio_tpu_torch.qos import limiter
    from pio_tpu_torch.qos.breaker import CircuitBreaker
    from pio_tpu_torch.server.bucketcache import BucketExecutionCache
    from pio_tpu_torch.storage import eventlog
    from pio_tpu_torch.storage.groupcommit import GroupCommitter

    armed("1")
    gc = GroupCommitter(lambda payloads: payloads, store="fixture")
    got = {
        gc._qlock.name, gc._commit_lock.name,
        CircuitBreaker()._lock.name,
        BucketExecutionCache()._lock.name,
        limiter.TokenBucket(10.0, 10)._lock.name,
        eventlog._lock_for(os.path.join(REPO_ROOT, "x")).name,
    }
    assert got == {"groupcommit.fixture.qlock", "groupcommit.fixture.commit",
                   "qos.breaker", "query.bucket_cache", "qos.bucket",
                   "eventlog.file:" + os.path.join(REPO_ROOT, "x")}


def _traced_ingest(storage, create, app_cls, key_cls, monkeypatch, home):
    """One POST /events.json into a one-partition partlog while the test
    holds the partition's group-commit lock until the request waits on
    it: the stage names of the request's trace."""
    monkeypatch.setenv("PIO_TPU_HOME", str(home))
    for repo in ("METADATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "PL")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_PL_TYPE", "partlog")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_PL_PATH", str(home / "pl"))
    monkeypatch.setenv("PIO_TPU_PARTLOG_PARTITIONS", "1")
    storage.reset()
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "locks"))
    key = storage.get_meta_data_access_keys().insert(key_cls("", app_id))
    server = create(host="127.0.0.1", port=0).start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        body = json.dumps({"event": "rate", "entityType": "user",
                           "entityId": "u1",
                           "eventTime": "2026-03-01T10:00:00Z"}).encode()
        req = urllib.request.Request(
            f"{url}/events.json?accessKey={key}", data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "X-Pio-Trace": "locktrace"})
        answers = []
        committer = storage.get_levents()._committers[0]
        committer._commit_lock.acquire()
        try:
            t = threading.Thread(target=lambda: answers.append(
                urllib.request.urlopen(req, timeout=15).status))
            t.start()
            # the request has queued its payload: it now waits on the lock
            deadline = time.perf_counter() + 10
            while not committer._q and time.perf_counter() < deadline:
                time.sleep(0.001)
            time.sleep(0.005)
        finally:
            committer._commit_lock.release()
        t.join(timeout=15)
        assert answers == [201]
        with urllib.request.urlopen(f"{url}/traces.json?id=locktrace",
                                    timeout=15) as r:
            traces = json.load(r)["traces"]
        return {s["stage"] for tr in traces for s in tr["spans"]}
    finally:
        server.stop()
        storage.reset()


def test_contended_lock_gives_the_trace_a_lock_span(armed, monkeypatch,
                                                    tmp_path):
    armed("1")
    stages = {}
    for pkg, storage, create, app_cls, key_cls in (
            ("port", Storage, create_event_server, App, AccessKey),
            ("ref", RStorage, r_create, RApp, RAccessKey)):
        stages[pkg] = _traced_ingest(storage, create, app_cls, key_cls,
                                     monkeypatch, tmp_path / pkg)
    span = "lock.groupcommit.partlog-p0.commit"
    assert span in stages["ref"] and span in stages["port"]
