"""The port's profile hook against the JAX package's, on the CPU.

- ``DeviceProfileHook.to_dict`` gives the reference's sequence through N
  captures, the captures after the window, ``restart`` (rotation into
  ``capture-NNNN``, a new N), a restart while a capture is active, and on
  an unconfigured hook (the reference's ``jax.profiler`` calls replaced
  by recorders: the hook's state machine is what is compared; the port's
  runs ``torch.profiler`` on the CPU).
- A CPU capture writes a parseable Chrome trace into ``capture-0001``.
- A hook that finds another ``torch.profiler`` session running disables
  itself, says so under ``error``, and the execution it wraps still runs.
- The query server's ``GET`` and ``POST /debug/profile.json`` on a CPU
  deploy with ``PIO_TPU_PROFILE``: the first N executions are traced,
  ``?restart=1&n=`` captures the next ones into ``capture-0001``, and a
  bad ``n`` answers 400.
- The window guard's arithmetic: more than one group of sentinels seen
  means both ends of the window were recorded.
"""

import datetime as dt
import json
import os

import numpy as np
import pytest
import torch

import pio_tpu.obs.profile as rprof
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.obs import profile as pprof
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.http import HTTPError, Request
from pio_tpu_torch.server.query_server import deploy_query_server
from pio_tpu_torch.storage.records import App
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.classification import Query
from pio_tpu_torch.workflow.core_workflow import run_train
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict


@pytest.fixture()
def fake_jax_profiler(monkeypatch):
    """The reference hook's jax.profiler calls, recorded."""
    import jax

    calls = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: calls.append(("start", d)))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: calls.append(("stop",)))
    return calls


def _script(hook, base):
    """The hook's states through a scripted sequence, directories made
    relative to ``base``."""
    states = []

    def note(d):
        d = dict(d)
        if d.get("directory"):
            d["directory"] = os.path.relpath(d["directory"], base)
        states.append(d)

    note(hook.to_dict())
    for _ in range(3):
        with hook.capture():
            note(hook.to_dict())
        note(hook.to_dict())
    with hook.capture():  # past the window: inert
        pass
    note(hook.to_dict())
    note(hook.restart())
    with hook.capture():
        note(hook.to_dict())
    note(hook.restart(2))  # while active: the capture is stopped first
    for _ in range(2):
        with hook.capture():
            pass
        note(hook.to_dict())
    return states


def test_to_dict_sequence_matches_reference(tmp_path, fake_jax_profiler):
    ref = _script(rprof.DeviceProfileHook(str(tmp_path / "r"), 3),
                  str(tmp_path / "r"))
    port = _script(pprof.DeviceProfileHook(str(tmp_path / "p"), 3),
                   str(tmp_path / "p"))
    assert port == ref
    assert [c[0] for c in fake_jax_profiler] == \
        ["start", "stop", "start", "stop", "start", "stop"]
    for sub in (".", "capture-0001", "capture-0002"):
        with open(tmp_path / "p" / sub / pprof.TRACE_FILE) as f:
            assert "traceEvents" in json.load(f)


def test_unconfigured_hook_matches_reference():
    for h in (rprof.DeviceProfileHook(), pprof.DeviceProfileHook()):
        with h.capture():
            pass
    ref, port = rprof.DeviceProfileHook(), pprof.DeviceProfileHook()
    assert port.to_dict() == ref.to_dict()
    assert port.restart() == ref.restart()


def test_cpu_capture_writes_a_trace_into_capture_0001(tmp_path):
    hook = pprof.DeviceProfileHook(str(tmp_path), 2)
    hook.restart()
    for _ in range(2):
        with hook.capture():
            torch.ones(64).mul(2).sum()
    path = tmp_path / "capture-0001" / pprof.TRACE_FILE
    with open(path) as f:
        trace = json.load(f)
    assert isinstance(trace["traceEvents"], list)
    assert hook.to_dict()["captures"] == 1 and not hook.to_dict()["armed"]


def test_a_running_session_disables_the_hook(tmp_path):
    hook = pprof.DeviceProfileHook(str(tmp_path), 2)
    ran = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert pprof.profiler_running()
        with hook.capture():
            ran.append(1)
    d = hook.to_dict()
    assert ran == [1]
    assert not d["armed"] and not d["active"] and "running" in d["error"]
    with hook.capture():  # stays off until re-armed
        ran.append(2)
    assert not os.path.exists(tmp_path / pprof.TRACE_FILE)
    assert "error" not in hook.restart()


@pytest.mark.parametrize("name,sentinel", [
    ("at::cuda::spin_kernel(long)", True), ("spin_kernel", True),
    ("void spin_kernels_of_mine<float>()", False),
    ("void embedding_bag_kernel<float, 4>(float const*)", False)])
def test_is_sentinel(name, sentinel):
    assert pprof.is_sentinel(name) is sentinel


@pytest.mark.parametrize("seen,complete", [
    (0, False), (pprof.SENTINELS, False), (pprof.SENTINELS + 1, True),
    (2 * pprof.SENTINELS, True)])
def test_window_complete(seen, complete):
    assert pprof.window_complete(seen) is complete


# ------------------------------------------------------ the query server
T0 = dt.datetime(2026, 5, 1, tzinfo=dt.timezone.utc)
VARIANT = {
    "id": "cls-profile",
    "engineFactory": "templates.classification",
    "datasource": {"params": {"app_name": "profile-test"}},
    "algorithms": [{"name": "naivebayes", "params": {}}],
}


@pytest.fixture()
def deployed(tmp_home, monkeypatch, tmp_path):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    monkeypatch.setenv("PIO_TPU_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setenv("PIO_TPU_PROFILE_EXECUTIONS", "2")
    Storage.reset()
    app_id = Storage.get_meta_data_apps().insert(App(0, "profile-test"))
    le = Storage.get_levents()
    rng = np.random.default_rng(3)
    for n in range(18):
        attrs = rng.integers(0, 3, size=3)
        attrs[n % 3] += 6
        props = {f"attr{j}": int(attrs[j]) for j in range(3)}
        props["plan"] = ("basic", "premium", "pro")[n % 3]
        le.insert(Event("$set", "user", f"u{n}", properties=props,
                        event_time=T0 + dt.timedelta(minutes=n)), app_id)
    v = variant_from_dict(VARIANT)
    engine, ep = build_engine(v)
    run_train(engine, ep, v, ctx=ComputeContext.create(seed=0, device="cpu"))
    server = deploy_query_server(v, host="127.0.0.1", port=0, device="cpu")
    yield server.service, tmp_path / "prof"
    server.close()
    Storage.reset()


def test_query_server_profile_routes(deployed):
    svc, prof = deployed
    router = svc.router()

    def call(method, params=None):
        return router.dispatch(Request(method, "/debug/profile.json",
                                       params or {}, None,
                                       client_addr="127.0.0.1"))

    status, d = call("GET")
    assert status == 200 and d["armed"] and d["firstN"] == 2
    for _ in range(2):
        svc._predict_one(Query(attrs=(9.0, 1.0, 1.0)))
    assert (prof / pprof.TRACE_FILE).exists()
    assert call("GET")[1]["armed"] is False
    assert call("POST")[1]["captures"] == 0  # no restart asked
    status, d = call("POST", {"restart": "1", "n": "3"})
    assert status == 200 and d["restarted"] and d["firstN"] == 3
    assert d["directory"].endswith("capture-0001")
    for _ in range(3):
        svc._predict_one(Query(attrs=(1.0, 9.0, 1.0)))
    with open(prof / "capture-0001" / pprof.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    d = call("GET")[1]
    assert (d["captures"], d["seen"], d["armed"]) == (1, 3, False)
    with pytest.raises(HTTPError) as e:
        call("POST", {"restart": "1", "n": "many"})
    assert e.value.status == 400
