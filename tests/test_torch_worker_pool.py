"""The port's serving pool (``pio_tpu_torch/server/worker_pool.py``) on
the CPU: one module-scoped pool of 2 spawned workers over a stored
classification instance in SQLite, worker 0 the device worker
(``device="cpu"``) draining the batch lane, resident int8 scorers on.

In order: concurrent JSON and packed int8 queries answer as the CPU copy
and reach both workers, the sibling's go through the lane (worker 0's
``drained`` > 0, the sibling's fallbacks 0); ``/reload`` on either
worker rolls both; a crashed worker is respawned by the supervisor; and
``/undeploy`` stops the pool. Every wait has a deadline.
"""

import http.client
import json
import socket
import subprocess
import sys
import threading

import pytest
import torch

from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.http import PACKED_QUERY_CONTENT_TYPE
from pio_tpu_torch.server.query_server import QueryService
from pio_tpu_torch.server.worker_pool import ServingPool
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.tools.cli import main as cli_main
from pio_tpu_torch.workflow.core_workflow import (
    load_models_for_instance,
    run_train,
)
from pio_tpu_torch.workflow.engine_json import build_engine, load_variant
from test_torch_classification import APP, QUERIES, user_rows, variant
from test_torch_microbatch import (
    HTTP_S,
    JOIN_S,
    cls_variant,
    cpu_answers,
    train_cls,
    until,
)
from test_torch_similarproduct import seed_events

#: the pool's startup and a worker's respawn, seconds
READY_S = 120

#: the supervisor thread the respawn test starts and undeploy ends
SUPERVISOR = []


def request(port, method, path, body=b"", ctype="application/json"):
    """One request on a fresh connection (the kernel picks the worker)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
    try:
        conn.request(method, path, body, {"Content-Type": ctype})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """SQLite storage (the unset default) under a module home, resident
    int8 scorers on the CPU; spawned workers inherit the environment."""
    mp = pytest.MonkeyPatch()
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        mp.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", raising=False)
    mp.setenv("PIO_TPU_HOME", str(tmp_path_factory.mktemp("pool-home")))
    mp.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    mp.setenv("PIO_TPU_SERVE_WIRE", "int8")
    mp.setenv("PIO_TPU_LANE_TIMEOUT_S", "10")
    Storage.reset()
    seed_events(user_rows(), app=APP, reference=False)
    yield {"first": train_cls(1)}
    Storage.reset()
    mp.undo()


@pytest.fixture(scope="module")
def pool(home):
    pool = ServingPool(cls_variant(1), host="127.0.0.1", port=0,
                       n_workers=2, device_worker=True, device="cpu")
    pool.start()
    try:
        pool.wait_ready(timeout=READY_S)
        yield pool
    finally:
        pool.stop()


def test_concurrent_answers_and_the_lane(home, pool):
    want = cpu_answers(home["first"], QUERIES)
    packer = _packer(home["first"])
    frames = [packer.pack_query_body(b) for b in QUERIES]
    assert all(frames)
    got, seen = [], set()

    def client(k):
        for n in range(6):
            i = (k + n) % len(QUERIES)
            if n % 2:
                s, a = request(pool.port, "POST", "/queries.json", frames[i],
                               PACKED_QUERY_CONTENT_TYPE)
            else:
                s, a = request(pool.port, "POST", "/queries.json",
                               json.dumps(QUERIES[i]).encode())
            got.append((i, s, a))

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads) and len(got) == 96
    assert [(s, a) for i, s, a in got] == [(200, want[i]) for i, _, _ in got]
    # fresh connections reach both workers; the sibling's queries cross
    # the lane to worker 0 until it has drained some
    assert until(lambda: seen.add(request(pool.port, "GET",
                                          "/stats.json")[1]["worker"])
                 or seen == {0, 1})
    assert until(lambda: request(pool.port, "POST", "/queries.json",
                                 json.dumps(QUERIES[0]).encode())[0] == 200
                 and pool.worker_stats(0)["batchLane"]["drained"] > 0)
    device, sibling = pool.worker_stats(0), pool.worker_stats(1)
    assert device["batchLane"]["role"] == "drainer"
    assert device["poolSize"] == 2 and device["buckets"]["retraces"] == 0
    assert sibling["batchLane"]["role"] == "client"
    assert sibling["batchLane"]["enqueued"] > 0
    assert sum(sibling["batchLane"]["fallbacks"].values()) == 0


def _packer(iid):
    """A CPU service over ``iid`` that packs JSON bodies into frames."""
    engine, ep = build_engine(cls_variant(1))
    models = load_models_for_instance(iid, engine, ep,
                                      ComputeContext.create(device="cpu"))
    return QueryService(engine, ep, models, device="cpu")


def test_reload_rolls_both_workers(home, pool):
    new = train_cls(2)
    status, out = request(pool.port, "POST", "/reload", b"{}")
    assert status == 200 and out["engineInstanceId"] == new
    ids = {}

    def rolled():
        st = request(pool.port, "GET", "/")[1]
        ids[st["worker"]] = st["engineInstanceId"]
        return ids == {0: new, 1: new}

    assert until(rolled), ids
    want = cpu_answers(new, QUERIES)
    for i, body in enumerate(QUERIES):
        assert request(pool.port, "POST", "/queries.json",
                       json.dumps(body).encode()) == (200, want[i])


def test_crashed_worker_is_respawned(pool):
    sup = threading.Thread(target=pool.wait, kwargs={"poll_s": 0.1},
                           daemon=True)
    sup.start()
    victim = pool._procs[1]
    victim.terminate()
    victim.join(HTTP_S)
    assert until(lambda: pool._procs[1] is not victim
                 and pool._procs[1].is_alive()
                 and pool._health_ports[1] > 0, READY_S)
    assert pool._respawns[1]["crash"] == 1
    assert until(lambda: pool.worker_stats(1)["worker"] == 1)
    assert request(pool.port, "POST", "/queries.json",
                   json.dumps(QUERIES[0]).encode())[0] == 200
    SUPERVISOR.append(sup)


def test_undeploy_stops_the_pool(pool):
    status, out = request(pool.port, "POST", "/undeploy", b"{}")
    assert status == 200 and out == {"message": "undeployed"}
    for sup in SUPERVISOR:
        sup.join(JOIN_S)
        assert not sup.is_alive()
    assert until(lambda: all(not p.is_alive() for p in pool._procs))


@pytest.mark.cuda
def test_device_worker_on_the_card_answers_as_the_cpu(home):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pool = ServingPool(cls_variant(1), host="127.0.0.1", port=0,
                       n_workers=2, device_worker=True, device="cuda")
    pool.start()
    try:
        pool.wait_ready(timeout=READY_S)
        iid = request(pool.port, "GET", "/")[1]["engineInstanceId"]
        want = cpu_answers(iid, QUERIES)
        for _ in range(3):
            for i, body in enumerate(QUERIES):
                assert request(pool.port, "POST", "/queries.json",
                               json.dumps(body).encode()) == (200, want[i])
        assert pool.worker_stats(0)["residency"]["measuredBytes"] > 0
    finally:
        pool.stop()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stored_engine_json(tmp_path):
    """An engine.json of the module's app and an instance trained
    through it (``deploy --engine-json`` looks instances up by its
    path): (path, instance id)."""
    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps(variant("logreg")))
    v = load_variant(str(ej))
    engine, ep = build_engine(v)
    return str(ej), run_train(engine, ep, v,
                              ctx=ComputeContext.create(device="cpu"))


def test_cli_pool_serves_and_undeploys(home, tmp_path):
    """``deploy --workers 2 --device-worker --device cpu`` as a process:
    ready, answering as the CPU copy, ended by ``undeploy`` with exit 0."""
    ej, iid = stored_engine_json(tmp_path)
    port = free_port()
    out = tmp_path / "deploy.log"
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", "deploy", "--engine-json",
             ej, "--ip", "127.0.0.1", "--port", str(port), "--workers", "2",
             "--device-worker", "--device", "cpu"],
            stdout=f, stderr=subprocess.STDOUT)
    try:
        # "listening" once the pool, worker 0 included, is ready
        assert until(lambda: proc.poll() is not None
                     or "listening" in out.read_text(), READY_S)
        assert "pool (2 workers, device worker 0) listening" in \
            out.read_text(), out.read_text()
        want = cpu_answers(iid, QUERIES)
        for i, body in enumerate(QUERIES):
            assert request(port, "POST", "/queries.json",
                           json.dumps(body).encode()) == (200, want[i])
        assert request(port, "POST", "/undeploy", b"{}")[0] == 200
        assert proc.wait(timeout=JOIN_S) == 0, out.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=JOIN_S)


def test_cli_pool_refuses_without_its_device(home, tmp_path, capsys):
    """The device worker resolves ``cuda``: without a card it dies at
    startup and ``deploy`` exits 1 instead of serving on the CPU; a
    device worker needs a pool, and a pool without one runs on the CPU
    only when asked to."""
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    ej, _ = stored_engine_json(tmp_path)
    argv = ["deploy", "--engine-json", ej, "--ip", "127.0.0.1", "--port",
            str(free_port())]
    assert cli_main(argv + ["--device-worker"]) == 1
    assert "needs --workers > 1" in capsys.readouterr().err
    assert cli_main(argv + ["--workers", "2"]) == 1
    assert "device='cpu' for a pool on the CPU" in capsys.readouterr().err
    assert cli_main(argv + ["--workers", "2", "--device-worker"]) == 1
    assert "device worker exited during startup" in capsys.readouterr().err


@pytest.mark.parametrize("device", [None, "cuda"])
def test_pool_without_a_device_worker_needs_the_cpu_asked(device):
    """Without a device worker every worker serves on the CPU: the pool
    itself refuses any device but an explicit ``cpu``, before it binds a
    socket or spawns a worker."""
    with pytest.raises(ValueError, match="only through device_worker"):
        ServingPool(cls_variant(1), host="127.0.0.1", port=0, n_workers=2,
                    device_worker=False, device=device)
