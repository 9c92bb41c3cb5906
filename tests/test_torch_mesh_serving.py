"""Mesh-sharded serving in the port against the JAX package's, on the CPU.

- The sharded top-N scorer over four CPU devices against the reference's
  ``DeviceTopNScorer`` on a 4-device mesh of the forced host devices
  (``tests/conftest.py``), both tables row-sharded and padded to a shard
  multiple: the same items in the same order, scores within ``1e-6`` (a
  rank-8 dot summed in another order by another BLAS), exclusions
  honoured, pad columns never returned; its ``sharding_info`` carries the
  reference's keys.
- The recommendation template trained with ``PIO_TPU_SHARDED_PERSIST=1``
  deploys with ``PIO_TPU_MESH_SERVE=1`` over ``("cpu",) * 4``: the answers
  are the unsharded server's, ``/stats.json`` has the ``sharding`` block,
  ``/metrics`` the shard counters, ``/device.json`` the ``shard`` ledger,
  and ``/reload`` keeps it sharded. The gate off gives ``{"enabled":
  false}``. Mirrors ``tests/test_partition_rules.py:345-392``.
- One ``mesh_worker`` pool of 2 spawned workers over SQLite: worker 0
  serves sharded, worker 1 unsharded on the CPU, every answer the
  unsharded model's.
"""

import http.client
import json
import time

import jax
import numpy as np
import pytest

from pio_tpu.obs import monotonic_s
from pio_tpu.ops.topn import DeviceTopNScorer as JaxScorer
from pio_tpu_torch.controller.params import params_from_dict
from pio_tpu_torch.ops.topn import DeviceTopNScorer
from pio_tpu_torch.server.query_server import (
    create_query_server,
    deploy_query_server,
)
from pio_tpu_torch.server.worker_pool import ServingPool
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.templates.recommendation import Query
from pio_tpu_torch.workflow import shard_store
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from pio_tpu_torch.workflow.engine_json import variant_from_dict
from test_torch_recommendation import (  # noqa: F401  (fixture)
    VARIANT,
    _seed_port,
    _train_port,
    memory_storage,
)

MESH = ("cpu",) * 4
BODIES = [
    {"user": "u0", "num": 4},
    {"user": "u7", "num": 3, "blackList": ["i4", "i5"]},
    {"user": "u2", "item": "i1"},
    {"user": "u11", "num": 8},
    {"user": "stranger"},
]


def _jax_mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


def _tables(seed=0, n_rows=37, n_cols=53, rank=8):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n_rows, rank)).astype(np.float32)
    cols = rng.normal(size=(n_cols, rank)).astype(np.float32)
    cols[9] = cols[4]  # an exact tie across shards: lower index first
    return rows, cols


@pytest.mark.parametrize("n,with_exclusions", [
    (1, False), (10, False), (10, True), (53, False), (16, True),
])
def test_sharded_scorer_matches_reference_mesh(n, with_exclusions,
                                               monkeypatch):
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "device")
    rows, cols = _tables()
    got_sc = DeviceTopNScorer(rows, cols, device="cpu", mesh=MESH)
    want_sc = JaxScorer(rows, cols, mesh=_jax_mesh(4))
    assert got_sc.mesh_sharded and want_sc.mesh_sharded
    codes = np.arange(rows.shape[0], dtype=np.int32)
    ex = None
    if with_exclusions:
        # pad slots (>= n_cols) mark unused exclusion slots
        ex = np.random.default_rng(1).integers(0, 60, (len(codes), 6))
        ex = ex.astype(np.int32)
    gi, gv = got_sc.top_n_batch(codes, n, ex)
    wi, wv = want_sc.top_n_batch(codes, n, ex)
    np.testing.assert_array_equal(gi, wi)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=0, atol=1e-6)
    assert gi.max() < cols.shape[0]  # no pad column answers
    if ex is not None:
        for b in range(len(codes)):
            assert not set(gi[b][np.isfinite(gv[b])]) & set(ex[b])
    np.testing.assert_allclose(got_sc.scores_batch(codes),
                               want_sc.scores_batch(codes), atol=1e-6)


def test_sharding_block_has_the_reference_keys(monkeypatch):
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "device")
    rows, cols = _tables()
    got = DeviceTopNScorer(rows, cols, device="cpu", mesh=MESH)
    want = JaxScorer(rows, cols, mesh=_jax_mesh(4)).sharding_info()
    info = got.sharding_info()
    assert set(info) == set(want)
    for k in ("meshShape", "nDevices", "rows", "cols", "colsPadded",
              "totalBytes"):
        assert info[k] == want[k], k
    # what each device holds: a padded quarter of both tables
    assert info["bytesPerDevice"] == (40 + 56) // 4 * 8 * 4
    assert sum(b for _, b in got.shard_bytes()) == (40 + 56) * 8 * 4
    # a one-device mesh is the plain path, as the reference's
    one = DeviceTopNScorer(rows, cols, device="cpu", mesh=("cpu",))
    assert not one.mesh_sharded and one.sharding_info() is None


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/queries.json", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
        return r.status, (json.loads(body) if path.endswith(".json")
                          else body.decode())
    finally:
        conn.close()


def _same(got, want, where):
    """The same items in the same order, scores within 1e-5: a shard
    scores its columns in its own product, so a score may differ from the
    unsharded one in its last bits."""
    status, body = got
    assert status == 200, (where, body)
    g, w = body["itemScores"], want["itemScores"]
    assert [x["item"] for x in g] == [x["item"] for x in w], where
    np.testing.assert_allclose([x["score"] for x in g],
                               [x["score"] for x in w], rtol=0, atol=1e-5,
                               err_msg=str(where))


def _unsharded_answers(engine, ep, models):
    algo = engine.algorithm_class_map["als"](ep.algorithm_params_list[0][1])
    return [algo.predict(models[0], params_from_dict(Query, b)).to_dict()
            for b in BODIES]


def test_sharded_persist_deploy_round_trip(memory_storage, monkeypatch):
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "device")
    monkeypatch.setenv("PIO_TPU_SHARDED_PERSIST", "1")
    _seed_port()
    engine, ep, ctx, iid = _train_port()
    store = Storage.get_model_data_models()
    assert store.get(iid + shard_store.SHARD_MANIFEST_SUFFIX) is not None
    assert shard_store.verify_manifest(store, iid) == 2
    want = _unsharded_answers(engine, ep,
                              load_models_for_instance(iid, engine, ep, ctx))
    monkeypatch.setenv("PIO_TPU_MESH_SERVE", "1")
    server = deploy_query_server(variant_from_dict(VARIANT),
                                 host="127.0.0.1", port=0, device="cpu",
                                 mesh_devices=MESH)
    with server:
        for body, w in zip(BODIES, want):
            _same(_post(server.port, body), w, body)
        _, stats = _get(server.port, "/stats.json")
        sh = stats["sharding"]
        assert sh["enabled"] and sh["meshDevices"] == 4
        (m,) = sh["models"]
        assert m["model"] == "ALSModel" and m["nDevices"] == 4
        assert m["rows"] == [12, 6] and m["cols"] == [8, 6]
        assert m["bytesPerDevice"] == (3 + 2) * 6 * 4
        _, metrics = _get(server.port, "/metrics")
        assert ('pio_tpu_shard_bytes_placed_total{engine_id="rec-e2e"} 480'
                in metrics)
        assert "pio_tpu_shard_gather_fallback_total" in metrics
        _, device = _get(server.port, "/device.json")
        assert device["ledger"]["byCategory"]["shard"] == 480
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("POST", "/reload")
        r = conn.getresponse()
        assert r.status == 200, r.read()
        r.read()
        conn.close()
        for body, w in zip(BODIES, want):
            _same(_post(server.port, body), w, body)
        _, stats = _get(server.port, "/stats.json")
        assert stats["sharding"]["enabled"]
        _, device = _get(server.port, "/device.json")
        assert device["ledger"]["byCategory"]["shard"] == 480


def test_gate_off_gives_no_sharding(memory_storage, monkeypatch):
    monkeypatch.delenv("PIO_TPU_MESH_SERVE", raising=False)
    _seed_port()
    engine, ep, ctx, iid = _train_port()
    models = load_models_for_instance(iid, engine, ep, ctx)
    server = create_query_server(engine, ep, models, port=0, device="cpu",
                                 mesh_devices=MESH)
    with server:
        _, stats = _get(server.port, "/stats.json")
        assert stats["sharding"] == {"enabled": False}
        assert not models[0].scorer().mesh_sharded


@pytest.fixture()
def sqlite_home(tmp_path, monkeypatch):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE",
                           raising=False)
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    Storage.reset()
    yield tmp_path
    Storage.reset()


def test_mesh_worker_pool(sqlite_home, monkeypatch):
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "device")
    monkeypatch.setenv("PIO_TPU_SHARDED_PERSIST", "1")
    _seed_port()
    engine, ep, ctx, iid = _train_port()
    want = _unsharded_answers(engine, ep,
                              load_models_for_instance(iid, engine, ep, ctx))
    pool = ServingPool(variant_from_dict(VARIANT), host="127.0.0.1", port=0,
                       n_workers=2, mesh_worker=True, device="cpu",
                       mesh_devices=MESH)
    pool.start()
    try:
        pool.wait_ready(timeout=120)
        deadline = monotonic_s() + 120
        while pool._health_ports[1] <= 0 or not pool._ready(
                pool._health_ports[1]):
            assert monotonic_s() < deadline, "worker 1 never ready"
            time.sleep(0.1)
        for body, w in zip(BODIES * 3, want * 3):
            _same(_post(pool.port, body), w, body)
        owner, sibling = pool.worker_stats(0), pool.worker_stats(1)
        assert owner["sharding"]["enabled"]
        assert owner["sharding"]["models"][0]["nDevices"] == 4
        assert sibling["sharding"] == {"enabled": False}
    finally:
        pool.stop()
