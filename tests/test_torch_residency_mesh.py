"""The resident linear scorer over a serving mesh, in the port against the
JAX package's, on the CPU.

- ``ResidentLinearScorer(..., mesh=("cpu",) * n)`` against the
  reference's on a JAX mesh of the same ``n`` (2 and 4) of the forced
  host devices (``tests/conftest.py``), both row-sharding W on the
  contraction dimension: the logits within ``1e-5`` relative (a product
  split in ``n`` partial sums, summed in another order), the codes equal
  except rows whose top two logits are within that tolerance (near-ties,
  counted), on three wires: ``int8`` (codes against the folded scales),
  ``float32``, and ``bfloat16`` (a model trained on the bf16 feature wire
  serves float32 queries: weights and features on the bf16 grid).
- A D that does not divide the mesh: both place W whole and set
  ``mesh_fallback``; the codes are the unsharded scorer's.
- The budget check, the failpoints ``scorer.h2d.ship`` and
  ``scorer.donate.dispatch``, and the device ledger (one ``resident``
  entry a shard, released on retire).
- Through the query server with ``PIO_TPU_MESH_SERVE=1`` and
  ``mesh_devices=("cpu",) * 4``, against the reference's query server on
  its 8-device context mesh: the residency block's ``sharded`` and the
  scorer's ``mesh_fallback`` agree at D = 8 (sharded in both) and D = 3
  (indivisible in both), the answers are the reference's, and a
  ``/reload`` leaves one generation of shards on the ledger.
"""

import datetime as dt
import http.client
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu import faults as ref_faults
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.parallel.partition import (
    DeviceBudgetExceeded as JaxBudgetExceeded,
)
from pio_tpu.server import residency as jres
from pio_tpu.server.http import Request as JaxRequest
from pio_tpu.server.query_server import QueryServerService
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch import faults
from pio_tpu_torch.obs import devicewatch
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.parallel.partition import DeviceBudgetExceeded
from pio_tpu_torch.server.query_server import deploy_query_server
from pio_tpu_torch.server.residency import ResidentLinearScorer
from pio_tpu_torch.workflow.core_workflow import run_train
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from test_torch_similarproduct import (  # noqa: F401  (fixture)
    T0,
    memory_storage,
    seed_events,
)

APP = "cls-mesh"
RTOL = 1e-5


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv("PIO_TPU_FAULTS", raising=False)
    faults.uninstall()
    ref_faults.uninstall()
    yield
    faults.uninstall()
    ref_faults.uninstall()


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _case(monkeypatch, wire, d=16, c=5, n=48, seed=3):
    """Weights, bias, scales and features of one wire, seeded."""
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, c)).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    s = (np.abs(rng.normal(size=d)) / 127.0 + 1e-3).astype(np.float32)
    X = (rng.normal(size=(n, d)) * s * 40).astype(np.float32)
    if wire == "int8":
        monkeypatch.setenv("PIO_TPU_SERVE_WIRE", "int8")
        return W, b, s, X
    monkeypatch.setenv("PIO_TPU_SERVE_WIRE", "float32")
    if wire == "bfloat16":
        W, b, X = _bf16(W), _bf16(b), _bf16(X)
    return W, b, None, X


def _port_logits(sc, n):
    return sc._out_bufs[n]._buf.numpy()


def _ref_logits(sc, n):
    return sc._out_bufs[n].array()


def _near_ties(logits, tol=RTOL):
    top2 = np.sort(logits, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    return gap <= tol * np.maximum(1.0, np.abs(top2[:, 1]))


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("wire", ["int8", "float32", "bfloat16"])
def test_sharded_scorer_matches_reference_mesh(monkeypatch, n_dev, wire):
    W, b, s, X = _case(monkeypatch, wire)
    port = ResidentLinearScorer(W, b, scales=s, name="t", device="cpu",
                                mesh=("cpu",) * n_dev)
    ref = jres.ResidentLinearScorer(W, b, scales=s, name="t",
                                    mesh=_jax_mesh(n_dev))
    assert port.sharded and ref.to_dict()["sharded"]
    assert port.mesh_fallback is ref.mesh_fallback is False
    assert port.wire == ref.wire
    got, want = port.score_codes(X), ref.score_codes(X)
    lp, lr = _port_logits(port, len(X)), _ref_logits(ref, len(X))
    np.testing.assert_allclose(lp, lr, rtol=RTOL, atol=RTOL)
    ties = _near_ties(lr)
    assert ties.sum() <= 2, f"{ties.sum()} near-ties"
    np.testing.assert_array_equal(got[~ties], want[~ties])
    # the sharded product is the unsharded one's within the same bound
    one = ResidentLinearScorer(W, b, scales=s, name="t", device="cpu")
    one.score_codes(X)
    np.testing.assert_allclose(_port_logits(one, len(X)), lp, rtol=RTOL,
                               atol=RTOL)
    assert port.to_dict()["sharded"] and not one.to_dict()["sharded"]
    assert port.h2d_bytes == ref.h2d_bytes == X.size * (
        1 if wire == "int8" else 4)


@pytest.mark.parametrize("d,n_dev", [(6, 4), (9, 2), (3, 4)])
def test_indivisible_d_falls_back_to_one_device(monkeypatch, d, n_dev):
    W, b, s, X = _case(monkeypatch, "float32", d=d)
    port = ResidentLinearScorer(W, b, name="t", device="cpu",
                                mesh=("cpu",) * n_dev)
    ref = jres.ResidentLinearScorer(W, b, name="t", mesh=_jax_mesh(n_dev))
    assert port.mesh_fallback is ref.mesh_fallback is True
    assert not port.sharded and not ref.to_dict()["sharded"]
    assert port.to_dict()["meshFallback"] is True
    assert port.device == torch.device("cpu")  # the mesh's first device
    np.testing.assert_array_equal(port.score_codes(X), ref.score_codes(X))
    # a mesh of one device is no mesh, as in the reference
    assert not ResidentLinearScorer(W, b, device="cpu",
                                    mesh=("cpu",)).mesh_fallback


def test_budget_check_matches_reference(monkeypatch):
    W, b, s, _ = _case(monkeypatch, "float32", d=16, c=4)
    nbytes = W.nbytes + b.nbytes  # 272
    for budget, n_dev, raises in ((nbytes - 1, 1, True), (nbytes, 1, False),
                                  (-(-nbytes // 4) - 1, 4, True),
                                  (-(-nbytes // 4), 4, False)):
        monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", str(budget))
        mesh = ("cpu",) * n_dev if n_dev > 1 else None
        jmesh = _jax_mesh(n_dev) if n_dev > 1 else None
        if raises:
            with pytest.raises(DeviceBudgetExceeded, match="resident"):
                ResidentLinearScorer(W, b, device="cpu", mesh=mesh)
            with pytest.raises(JaxBudgetExceeded, match="resident"):
                jres.ResidentLinearScorer(W, b, mesh=jmesh)
        else:
            ResidentLinearScorer(W, b, device="cpu", mesh=mesh)
            jres.ResidentLinearScorer(W, b, mesh=jmesh)


@pytest.mark.parametrize("point", ["scorer.h2d.ship",
                                   "scorer.donate.dispatch"])
def test_failpoints_fire_where_the_reference_does(monkeypatch, point):
    W, b, s, X = _case(monkeypatch, "int8")
    port = ResidentLinearScorer(W, b, scales=s, device="cpu",
                                mesh=("cpu",) * 2)
    ref = jres.ResidentLinearScorer(W, b, scales=s, mesh=_jax_mesh(2))
    faults.install(f"{point}=error:once")
    ref_faults.install(f"{point}=error:once")
    with pytest.raises(faults.FaultInjected, match=point):
        port.score_codes(X)
    with pytest.raises(ref_faults.FaultInjected, match=point):
        ref.score_codes(X)
    # once: the next dispatch is clean, and the failed one counted nothing
    assert port.dispatches == ref.dispatches == 0
    np.testing.assert_array_equal(port.score_codes(X), ref.score_codes(X))
    assert faults.trigger_counts() == ref_faults.trigger_counts() == {
        (point, "error"): 1}


def test_ledger_books_one_entry_a_shard(monkeypatch):
    W, b, s, X = _case(monkeypatch, "float32", d=16, c=4)
    watch = devicewatch.DeviceWatch(device=torch.device("cpu"))
    with devicewatch.watching(watch, sample=False):
        sc = ResidentLinearScorer(W, b, name="lr", device="cpu",
                                  mesh=("cpu",) * 4)
        rows = [r for r in watch.payload()["placements"]
                if r["category"] == "resident"]
        assert len(rows) == 4
        assert sorted(r["bytes"] for r in rows) == [64, 64, 64, 64 + 16]
        assert watch.ledger_bytes() == sc.placed_bytes
        sc.retire()
        assert watch.ledger_bytes() == 0
        assert sc.to_dict()["sharded"] and sc.retired


# ----------------------------------------------------- through the server
def _users(n_attrs, per_plan=8, seed=7):
    """Three plans, each user's attributes in 0-2 with the plan's own
    raised (``tests/test_torch_classification.py``'s users, wider)."""
    rng = np.random.default_rng(seed)
    rows, k = [], 0
    for plan, hot in zip(("basic", "premium", "pro"), range(3)):
        for _ in range(per_plan):
            attrs = rng.integers(0, 3, size=n_attrs)
            attrs[hot] += 6
            props = {f"attr{j}": int(attrs[j]) for j in range(n_attrs)}
            props["plan"] = plan
            rows.append(("$set", "user", f"u{k:03d}", None, props,
                         T0 + dt.timedelta(minutes=k)))
            k += 1
    return rows


def _variant(n_attrs):
    return {"id": f"cls-mesh-{n_attrs}",
            "engineFactory": "templates.classification",
            "datasource": {"params": {
                "app_name": APP,
                "attrs": [f"attr{j}" for j in range(n_attrs)]}},
            "algorithms": [{"name": "naivebayes",
                            "params": {"lambda_": 1.0}}]}


def _ref_query(svc, body):
    code, resp = svc.query(JaxRequest(
        "POST", "/queries.json", {}, body, raw_body=json.dumps(body).encode()))
    assert code == 200, (code, resp)
    raw = resp.body if hasattr(resp, "body") else resp
    return json.loads(raw) if isinstance(raw, (str, bytes)) else raw


def _post(conn, body, path="/queries.json"):
    conn.request("POST", path, json.dumps(body).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _get(conn, path):
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("n_attrs,sharded", [(8, True), (3, False)])
def test_query_server_residency_block_matches_reference(
        memory_storage, monkeypatch, n_attrs, sharded):
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_SERVE_WIRE", "float32")
    monkeypatch.setenv("PIO_TPU_MESH_SERVE", "1")
    seed_events(_users(n_attrs), app=APP)
    v = variant_from_dict(_variant(n_attrs))
    engine, ep = build_engine(v)
    ctx = ComputeContext.create(seed=0, device="cpu")
    run_train(engine, ep, v, ctx=ctx)
    jv = jax_variant_from_dict(_variant(n_attrs))
    jengine, jep = jax_build_engine(jv)
    jctx = JaxContext.create(seed=0)
    jax_run_train(jengine, jep, jv, ctx=jctx)
    jsvc = QueryServerService(jv, ctx=jctx)
    (jsc,) = jsvc._resident
    _, jstats = jsvc.get_stats(JaxRequest("GET", "/stats.json", {}, None))
    (jentry,) = jstats["residency"]["scorers"]
    assert jentry["sharded"] is sharded and jsc.mesh_fallback is not sharded

    bodies = [{"attrs": [float((q + j) % 7) for j in range(n_attrs)]}
              for q in range(6)]
    server = deploy_query_server(v, port=0, device="cpu",
                                 mesh_devices=("cpu",) * 4)
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        for body in bodies:
            status, got = _post(conn, body)
            assert status == 200, got
            assert got == _ref_query(jsvc, body), body
        status, stats = _get(conn, "/stats.json")
        assert status == 200
        (entry,) = stats["residency"]["scorers"]
        assert entry["sharded"] is jentry["sharded"]
        assert entry["meshFallback"] is jsc.mesh_fallback
        _, device = _get(conn, "/device.json")
        rows = [r for r in device["placements"]
                if r["category"] == "resident"]
        assert len(rows) == (4 if sharded else 1)
        # a /reload places the new generation's shards and retires the
        # old ones: one generation on the ledger
        old = server.service._gen.scorers()[0]
        status, _ = _post(conn, {}, "/reload")
        assert status == 200
        _, device = _get(conn, "/device.json")
        rows = [r for r in device["placements"]
                if r["category"] == "resident"]
        assert len(rows) == (4 if sharded else 1)
        assert old.retired
        status, got = _post(conn, bodies[0])
        assert status == 200
        conn.close()
