"""``python -m pio_tpu_torch`` against ``python -m pio_tpu``, on the CPU.

- The app, channel and access-key verbs, run in-process through each
  package's ``main([...])`` on its own SQLite home, print the same lines
  and exit with the same codes (generated keys aside).
- ``import`` then ``export`` of the same JSON lines writes the reference
  export's bytes.
- ``status`` reports a healthy and a broken configuration.
- ``train``, ``batchpredict`` and ``eval`` with ``--device cpu`` give the
  reference's answers on the same events: the port's ALS starts from the
  reference's ``jax.random`` init (the two packages draw different
  streams), and its factors are held to 1e-4 of the largest factor (the
  recommendation trainer's tolerance in chip_smoke.py, ``ALS_FACTOR_TOL``:
  the same f32 solves in another summation order), its scores (rank-8
  dots of those factors) to ``1e-3`` and its sweep's scores to ``rtol =
  1e-3`` (that of tests/test_torch_evaluation.py).
- Deploy falls back to the last known good instance when the newest blob
  fails its checksum.
- Without a card, the device verbs exit 1 with resolve_device's message.
- The ops plane's verbs: ``runs`` (list, ``--json``, ``-n``, ``--diff``
  with its exit codes and ``--threshold``) and ``top --once`` print the
  reference's lines on the same ledger rows and the same ``/device.json``
  payload; ``status --device cpu`` opens no CUDA device; ``train
  --profile-dir --status-port 0 --device cpu`` prints its sidecar's port,
  writes a parseable trace and a COMPLETED ledger row; ``shell`` preloads
  ``torch`` where the reference preloads jax.
- The quickstart through real processes: app new → eventserver → batch
  ingest → train → deploy → query → undeploy, each with a time limit.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.obs import monotonic_s
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.tools.cli import main as jax_main
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import load_variant as jax_load_variant
from pio_tpu_torch.models import als as port_als
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.query_server import deploy_query_server
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.tools.cli import main
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from pio_tpu_torch.workflow.engine_json import build_engine, load_variant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY_RE = re.compile(r"[A-Za-z0-9_-]{43}")
FACTOR_TOL = 1e-4  # of max |factor|
SCORE_ATOL = 1e-3
EVAL_RTOL = 1e-3


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    """Unset storage config (the SQLite default), no native builds, and a
    helper that points both packages at one home."""
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE",
                           raising=False)
    monkeypatch.setenv("PIO_TPU_NO_NATIVE", "1")
    monkeypatch.setenv("PIO_TPU_TRAIN_STATUS_PORT", "-1")
    Storage.reset()
    JaxStorage.reset()

    def use(name):
        monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path / name))
        return tmp_path / name

    yield use
    Storage.reset()
    JaxStorage.reset()


def run(fn, argv, capsys):
    """(exit code, stdout, stderr) of one CLI call, generated keys
    replaced by a placeholder."""
    try:
        code = fn(argv)
    except SystemExit as e:
        code = e.code
    out, err = capsys.readouterr()
    return code, KEY_RE.sub("<key>", out), KEY_RE.sub("<key>", err)


def crud_script(key_of):
    return [
        ["app", "new", "shop"],
        ["app", "new", "shop"],
        ["app", "new", "blog", "--description", "a blog"],
        ["app", "list"],
        ["accesskey", "new", "shop", "--events", "rate,buy"],
        ["accesskey", "list"],
        ["accesskey", "list", "shop"],
        ["accesskey", "list", "nope"],
        ["app", "channel-new", "shop", "web"],
        ["app", "channel-new", "shop", "web"],
        ["app", "channel-new", "shop", "bad name!"],
        ["app", "channel-delete", "shop", "web"],
        ["app", "channel-delete", "shop", "nope"],
        # "--": a generated key may begin with "-" (token_urlsafe draws it
        # 1 time in 64), which argparse would read as an option
        ["accesskey", "delete", "--", key_of("blog")],
        ["accesskey", "delete", "nope"],
        ["app", "data-delete", "shop"],
        ["app", "data-delete", "shop", "--channel", "nope"],
        ["app", "delete", "blog"],
        ["app", "delete", "nope"],
        ["app", "list"],
        ["version"],
    ]


def run_crud(fn, storage, capsys):
    def key_of(app_name):
        app = storage.get_meta_data_apps().get_by_name(app_name)
        return storage.get_meta_data_access_keys().get_by_app_id(app.id)[0].key

    out = []
    for k, argv in enumerate(crud_script(lambda name: "@" + name)):
        argv = [key_of(a[1:]) if a.startswith("@") else a for a in argv]
        out.append(run(fn, argv, capsys))
    return out


def test_app_and_key_verbs_match_reference(homes, capsys):
    homes("ref")
    want = run_crud(jax_main, JaxStorage, capsys)
    homes("port")
    got = run_crud(main, Storage, capsys)
    for argv, g, w in zip(crud_script(lambda n: "@" + n), got, want):
        assert g == w, argv
    assert [c for c, _, _ in got].count(0) >= 12


def api_lines(n=50):
    """The quickstart's events (tests/test_quickstart_scenario.py), with
    ids and creation times fixed so that exports can be compared."""
    return [
        {"event": "rate", "entityType": "user", "entityId": f"u{(i * 13) % 40}",
         "targetEntityType": "item", "targetEntityId": f"i{i % 25}",
         "properties": {"rating": float(1 + (i * 7) % 5)},
         "eventTime": f"2026-01-01T00:{i % 60:02d}:00.000Z",
         "creationTime": "2026-01-02T00:00:00.000Z", "eventId": f"ev{i:03d}"}
        for i in range(n)
    ]


def write_lines(path, lines, extra=()):
    with open(path, "w") as f:
        for d in lines:
            f.write(json.dumps(d) + "\n")
        for raw in extra:
            f.write(raw + "\n")
    return str(path)


def test_import_export_bytes_match_reference(homes, tmp_path, capsys):
    src = write_lines(tmp_path / "in.jsonl", api_lines(),
                      extra=["not json", '{"event": "rate"}'])
    outs = {}
    for name, fn in (("ref", jax_main), ("port", main)):
        homes(name)
        assert run(fn, ["app", "new", "qs"], capsys)[0] == 0
        code, out, _ = run(fn, ["import", "--app", "qs", "--input", src], capsys)
        assert (code, out) == (1, "Imported 50 events (2 failed)\n")
        dst = str(tmp_path / f"{name}.jsonl")
        code, out, _ = run(fn, ["export", "--app", "qs", "--output", dst],
                           capsys)
        assert (code, out) == (0, f"Exported 50 events -> {dst}\n")
        assert run(fn, ["app", "new", "copy"], capsys)[0] == 0
        assert run(fn, ["import", "--app", "copy", "--input", dst],
                   capsys)[:2] == (0, "Imported 50 events (0 failed)\n")
        with open(dst, "rb") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["ref"] and outs["port"].count(b"\n") == 50


def test_status_healthy_and_broken(homes, capsys, monkeypatch):
    homes("port")
    code, out, _ = run(main, ["status"], capsys)
    assert code == 0 and "(sanity check passed)" in out
    assert out.count("  OK  ") == 8 and "devices:" in out
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "BROKEN")
    code, out, _ = run(main, ["status"], capsys)
    assert code == 1 and "(sanity check FAILED)" in out
    assert "FAIL METADATA/apps" in out and "OK  EVENTDATA/levents" in out


# ------------------------------------------------- train / batchpredict / eval
def reference_init(monkeypatch):
    """The port's ALS init swapped for the reference's: each train_als
    draws users then items, from ``split(PRNGKey(seed))``."""
    calls = []

    def init(n_rows, rank, generator):
        ku, ki = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))
        key = (ku, ki)[len(calls) % 2]
        calls.append(n_rows)
        x = jnp.abs(jax.random.normal(key, (n_rows, rank), jnp.float32))
        return torch.from_numpy(np.array(x * jnp.float32(rank) ** -0.5))

    monkeypatch.setattr(port_als, "_init_factors", init)
    return calls


def engine_json(path):
    """The quickstart's engine.json (rank 8, 5 iterations, lambda 0.1)."""
    variant = {
        "id": "qs1", "engineFactory": "templates.recommendation",
        "datasource": {"params": {"app_name": "qs", "rate_event": "rate"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 8, "num_iterations": 5, "lambda_": 0.1, "seed": 3}}],
    }
    path.write_text(json.dumps(variant))
    return str(path)


def seeded_app(fn, capsys, src):
    assert run(fn, ["app", "new", "qs"], capsys)[0] == 0
    assert run(fn, ["import", "--app", "qs", "--input", src], capsys)[0] == 0


def iid_of(out):
    return re.search(r"engine instance (\w+)", out).group(1)


def same_ranking(got, want):
    """The same items in order wherever the reference's scores are more
    than SCORE_ATOL apart, and each score within SCORE_ATOL."""
    g, w = got["itemScores"], want["itemScores"]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert abs(a["score"] - b["score"]) <= SCORE_ATOL
        if a["item"] != b["item"]:
            tied = [s["score"] for s in w if s["item"] == a["item"]]
            assert tied and abs(tied[0] - b["score"]) <= SCORE_ATOL


def test_train_batchpredict_eval_match_reference(homes, tmp_path, capsys,
                                                 monkeypatch):
    src = write_lines(tmp_path / "in.jsonl", api_lines())
    ej = engine_json(tmp_path / "engine.json")
    queries = [{"user": f"u{(k * 13) % 40}", "num": 4} for k in range(12)]
    queries += [{"user": "stranger"}, {"user": "u0", "num": 3,
                                       "blackList": ["i0"]}]
    qpath = write_lines(tmp_path / "q.jsonl", queries, extra=["not json"])
    calls = reference_init(monkeypatch)
    monkeypatch.setenv("PIO_TPU_EVAL_APP", "qs")
    out = {}
    for name, fn, extra in (("ref", jax_main, []),
                            ("port", main, ["--device", "cpu"])):
        homes(name)
        seeded_app(fn, capsys, src)
        code, text, err = run(fn, ["train", "--engine-json", ej] + extra, capsys)
        assert code == 0 and "Training completed" in text, err
        pred = str(tmp_path / f"{name}.pred.jsonl")
        code, text, _ = run(fn, ["batchpredict", "--engine-json", ej,
                                 "--input", qpath, "--output", pred] + extra,
                            capsys)
        assert (code, text) == (0, f"Batch predict done: 14 queries -> {pred}\n")
        with open(pred) as f:
            lines = [json.loads(line) for line in f]
        code, text, _ = run(fn, ["eval", f"pio_tpu{'_torch' * (name == 'port')}"
                                 ".templates.recommendation:"
                                 "recommendation_evaluation"] + extra, capsys)
        assert code == 0 and text.startswith("Best params (score ")
        out[name] = (iid_of_store(name), lines, json.loads(text.split("\n", 1)[1]))
    assert len(calls) == 2 * (1 + 3 * 4)  # train + 3 folds x 4 params

    # factors of the stored instances, row for row by id
    homes("ref")
    v = jax_load_variant(ej)
    engine, ep = jax_build_engine(v)
    (ref_m,) = jax_load_models(out["ref"][0], engine, ep, JaxContext.local())
    homes("port")
    v = load_variant(ej)
    engine, ep = build_engine(v)
    (port_m,) = load_models_for_instance(out["port"][0], engine, ep,
                                         ComputeContext.local(device="cpu"))
    for attr, index in (("user_factors", "user_index"),
                        ("item_factors", "item_index")):
        ids = sorted(getattr(ref_m, index).to_dict())
        assert ids == sorted(getattr(port_m, index).to_dict())
        rows_r = [getattr(ref_m, index).to_dict()[k] for k in ids]
        rows_p = [getattr(port_m, index).to_dict()[k] for k in ids]
        want = np.asarray(getattr(ref_m.factors, attr))[rows_r]
        got = getattr(port_m.factors, attr).numpy()[rows_p]
        np.testing.assert_allclose(
            got, want, rtol=0, atol=FACTOR_TOL * np.abs(want).max())

    for g, w in zip(out["port"][1], out["ref"][1]):
        assert g["query"] == w["query"]
        assert ("error" in g) == ("error" in w)
        if "prediction" in w:
            same_ranking(g["prediction"], w["prediction"])
    ev_p, ev_r = out["port"][2], out["ref"][2]
    assert ev_p["bestEngineParams"] == ev_r["bestEngineParams"]
    np.testing.assert_allclose(
        [s["score"] for s in ev_p["engineParamsScores"]],
        [s["score"] for s in ev_r["engineParamsScores"]], rtol=EVAL_RTOL)


def test_train_checkpoint_flags(homes, tmp_path, capsys):
    """``--checkpoint-dir`` alone is refused as the reference refuses it;
    ``--checkpoint-every N --checkpoint-dir D`` snapshots the two-tower
    algorithm under ``D/algo0_twotower`` and a second run resumes there
    (no step retrained: the same vectors)."""
    ej = tmp_path / "tt.json"
    ej.write_text(json.dumps({
        "id": "tt1", "engineFactory": "templates.twotower",
        "datasource": {"params": {"app_name": "qs"}},
        "algorithms": [{"name": "twotower", "params": {
            "embed_dim": 8, "hidden": 8, "out_dim": 8, "steps": 6,
            "batch_size": 16}}],
    }))
    ck = tmp_path / "ck"
    refusals = []
    for name, fn, extra in (("ref", jax_main, []),
                            ("port", main, ["--device", "cpu"])):
        homes(name)
        refusals.append(run(fn, ["train", "--engine-json", str(ej),
                                 "--checkpoint-dir", str(ck)] + extra, capsys))
    assert refusals[0] == refusals[1]
    assert refusals[0][0] == 1 and "--checkpoint-every" in refusals[0][2]
    assert not ck.exists()

    homes("port")
    seeded_app(main, capsys, write_lines(tmp_path / "in.jsonl", api_lines()))
    argv = ["train", "--engine-json", str(ej), "--device", "cpu",
            "--checkpoint-every", "4", "--checkpoint-dir", str(ck)]
    ids = []
    for _ in range(2):
        code, out, err = run(main, argv, capsys)
        assert code == 0, err
        ids.append(iid_of(out))
    assert sorted(os.listdir(ck / "algo0_twotower")) == \
        ["4", "6", "fingerprint.json"]
    v = load_variant(str(ej))
    engine, ep = build_engine(v)
    ctx = ComputeContext.local(device="cpu")
    (a,), (b,) = (load_models_for_instance(i, engine, ep, ctx) for i in ids)
    assert torch.equal(a.model.item_vectors, b.model.item_vectors)


def iid_of_store(name):
    storage = JaxStorage if name == "ref" else Storage
    (inst,) = storage.get_meta_data_engine_instances().get_all()
    return inst.id


def test_deploy_falls_back_to_last_known_good(homes, tmp_path, capsys):
    home = homes("port")
    src = write_lines(tmp_path / "in.jsonl", api_lines())
    seeded_app(main, capsys, src)
    ej = engine_json(tmp_path / "engine.json")
    ids = []
    for _ in range(2):
        code, out, _ = run(main, ["train", "--engine-json", ej,
                                  "--device", "cpu"], capsys)
        ids.append(iid_of(out))
    good, newest = ids
    blob = home / "models" / f"{newest}.bin"
    blob.write_bytes(b"\x00" + blob.read_bytes()[1:])
    variant = load_variant(ej)
    engine, ep = build_engine(variant)
    ctx = ComputeContext.local(device="cpu")
    with pytest.raises(RuntimeError, match="checksum"):
        load_models_for_instance(newest, engine, ep, ctx)
    (fallback,) = load_models_for_instance(newest, engine, ep, ctx,
                                           variant=variant)
    (want,) = load_models_for_instance(good, engine, ep, ctx)
    np.testing.assert_array_equal(fallback.factors.user_factors.numpy(),
                                  want.factors.user_factors.numpy())
    server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                 device="cpu")
    with server:
        assert server.service.instance_id == newest
        got = post(f"http://127.0.0.1:{server.port}/queries.json",
                   {"user": "u0", "num": 3})
    algo = engine._algorithms(ep)[0]
    assert got == algo.predict(want, algo.query_class(user="u0", num=3)).to_dict()
    (home / "models" / f"{good}.bin").write_bytes(b"torn")
    with pytest.raises(RuntimeError, match="checksum"):
        load_models_for_instance(newest, engine, ep, ctx, variant=variant)


@pytest.mark.parametrize("verb", [
    ["train"], ["deploy"], ["batchpredict", "--input", "q", "--output", "p"],
    ["eval", "pio_tpu_torch.templates.recommendation:recommendation_evaluation"],
])
def test_device_verbs_refuse_without_a_card(homes, capsys, monkeypatch, verb):
    homes("port")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = run(main, verb, capsys)
    assert code == 1 and out == ""
    assert "no CUDA device is available" in err


# ------------------------------------------------------ the ops plane's verbs
def ledger_rows(tw, second_seconds):
    rows = [
        tw.run_record(run_id=f"r{k}", engine_id="eng", status=status,
                      train_seconds=secs,
                      phases={"read": 0.5, "train.0_als": secs - 1.0},
                      params_hash="h", num_devices=1,
                      timestamp=f"2026-10-0{k + 1}T00:00:00+00:00",
                      step_summary={"algo": "als", "steps": 5,
                                    "examples": 50, "final_loss": loss})
        for k, (status, secs, loss) in enumerate((
            ("COMPLETED", 10.0, 0.5), ("FAILED", 2.0, None),
            ("COMPLETED", second_seconds, 0.25)))
    ]
    for r in rows:
        tw.append_run(r)


@pytest.mark.parametrize("argv", [
    ["runs", "--engine-id", "eng"],
    ["runs", "--engine-id", "eng", "-n", "1"],
    ["runs", "--engine-id", "eng", "--json"],
    ["runs", "--engine-id", "eng", "--diff"],
    ["runs", "--engine-id", "eng", "--diff", "--threshold", "0.5"],
    ["runs", "--engine-id", "nope"],
], ids=["list", "last", "json", "diff", "threshold", "missing"])
@pytest.mark.parametrize("second_seconds", [10.2, 12.0],
                         ids=["steady", "slower"])
def test_runs_matches_reference(homes, capsys, argv, second_seconds):
    from pio_tpu.obs import trainwatch as rtw
    from pio_tpu_torch.obs import trainwatch as ptw

    out = []
    for name, fn, tw in (("ref", jax_main, rtw), ("port", main, ptw)):
        home = str(homes(name))
        ledger_rows(tw, second_seconds)
        code, text, err = run(fn, argv, capsys)
        out.append((code, text.replace(home, "<home>"),
                    err.replace(home, "<home>")))
    assert out[0] == out[1]
    if argv[-1] == "--diff":
        assert out[1][0] == (1 if second_seconds == 12.0 else 0)


class _Payload:
    """A loopback server answering GET /device.json with ``payload``."""

    def __init__(self, payload):
        import http.server
        import threading

        body = json.dumps(payload).encode()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


DEVICE_PAYLOADS = {
    "ledger": {"mode": "ledger", "generation": 2, "samples": 3,
               "budgetBytes": None, "headroomBytes": None,
               "devices": [{"device": "cpu:0", "bytesInUse": 2097152,
                            "peakBytes": 3145728, "limitBytes": None,
                            "ledgerBytes": 2097152, "driftBytes": None,
                            "source": "ledger"}],
               "ledger": {"totalBytes": 2097152,
                          "byCategory": {"resident": 2097152}},
               "placements": [{"category": "resident"}],
               "compiles": {"total": 7, "sites": {
                   "bucket_warmup": {"count": 6, "seconds": 0.0123},
                   "resident_scorer": {"count": 1, "seconds": 0.5}}}},
    "live": {"mode": "live", "generation": 1, "samples": 40,
             "budgetBytes": 8 * 2 ** 30, "headroomBytes": 5 * 2 ** 30,
             "devices": [{"device": "cuda:0", "bytesInUse": 3 * 2 ** 30,
                          "peakBytes": 4 * 2 ** 30,
                          "limitBytes": 85520809984, "ledgerBytes": 0,
                          "driftBytes": 123456, "source": "memory_stats"}],
             "ledger": {"totalBytes": 0, "byCategory": {}},
             "placements": [], "compiles": {"total": 0, "sites": {}}},
}


@pytest.mark.parametrize("payload", list(DEVICE_PAYLOADS),
                         ids=list(DEVICE_PAYLOADS))
def test_top_once_renders_like_the_reference(capsys, payload):
    server = _Payload(DEVICE_PAYLOADS[payload])
    try:
        argv = ["top", "--once", "--url", server.url]
        want = run(jax_main, argv, capsys)
        got = run(main, argv, capsys)
    finally:
        server.close()
    assert got == want
    assert got[0] == 0 and "\x1b[" not in got[1]
    assert f"mode {DEVICE_PAYLOADS[payload]['mode']}" in got[1]


def test_top_once_unreachable_exits_1(capsys):
    argv = ["top", "--once", "--url", "http://127.0.0.1:1"]
    assert run(main, argv, capsys)[0] == run(jax_main, argv, capsys)[0] == 1


def test_status_on_the_cpu_opens_no_device(homes, capsys):
    homes("port")
    code, out, _ = run(main, ["status", "--device", "cpu"], capsys)
    assert code == 0
    assert f"devices: ['cpu'] ({torch.cuda.device_count()} CUDA device(s) " \
        "not opened)" in out
    assert not torch.cuda.is_initialized()


def test_train_profile_dir_and_status_port(homes, tmp_path, capsys):
    from pio_tpu_torch.obs import trainwatch

    homes("port")
    seeded_app(main, capsys, write_lines(tmp_path / "in.jsonl", api_lines()))
    ej = engine_json(tmp_path / "engine.json")
    prof = tmp_path / "prof"
    code, out, err = run(main, ["train", "--engine-json", ej, "--device",
                                "cpu", "--profile-dir", str(prof),
                                "--status-port", "0"], capsys)
    assert code == 0, err
    assert re.search(r"Training status sidecar on 127\.0\.0\.1:\d+ "
                     r"\(/train\.json /device\.json /metrics\)", out)
    with open(prof / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    code, out, _ = run(main, ["runs", "--engine-json", ej, "--json"], capsys)
    (row,) = json.loads(out)
    assert code == 0 and row["status"] == "COMPLETED"
    assert row["run_id"] == iid_of_store("port")
    assert row["step_summary"]["steps"] == 5
    assert trainwatch.active_recorder() is None


def test_shell_preloads_torch(homes, capsys, monkeypatch):
    import code as code_module

    homes("port")
    seen = {}
    monkeypatch.setattr(code_module, "interact",
                        lambda banner, local, exitmsg: seen.update(
                            banner=banner, ns=local))
    assert run(main, ["shell"], capsys)[0] == 0
    assert seen["ns"]["torch"] is torch and "jax" not in seen["ns"]
    assert {"Storage", "PEventStore", "LEventStore", "Event"} <= \
        set(seen["ns"])
    assert "torch" in seen["banner"]


# --------------------------------------------- the quickstart, real processes
def post(url, body, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_http(url, proc, timeout=60):
    deadline = monotonic_s() + timeout
    while monotonic_s() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"server exited with {proc.returncode}")
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError):
            time.sleep(0.2)
    raise TimeoutError(f"server at {url} never came up")


def test_quickstart_through_processes(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_TPU_HOME=str(tmp_path / "home"), PYTHONPATH=REPO,
               PIO_TPU_NO_NATIVE="1")

    def cli(*args, timeout=120):
        return subprocess.run(
            [sys.executable, "-m", "pio_tpu_torch", *args], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=timeout)

    def serve(*args):
        log = open(tmp_path / f"{args[0]}.log", "w")
        try:
            return subprocess.Popen(
                [sys.executable, "-m", "pio_tpu_torch", *args], env=env,
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()  # the child holds its own descriptor

    procs = []
    try:
        out = cli("app", "new", "qs")
        assert out.returncode == 0, out.stderr[-2000:]
        key = re.search(r"Access key: (\S+)", out.stdout).group(1)

        es_port = free_port()
        es = serve("eventserver", "--ip", "127.0.0.1", "--port", str(es_port))
        procs.append(es)
        base = f"http://127.0.0.1:{es_port}"
        assert wait_http(base + "/", es)["status"] == "alive"
        got = post(f"{base}/batch/events.json?accessKey={key}", api_lines())
        assert [r["status"] for r in got] == [201] * 50

        ej = engine_json(tmp_path / "engine.json")
        out = cli("train", "--engine-json", ej, "--device", "cpu")
        assert out.returncode == 0, out.stderr[-2000:]
        assert "Training completed" in out.stdout

        qs_port = free_port()
        qs = serve("deploy", "--engine-json", ej, "--ip", "127.0.0.1",
                   "--port", str(qs_port), "--device", "cpu")
        procs.append(qs)
        status = wait_http(f"http://127.0.0.1:{qs_port}/", qs)
        assert status["engineInstanceId"] == iid_of(out.stdout)
        got = post(f"http://127.0.0.1:{qs_port}/queries.json",
                   {"user": "u0", "num": 4})
        assert len(got["itemScores"]) == 4

        out = cli("undeploy", "--port", str(qs_port), timeout=60)
        assert out.returncode == 0 and "undeployed" in out.stdout
        assert qs.wait(timeout=30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


# ---------------------------------------------------- the stores' verbs
def store_env(monkeypatch, root, type_):
    """EVENTDATA on ``type_`` under ``root`` (metadata stays on SQLite)."""
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "EV")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_EV_TYPE", type_)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_EV_PATH", str(
        root / ("search.db" if type_ == "searchable" else "events")))


def compact_script(fn, capsys, src):
    out = [run(fn, ["app", "new", "qs"], capsys)]
    out.append(run(fn, ["import", "--app", "qs", "--input", src], capsys))
    # the same ids again: each record shadows its first write
    out.append(run(fn, ["import", "--app", "qs", "--input", src], capsys))
    out.append(run(fn, ["app", "compact", "qs"], capsys))
    out.append(run(fn, ["app", "compact", "qs"], capsys))
    out.append(run(fn, ["app", "compact", "qs", "--channel", "nope"], capsys))
    out.append(run(fn, ["app", "compact", "nope"], capsys))
    out.append(run(fn, ["app", "data-delete", "qs"], capsys))
    out.append(run(fn, ["app", "delete", "qs"], capsys))
    return out


@pytest.mark.parametrize("type_", ["eventlog", "parquet", "sqlite"])
def test_app_compact_matches_reference(homes, tmp_path, capsys, monkeypatch,
                                       type_):
    src = write_lines(tmp_path / "in.jsonl", api_lines(40))
    outs = {}
    for name, fn in (("ref", jax_main), ("port", main)):
        root = homes(name)
        if type_ != "sqlite":
            store_env(monkeypatch, root, type_)
        Storage.reset()
        JaxStorage.reset()
        outs[name] = compact_script(fn, capsys, src)
    assert outs["port"] == outs["ref"]
    codes = [c for c, _, _ in outs["port"]]
    assert codes == [0, 0, 0, 0, 0, 1, 1, 0, 0]
    said = outs["port"][3][1]
    if type_ == "eventlog":
        assert said.startswith("compacted app 'qs': reclaimed ")
        assert int(said.split()[-2]) > 0 and "reclaimed 0" in outs["port"][4][1]
    elif type_ == "parquet":
        assert said == "compacted app 'qs'\n"
    else:
        assert said == "backend SQLiteEvents does not need compaction\n"


def upgrade_script(fn, capsys, root):
    out = [run(fn, ["upgrade"], capsys)]
    out.append(run(fn, ["app", "new", "shop", "--description", "gold"],
                   capsys))
    out.append(run(fn, ["upgrade", "--rebuild-search-index"], capsys))
    return [(c, o.replace(str(root), "<home>"), e) for c, o, e in out]


@pytest.mark.parametrize("type_", ["sqlite", "searchable", "memory"])
def test_upgrade_matches_reference(homes, capsys, monkeypatch, type_):
    outs = {}
    for name, fn in (("ref", jax_main), ("port", main)):
        root = homes(name)
        if type_ != "sqlite":
            for repo in ("METADATA", "EVENTDATA"):
                monkeypatch.setenv(
                    f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "S")
            monkeypatch.setenv("PIO_STORAGE_SOURCES_S_TYPE", type_)
            monkeypatch.setenv("PIO_STORAGE_SOURCES_S_PATH",
                               str(root / "s.db"))
        Storage.reset()
        JaxStorage.reset()
        outs[name] = upgrade_script(fn, capsys, root)
    assert outs["port"] == outs["ref"]
    last = outs["port"][-1][1]
    if type_ == "searchable":
        assert "METADATA: FTS index rebuilt" in last
        assert "EVENTDATA: FTS index rebuilt" not in last  # the same file
        assert [a.name for a in Storage.get_meta_data_apps().search("gold")] \
            == ["shop"]
    elif type_ == "memory":
        assert last == "no SQLite stores configured; nothing to migrate\n"
    else:
        assert "FTS" not in last and "storage schema up to date" in last


def blobserver_run(package, root, tmp_path):
    """``python -m <package> blobserver`` as a process: its first line,
    a model through the ``http://`` blob store, a wrong key refused, then
    SIGINT; returns (exit code, output with the port masked, what was
    read back)."""
    import signal

    from pio_tpu_torch.storage.blobstore import BlobModels, open_blob_backend
    from pio_tpu_torch.storage.records import Model

    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=REPO, PIO_TPU_HOME=str(tmp_path / package))
    proc = subprocess.Popen(
        [sys.executable, "-m", package, "blobserver", "--root", str(root),
         "--ip", "127.0.0.1", "--port", str(port), "--access-key", "k1"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        first = proc.stdout.readline()
        url = f"http://127.0.0.1:{port}"
        models = BlobModels(open_blob_backend(url + "?accessKey=k1"))
        models.insert(Model("inst-1", b"model bytes" * 1000))
        got = models.get("inst-1").models
        with pytest.raises(Exception, match="401"):
            BlobModels(open_blob_backend(url + "?accessKey=bad")).get("inst-1")
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, (first + rest).replace(str(port), "<port>"), got


def test_blobserver_matches_reference(tmp_path):
    code, out, got = blobserver_run("pio_tpu_torch", tmp_path / "port",
                                        tmp_path)
    ref_code, ref_out, ref_got = blobserver_run(
        "pio_tpu", tmp_path / "ref", tmp_path)
    assert (code, got) == (ref_code, ref_got) == (0, b"model bytes" * 1000)
    assert out.replace(str(tmp_path / "port"), "<root>") == \
        ref_out.replace(str(tmp_path / "ref"), "<root>")
    assert out.startswith("Blob server serving ") and "shutting down" in out
    # the roots hold the same keys and bytes
    def keys(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file())
    assert keys(tmp_path / "port") == keys(tmp_path / "ref")
