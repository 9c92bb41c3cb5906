"""What the servers' request plane costs a request, on the card.

Serves a text-classification model at the template's full width (V =
65537, hidden 128, 20 labels, bags of 256 tokens; random weights from
``--seed``) through the port's query server on the card, and ingests rate
events through its event server on SQLite, both in this process over
loopback HTTP:

- one keep-alive client, ``--queries`` queries: p50 and p99 (host clock);
- 32 clients x 64 queries, the micro-batcher off: queries/s and p50;
- ``--events`` events in batches of 50, then ``--singles`` single posts:
  events/s, the batch and the single post's p50.

``--root DIR`` imports ``pio_tpu_torch`` from another checkout (a ``git
archive`` of the parent commit in a gitignored directory), so that the
parent and the change run in turns in one call on one card::

    python3 scripts/torch_request_plane_ab.py --root build/ab_parent
    python3 scripts/torch_request_plane_ab.py
    python3 scripts/torch_request_plane_ab.py
    python3 scripts/torch_request_plane_ab.py --root build/ab_parent

Each run prints one JSON object with the card's name and power limit.
Without a CUDA device it exits 1.
"""

import argparse
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

V, HIDDEN, LABELS, BAG = 65537, 128, 20, 256
CLIENTS, PER_CLIENT, BATCH = 32, 64, 50
DEVICE = "cuda"


def post(conn, path: str, body: bytes) -> tuple:
    t0 = time.perf_counter()
    conn.request("POST", path, body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read()
    return resp.status, (time.perf_counter() - t0) * 1e3


def text_model(seed: int, device: str):
    from pio_tpu_torch.convert import text_mlp_from_reference

    rng = np.random.default_rng(seed)
    arrays = {
        "w_in": rng.standard_normal((V, HIDDEN), dtype=np.float32),
        "b_in": (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32),
        "w_out": (rng.standard_normal((HIDDEN, LABELS)) / HIDDEN ** 0.5
                  ).astype(np.float32),
        "b_out": (0.1 * rng.standard_normal(LABELS)).astype(np.float32),
        "vocab": {f"w{i}": i for i in range(1, V)},
        "idf": (1.0 + rng.random(V)).astype(np.float32),
        "labels": [f"label{i}" for i in range(LABELS)],
        "bag_width": BAG, "token_cap": BAG,
    }
    return text_mlp_from_reference(arrays, device=device)


def serve(args) -> dict:
    from pio_tpu_torch.controller.engine import EngineParams, get_engine_factory
    from pio_tpu_torch.server.query_server import create_query_server
    from pio_tpu_torch.templates.textclassification import MLPParams

    rng = np.random.default_rng(args.seed + 1)
    bodies = [json.dumps({"text": " ".join(
        f"w{i}" for i in rng.integers(1, V, size=BAG))}).encode()
        for _ in range(args.queries)]
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    server = create_query_server(engine, ep, [text_model(args.seed, DEVICE)],
                                 host="127.0.0.1", port=0, device=DEVICE)
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        for b in bodies[:64]:  # warm
            post(conn, "/queries.json", b)
        ms = []
        for b in bodies:
            status, t = post(conn, "/queries.json", b)
            if status != 200:
                raise AssertionError(f"query: HTTP {status}")
            ms.append(t)
        conn.close()
        lat, errors = [], []
        lock = threading.Lock()

        def client(k):
            c = http.client.HTTPConnection("127.0.0.1", server.port,
                                           timeout=60)
            try:
                for n in range(PER_CLIENT):
                    status, t = post(c, "/queries.json",
                                     bodies[(k * PER_CLIENT + n) % len(bodies)])
                    if status != 200:
                        errors.append(status)
                    with lock:
                        lat.append(t)
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"32 clients: {len(errors)} answers not 200")
    return {"one_client_p50_ms": float(np.percentile(ms, 50)),
            "one_client_p99_ms": float(np.percentile(ms, 99)),
            "clients32_qps": CLIENTS * PER_CLIENT / wall,
            "clients32_p50_ms": float(np.percentile(lat, 50))}


def ingest(args) -> dict:
    home = tempfile.mkdtemp(prefix="pio-ab-")
    db = os.path.join(home, "pio.db")
    for repo in ("METADATA", "EVENTDATA"):
        os.environ[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "AB"
    os.environ["PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE"] = "ABM"
    os.environ["PIO_STORAGE_SOURCES_AB_TYPE"] = "sqlite"
    os.environ["PIO_STORAGE_SOURCES_AB_PATH"] = db
    os.environ["PIO_STORAGE_SOURCES_ABM_TYPE"] = "memory"
    os.environ["PIO_TPU_HOME"] = home
    from pio_tpu_torch.server.event_server import create_event_server
    from pio_tpu_torch.storage.records import AccessKey, App
    from pio_tpu_torch.storage.registry import Storage

    Storage.reset()
    app_id = Storage.get_meta_data_apps().insert(App(0, "ab"))
    key = Storage.get_meta_data_access_keys().insert(AccessKey("", app_id))
    events = [{"event": "rate", "entityType": "user",
               "entityId": f"u{k % 943}", "targetEntityType": "item",
               "targetEntityId": f"i{k % 1682}",
               "properties": {"rating": float(1 + k % 5)},
               "eventTime": "2026-03-01T00:00:00+00:00"}
              for k in range(args.events + args.singles)]
    server = create_event_server(host="127.0.0.1", port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        batch_ms, single_ms = [], []
        t0 = time.perf_counter()
        for b in range(0, args.events, BATCH):
            status, t = post(conn, f"/batch/events.json?accessKey={key}",
                             json.dumps(events[b:b + BATCH]).encode())
            if status != 200:
                raise AssertionError(f"batch: HTTP {status}")
            batch_ms.append(t)
        for e in events[args.events:]:
            status, t = post(conn, f"/events.json?accessKey={key}",
                             json.dumps(e).encode())
            if status != 201:
                raise AssertionError(f"single: HTTP {status}")
            single_ms.append(t)
        wall = time.perf_counter() - t0
        conn.close()
    finally:
        server.stop()
    return {"events_per_s": (args.events + args.singles) / wall,
            "batch_p50_ms": float(np.percentile(batch_ms, 50)),
            "single_p50_ms": float(np.percentile(single_ms, 50))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="import pio_tpu_torch from this checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--events", type=int, default=5000)
    ap.add_argument("--singles", type=int, default=500)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root) if args.root else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.environ["PIO_TPU_DEVICEWATCH"] = "0"
    import torch

    if not torch.cuda.is_available():
        print("torch_request_plane_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root or "this checkout", **serve(args),
           **ingest(args), "device": smi}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
