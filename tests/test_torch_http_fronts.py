"""The port's two HTTP fronts against the JAX package's, on the CPU, over
raw sockets on loopback.

One parametrised suite runs each scenario over (reference, port) x
(threaded, evloop), each front over its own package's ``Router`` with the
same two handlers, and holds every one to the same statuses and bodies:
a round trip, a pipelined burst in order, two pipelined answers of very
different sizes that neither interleave nor alias, byte-by-byte arrival,
413 over ``PIO_TPU_MAX_JSON_BODY_MB``, 400 on a malformed request line,
keep-alive then ``Connection: close``, the idle close at
``PIO_TPU_HTTP_IDLE_TIMEOUT_S``, the ``PIO_TPU_HTTP_MAX_PIPELINE`` cap
(batches, serves all), and packed int8 bodies that reach the handler
unchanged, pipelined. Then the evloop front's own: its connection
metrics, its refusal of TLS and of ``large_uploads``; TLS on the threaded
front with a certificate minted by the ``openssl`` binary; the knobs'
defaults and fallbacks (the body caps, read at import, in a subprocess);
the front's selection in the query server; and a query server of each
package on the evloop front: the text template's answers within the text
tests' tolerance (1e-5), and the classification template's JSON and
packed int8 answers, which agree exactly.

The idle close (a fault of the port: it closed at 60 s and ignored the
knob) holds the two threaded fronts to one close time within 0.25 s.
"""

import contextlib
import http.client
import json
import os
import pathlib
import socket
import ssl
import subprocess
import sys
import warnings

import numpy as np
import pytest

from pio_tpu.obs import monotonic_s
from pio_tpu.obs import devicewatch as r_devicewatch
from pio_tpu.obs.metrics import MetricsRegistry as RefRegistry
from pio_tpu.server import evfront as r_evfront
from pio_tpu.server import http as r_http
from pio_tpu.server import query_server as r_qs
from pio_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry
from pio_tpu_torch.server import evfront as p_evfront
from pio_tpu_torch.server import http as p_http
from pio_tpu_torch.server import query_server as p_qs
from pio_tpu_torch.utils import knobs as p_knobs
from test_torch_classification import (  # noqa: F401  (fixture)
    APP as CLS_APP,
    QUERIES as CLS_QUERIES,
    memory_storage,
    reference_logreg_init,
    seed_events,
    train_port,
    train_reference,
    user_rows,
)
from test_torch_server_ops import (  # noqa: F401  (fixture)
    same_answer,
    text,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"reference": (r_http, r_evfront), "port": (p_http, p_evfront)}
COMBOS = [(pkg, front) for pkg in PACKAGES
          for front in ("threaded", "evloop")]
IDS = [f"{pkg}-{front}" for pkg, front in COMBOS]
IO_S = 5.0
PACKED = "application/x-pio-query-i8"


def _router(pkg):
    http_mod = PACKAGES[pkg][0]
    r = http_mod.Router()
    r.add("POST", "/echo", lambda req: (200, {"got": req.body}))
    r.add("GET", "/ping", lambda req: (200, {"pong": True}))
    # a packed body comes back as its own bytes, copied during the call
    r.add("POST", "/packed", lambda req: (200, http_mod.RawResponse(
        bytes(req.packed), content_type="application/octet-stream")))
    return r


def _front(pkg, front, **kw):
    http_mod, ev_mod = PACKAGES[pkg]
    kw.setdefault("ssl_context", None)
    cls = (ev_mod.EvLoopHTTPServer if front == "evloop"
           else http_mod.JsonHTTPServer)
    return cls(_router(pkg), host="127.0.0.1", port=0, **kw)


@contextlib.contextmanager
def serving(pkg, front, **kw):
    srv = _front(pkg, front, **kw).start()
    try:
        yield srv
    finally:
        srv.stop()


@pytest.fixture(params=COMBOS, ids=IDS)
def combo(request):
    return request.param


@pytest.fixture(scope="module", params=COMBOS, ids=IDS)
def server(request):
    """One front a combination for the scenarios that leave it as it was
    (each opens its own connections)."""
    with serving(*request.param) as srv:
        yield srv


def _drain(sock, timeout=IO_S):
    sock.settimeout(timeout)
    out = b""
    try:
        while True:
            got = sock.recv(65536)
            if not got:
                break
            out += got
    except (socket.timeout, ConnectionResetError):
        pass
    return out


def _exchange(port, payload, timeout=IO_S):
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall(payload)
        return _drain(s, timeout)
    finally:
        s.close()


def _post(path, body, ctype="application/json", close=False):
    conn = b"Connection: close\r\n" if close else b""
    return (b"POST %s HTTP/1.1\r\nHost: t\r\nContent-Type: %s\r\n"
            b"Content-Length: %d\r\n%s\r\n%s"
            % (path.encode(), ctype.encode(), len(body), conn, body))


def _split(blob):
    """``[(status, headers, body)]`` out of a stream of answers framed by
    Content-Length: an interleaved or misframed answer breaks the parse."""
    out, rest = [], blob
    while rest:
        head, sep, rest = rest.partition(b"\r\n\r\n")
        assert sep, f"unterminated head: {head[:120]!r}"
        lines = head.split(b"\r\n")
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(b":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get(b"content-length", b"0"))
        body, rest = rest[:n], rest[n:]
        assert len(body) == n, "truncated body"
        out.append((int(lines[0].split()[1]), headers, body))
    return out


def _pairs(blob):
    return [(st, json.loads(body)) for st, _, body in _split(blob)]


# ---------------------------------------------------------- the suite
def test_round_trip(server):
    got = _split(_exchange(server.port, b"GET /ping HTTP/1.1\r\nHost: t\r\n"
                                        b"Connection: close\r\n\r\n"))
    assert [(st, json.loads(b), h[b"connection"]) for st, h, b in got] \
        == [(200, {"pong": True}, b"close")]


def test_pipelined_burst_in_order(server):
    bodies = [json.dumps({"i": i}).encode() for i in range(8)]
    blob = b"".join(_post("/echo", b) for b in bodies[:-1])
    blob += _post("/echo", bodies[-1], close=True)
    assert _pairs(_exchange(server.port, blob)) \
        == [(200, {"got": {"i": i}}) for i in range(8)]


def test_pipelined_answers_neither_interleave_nor_alias(server):
    big = json.dumps({"blob": "x" * 30000}).encode()
    small = json.dumps({"tiny": 1}).encode()
    blob = _post("/echo", big) + _post("/echo", small, close=True)
    assert _pairs(_exchange(server.port, blob)) == [
        (200, {"got": {"blob": "x" * 30000}}), (200, {"got": {"tiny": 1}})]


def test_pipelined_packed_bodies_reach_the_handler_unchanged(server):
    # on the evloop front each body is a view into the read buffer, which
    # is compacted after each handler: every answer must be its own bytes
    frames = [bytes([0, 0x51, 0x38, 1, n, 0, 0, 0]) + bytes(range(n, 0, -1))
              for n in (3, 40, 7)]
    blob = b"".join(_post("/packed", f, ctype=PACKED) for f in frames[:-1])
    blob += _post("/packed", frames[-1], ctype=PACKED, close=True)
    assert [(st, body) for st, _, body in _split(_exchange(server.port,
                                                           blob))] \
        == [(200, f) for f in frames]


def test_byte_by_byte_arrival(server):
    payload = _post("/echo", json.dumps({"slow": True}).encode(), close=True)
    s = socket.create_connection(("127.0.0.1", server.port), timeout=IO_S)
    try:
        for i in range(len(payload)):
            s.sendall(payload[i:i + 1])
        got = _pairs(_drain(s))
    finally:
        s.close()
    assert got == [(200, {"got": {"slow": True}})]


def test_json_body_over_the_cap_is_413(server):
    # refused from the head alone: no body byte is sent or read
    head = (b"POST /echo HTTP/1.1\r\nHost: t\r\nContent-Type: "
            b"application/json\r\nContent-Length: %d\r\n\r\n" % (100 << 20))
    assert _pairs(_exchange(server.port, head)) == [(413, {
        "message": "body exceeds 64 MiB limit for application/json "
                   "content"})]


def test_malformed_request_line_is_400(server):
    assert _pairs(_exchange(server.port, b"NONSENSE\r\n\r\n")) \
        == [(400, {"message": "malformed request line"})]


def test_keep_alive_then_connection_close(server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=IO_S)
    try:
        s.sendall(_post("/echo", b'{"a": 1}'))
        first = b""
        while b"\r\n\r\n" not in first or not first.endswith(b"}"):
            got = s.recv(65536)
            assert got, "the server closed a keep-alive connection"
            first += got
        [(st1, h1, b1)] = _split(first)
        s.sendall(_post("/echo", b'{"b": 2}', close=True))
        [(st2, h2, b2)] = _split(_drain(s))
    finally:
        s.close()
    assert (st1, json.loads(b1), h1.get(b"connection")) \
        == (200, {"got": {"a": 1}}, None)
    assert (st2, json.loads(b2), h2[b"connection"]) \
        == (200, {"got": {"b": 2}}, b"close")


def _idle_close_s(pkg, front):
    """Seconds from connect to the server's orderly close of a keep-alive
    connection that sends nothing."""
    with serving(pkg, front) as srv:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=IO_S)
        try:
            t0 = monotonic_s()
            s.settimeout(IO_S)
            assert s.recv(1) == b""  # an orderly close, not a hang
            return monotonic_s() - t0
        finally:
            s.close()


def test_idle_connection_closes_at_the_knob(combo, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HTTP_IDLE_TIMEOUT_S", "0.5")
    took = _idle_close_s(*combo)
    # the threaded front's socket timeout is the knob; the loop sweeps
    # its connections once a second at most, as the reference's does
    hi = 0.75 if combo[1] == "threaded" else 1.75
    assert 0.45 <= took <= hi, took


def test_max_pipeline_cap_batches_but_serves_all(combo, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HTTP_MAX_PIPELINE", "2")
    with serving(*combo) as srv:
        bodies = [json.dumps({"i": i}).encode() for i in range(7)]
        blob = b"".join(_post("/echo", b) for b in bodies[:-1])
        blob += _post("/echo", bodies[-1], close=True)
        assert _pairs(_exchange(srv.port, blob)) \
            == [(200, {"got": {"i": i}}) for i in range(7)]


# ------------------------------------------------- C.1: the idle close
def test_threaded_fronts_close_an_idle_connection_at_one_time(monkeypatch):
    monkeypatch.setenv("PIO_TPU_HTTP_IDLE_TIMEOUT_S", "0.5")
    ref = _idle_close_s("reference", "threaded")
    port = _idle_close_s("port", "threaded")
    assert abs(port - ref) <= 0.25, (port, ref)


@pytest.mark.parametrize("raw", [None, "", "abc", "nan", "0", "-1"])
def test_idle_timeout_default_and_fallback_match_reference(raw,
                                                           monkeypatch):
    """Unset, the idle timeout is the knob table's 30 s in both packages
    (read, not waited out); a value that is not a positive number warns
    and reads as the default."""
    if raw is None:
        monkeypatch.delenv("PIO_TPU_HTTP_IDLE_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("PIO_TPU_HTTP_IDLE_TIMEOUT_S", raw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = r_http.http_idle_timeout_s()
        got = p_http.http_idle_timeout_s()
        handler = p_http._make_handler_class(_router("port"), "t")
    assert got == ref == 30.0 == handler.timeout
    assert p_knobs.get("PIO_TPU_HTTP_IDLE_TIMEOUT_S").default == 30.0


@pytest.mark.parametrize("raw,want", [("7", 7), ("abc", 128), ("0", 128)])
def test_backlog_knob_matches_reference(raw, want, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HTTP_BACKLOG", raw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert p_http.http_backlog() == r_http.http_backlog() == want
        srv = p_http.JsonHTTPServer(_router("port"), "127.0.0.1", 0)
    try:
        assert srv._httpd.request_queue_size == want
    finally:
        srv.stop()


def test_body_caps_are_read_at_import_like_reference():
    """The caps are module constants read at import: each setting is read
    by a reload in a fresh interpreter (nothing leaks into later tests)."""
    code = (
        "import importlib, json, os, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from pio_tpu.server import http as r\n"
        "from pio_tpu_torch.server import http as p\n"
        "out = []\n"
        "for body, js in (('16', '0.5'), ('nan', '-2'), ('x', '')):\n"
        "    os.environ['PIO_TPU_MAX_BODY_MB'] = body\n"
        "    os.environ['PIO_TPU_MAX_JSON_BODY_MB'] = js\n"
        "    importlib.reload(r), importlib.reload(p)\n"
        "    out.append([r.MAX_BODY_MB, r.MAX_JSON_BODY_MB,\n"
        "                p.MAX_BODY_MB, p.MAX_JSON_BODY_MB])\n"
        "print(json.dumps(out))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_TPU_MAX_")}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        [16.0, 0.5] * 2, [4096.0, 64.0] * 2, [4096.0, 64.0] * 2]


# ------------------------------------------------- the evloop front's own
@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_connection_metrics_registered(pkg):
    reg = RefRegistry() if pkg == "reference" else PortRegistry()
    with serving(pkg, "evloop", registry=reg) as srv:
        # both cells exist before the first connection (pool stripes)
        before = "\n".join(reg.render())
        blob = _post("/echo", b'{"a": 1}') + _post("/echo", b'{"b": 2}',
                                                   close=True)
        assert len(_split(_exchange(srv.port, blob))) == 2
        after = "\n".join(reg.render())
    for text_ in (before, after):
        assert "pio_tpu_http_connections_active" in text_
        assert "pio_tpu_http_pipelined_total" in text_


@pytest.mark.parametrize("pkg", list(PACKAGES))
@pytest.mark.parametrize("kw,match", [
    ({"ssl_context": ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)}, "TLS"),
    ({"large_uploads": True}, "threaded"),
], ids=["tls", "large_uploads"])
def test_evloop_refuses_tls_and_large_uploads(pkg, kw, match):
    kw = {"ssl_context": None, **kw}
    with pytest.raises(ValueError, match=match):
        PACKAGES[pkg][1].EvLoopHTTPServer(_router(pkg), host="127.0.0.1",
                                          **kw)


# ----------------------------------------------------------------- TLS
@pytest.fixture
def cert(tmp_path, monkeypatch):
    """A self-signed certificate minted by the ``openssl`` binary, set as
    ``PIO_TPU_SSL_CERTFILE`` / ``_KEYFILE``."""
    crt, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    proc = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=localhost"], capture_output=True)
    if proc.returncode != 0:
        pytest.skip("openssl unavailable to mint a test cert")
    monkeypatch.setenv("PIO_TPU_SSL_CERTFILE", str(crt))
    monkeypatch.setenv("PIO_TPU_SSL_KEYFILE", str(key))
    return crt


def _client_ctx():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_tls_round_trip_on_the_threaded_front(pkg, cert):
    srv = PACKAGES[pkg][0].JsonHTTPServer(_router(pkg), "127.0.0.1", 0)
    assert srv.tls
    srv.start()
    try:
        conn = http.client.HTTPSConnection("127.0.0.1", srv.port,
                                           timeout=IO_S,
                                           context=_client_ctx())
        conn.request("POST", "/echo", b'{"x": [1, 2]}',
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert (r.status, json.loads(r.read())) == (200, {"got": {"x": [1,
                                                                       2]}})
        conn.close()
        # a plain-text client gets no HTTP answer
        assert not _exchange(srv.port, b"GET /ping HTTP/1.1\r\nHost: t\r\n"
                                       b"Connection: close\r\n\r\n"
                             ).startswith(b"HTTP/1.1 200")
        # None forces plain HTTP whatever the environment says
        plain = PACKAGES[pkg][0].JsonHTTPServer(
            _router(pkg), "127.0.0.1", 0, ssl_context=None).start()
        assert not plain.tls
        plain.stop()
    finally:
        srv.stop()


# ------------------------------------------------ the query server's front
@pytest.mark.parametrize("value,want", [
    ("evloop", "evloop"), ("threaded", "threaded"), (" EvLoop ", "evloop"),
    ("bogus", "threaded")])
def test_front_selection_matches_reference(value, want, monkeypatch,
                                           caplog):
    monkeypatch.setenv("PIO_TPU_HTTP_FRONT", value)
    assert p_qs._choose_front() == want
    if want != value.strip().lower():
        assert "is not threaded|evloop" in caplog.text


def test_evloop_with_tls_serves_threaded_with_a_warning(text, cert,
                                                        monkeypatch, caplog):
    from test_torch_server_ops import query_servers

    monkeypatch.setenv("PIO_TPU_HTTP_FRONT", "evloop")
    with query_servers(text) as servers:
        for pkg in ("port", "reference"):
            port, service = servers[pkg]
            assert not service._evloop_front
            conn = http.client.HTTPSConnection(
                "127.0.0.1", port, timeout=IO_S, context=_client_ctx())
            conn.request("POST", "/queries.json",
                         json.dumps(text.queries[0]).encode(),
                         {"Content-Type": "application/json"})
            assert conn.getresponse().status == 200
            conn.close()
    assert caplog.text.count("PIO_TPU_HTTP_FRONT=evloop ignored") == 2


def test_text_queries_on_the_evloop_front_match_reference(text,
                                                          monkeypatch):
    """Both packages' text servers on the evloop front (the micro-batcher
    bypassed there): each query pipelined on one connection, the port's
    answers within 1e-5 of the reference's."""
    from test_torch_server_ops import query_servers

    monkeypatch.setenv("PIO_TPU_HTTP_FRONT", "evloop")
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_US", "2000")
    monkeypatch.setenv("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE", "0")
    got = {}
    with query_servers(text) as servers:
        for pkg, (port, service) in servers.items():
            assert service._evloop_front
            blob = b"".join(_post("/queries.json", json.dumps(q).encode())
                            for q in text.queries[:-1])
            blob += _post("/queries.json",
                          json.dumps(text.queries[-1]).encode(), close=True)
            got[pkg] = _pairs(_exchange(port, blob))
        assert servers["port"][1].stats()["microbatch"]["batches"] == 0
    assert len(got["port"]) == len(got["reference"]) == len(text.queries)
    for (st, a), (rst, b) in zip(got["port"], got["reference"]):
        assert st == rst == 200
        same_answer(a, b)


def test_packed_and_json_answers_on_the_evloop_front_match_reference(
        memory_storage, reference_logreg_init, monkeypatch):  # noqa: F811
    """The classification template on the int8 wire, both packages'
    servers on the evloop front: each package's packed answers equal its
    JSON answers, and the port's equal the reference's."""
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_SERVE_WIRE", "int8")
    monkeypatch.setenv("PIO_TPU_HTTP_FRONT", "evloop")
    monkeypatch.setenv("PIO_TPU_DEVICEWATCH", "0")
    seed_events(user_rows(), app=CLS_APP)
    engine, ep, models = train_port("logreg")
    pserver = p_qs.create_query_server(engine, ep, models, host="127.0.0.1",
                                       port=0, device="cpu").start()
    jengine, _, _ = train_reference("logreg")
    from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
    from test_torch_classification import variant

    rserver, rservice = r_qs.create_query_server(
        jax_variant_from_dict(variant("logreg")), host="127.0.0.1", port=0)
    rserver.start()
    answers = {}
    try:
        assert pserver.front == "evloop"
        for pkg, port, service in (("port", pserver.port, pserver.service),
                                   ("reference", rserver.port, rservice)):
            frames = [service.pack_query_body(q) for q in CLS_QUERIES]
            assert all(f is not None for f in frames)
            blob = b"".join(_post("/queries.json", json.dumps(q).encode())
                            for q in CLS_QUERIES)
            blob += b"".join(_post("/queries.json", f, ctype=PACKED)
                             for f in frames[:-1])
            blob += _post("/queries.json", frames[-1], ctype=PACKED,
                          close=True)
            got = _pairs(_exchange(port, blob))
            n = len(CLS_QUERIES)
            assert [st for st, _ in got] == [200] * 2 * n
            assert [a for _, a in got[n:]] == [a for _, a in got[:n]]
            answers[pkg] = [a for _, a in got[:n]]
    finally:
        pserver.close()
        rserver.stop()
        rservice.devwatch.stop()
        r_devicewatch.deactivate(rservice.devwatch)
    assert answers["port"] == answers["reference"]
    assert np.unique([a["label"] for a in answers["port"]]).size == 3


def test_pool_on_the_evloop_front_answers_on_its_device_worker(
        tmp_path, monkeypatch):
    """A 2-worker pool with ``http_front="evloop"`` over a stored
    classification instance on the CPU: JSON and packed int8 answers from
    8 clients equal a CPU service's, every worker serves from the loop
    (the front's families in ``/metrics``), and the sibling's queries all
    cross the lane to worker 0 (no fallback)."""
    from pio_tpu_torch.server.worker_pool import ServingPool
    from pio_tpu_torch.storage.registry import Storage
    from test_torch_microbatch import cls_variant, cpu_answers, train_cls
    from test_torch_similarproduct import seed_events as seed_port
    from test_torch_worker_pool import _packer

    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE",
                           raising=False)
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    monkeypatch.setenv("PIO_TPU_DEVICE_RESIDENT", "1")
    monkeypatch.setenv("PIO_TPU_SERVE_WIRE", "int8")
    monkeypatch.setenv("PIO_TPU_LANE_TIMEOUT_S", "10")
    Storage.reset()
    try:
        seed_port(user_rows(), app=CLS_APP, reference=False)
        iid = train_cls(1)
        want = cpu_answers(iid, CLS_QUERIES)
        frames = [_packer(iid).pack_query_body(q) for q in CLS_QUERIES]
        pool = ServingPool(cls_variant(1), host="127.0.0.1", port=0,
                           n_workers=2, device_worker=True, device="cpu",
                           http_front="evloop")
        pool.start()
        try:
            pool.wait_ready(timeout=120)
            got = []
            for k in range(8):
                blob = b"".join(
                    _post("/queries.json", frames[i], ctype=PACKED)
                    if (i + k) % 2 else
                    _post("/queries.json", json.dumps(q).encode())
                    for i, q in enumerate(CLS_QUERIES))
                blob += _post("/queries.json", json.dumps(
                    CLS_QUERIES[k]).encode(), close=True)
                got.append(_pairs(_exchange(pool.port, blob)))
            for k, answers in enumerate(got):
                assert answers == [(200, a) for a in want] + [(200,
                                                                want[k])]
            device, sibling = pool.worker_stats(0), pool.worker_stats(1)
            metrics = http.client.HTTPConnection("127.0.0.1", pool.port,
                                                 timeout=IO_S)
            metrics.request("GET", "/metrics")
            text_ = metrics.getresponse().read().decode()
            metrics.close()
        finally:
            pool.stop()
    finally:
        Storage.reset()
    assert "pio_tpu_http_connections_active" in text_
    assert device["batchLane"]["role"] == "drainer"
    assert sibling["batchLane"]["role"] == "client"
    assert sum(sibling["batchLane"]["fallbacks"].values()) == 0
    assert device["batchLane"]["drained"] >= sibling["batchLane"]["enqueued"]
