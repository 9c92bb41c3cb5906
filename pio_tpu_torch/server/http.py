"""Minimal threaded HTTP JSON server shared by the Event and Query servers.

The port's copy of ``pio_tpu/server/http.py`` (the port imports nothing of
``pio_tpu``): a standard-library ``ThreadingHTTPServer`` with a route
table. Handlers receive a :class:`Request` and return ``(status,
json_body)``; each connection is parsed by a hand-rolled HTTP/1.1 reader
(``http.server``'s header parsing through ``email.parser`` costs about
200 µs a request) and each response leaves in one write with
``TCP_NODELAY`` on (with Nagle on, a keep-alive answer waits 40 ms or
more for the client's delayed ACK).

A body sent as :data:`PACKED_QUERY_CONTENT_TYPE` reaches the handler
untouched as :attr:`Request.packed`; a handler may answer ready JSON
bytes instead of an object, or a :class:`RawResponse` of another type
(the Prometheus text of ``GET /metrics``) or with extra headers
(:func:`json_response`: ``X-Pio-Trace``, ``X-Pio-Degraded``). An
:class:`HTTPError` may carry headers too (``Retry-After`` on a shed).
The request records :attr:`Request.read_s`, its read and parse off the
socket (a trace's ``accept`` stage), and a handler may set
:attr:`Request.on_written`, called with the write's seconds once the
answer is flushed (the ``write`` stage). ``reuse_port`` sets ``SO_REUSEPORT`` before
bind, so the processes of a serving pool share one port.

The blob daemon's bodies: an ``application/octet-stream`` body is spooled
off the socket in chunks (:attr:`Request.body_file`), up to
:data:`MAX_BODY_MB` on a server built with ``large_uploads`` and to
:data:`MAX_JSON_BODY_MB` elsewhere; a :class:`FileResponse` streams a file
out in constant memory; a ``pre_body`` hook (the daemon's auth) runs
before any body byte is read.

**Knobs**, read as the reference reads them: the body caps
(``PIO_TPU_MAX_BODY_MB``, ``PIO_TPU_MAX_JSON_BODY_MB``) when this module
is imported, the listen backlog (``PIO_TPU_HTTP_BACKLOG``) and the idle
timeout (``PIO_TPU_HTTP_IDLE_TIMEOUT_S``, 30 s) when a server is built.

**TLS.** ``PIO_TPU_SSL_CERTFILE`` (and ``PIO_TPU_SSL_KEYFILE``, unless the
certificate file bundles the key) switch every server built on
:class:`JsonHTTPServer` to HTTPS: the event server, the query server's
threaded front, the blob daemon, admin, the dashboard, ``fleetd``,
``routerd`` and the trainer's sidecar. Each connection is wrapped in its
own thread, never in the accept loop. ``ssl_context=None`` forces plain
HTTP.

The query server may serve from the selectors event loop of
:mod:`pio_tpu_torch.server.evfront` instead (``PIO_TPU_HTTP_FRONT=
evloop``); both fronts share the :class:`Router` and :class:`Request`
contract and the knobs above.
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import re
import socket
import socketserver
import ssl
import tempfile
import threading
from dataclasses import dataclass, field
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from pio_tpu_torch.obs import slog
from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.server")

#: Reject request bodies above this many MiB with 413 (an unbounded body
#: is a trivial memory or disk DoS on any server facing a network)
MAX_BODY_MB = knobs.knob_float("PIO_TPU_MAX_BODY_MB")

#: Structured (JSON, form, packed) bodies are parsed in RAM, so they get a
#: far tighter cap than the blob daemon's raw uploads
MAX_JSON_BODY_MB = knobs.knob_float("PIO_TPU_MAX_JSON_BODY_MB")

#: an octet-stream body spills from RAM to a temporary file above this
_SPOOL_BYTES = 8 << 20


def http_backlog() -> int:
    """Listen backlog of both fronts, read when a server is built
    (socketserver's default of 5 overflows under a 16-client connect
    burst, and the dropped SYNs retransmit after about a second)."""
    return knobs.knob_int("PIO_TPU_HTTP_BACKLOG")


def http_idle_timeout_s() -> float:
    """The idle and slowloris guard of both fronts: a connection that
    produces no bytes for this long is closed. Read when a server is
    built."""
    return knobs.knob_float("PIO_TPU_HTTP_IDLE_TIMEOUT_S")


#: Content type of the packed int8 query wire: the request body IS a
#: batch-lane frame (``batchlane.pack_query_i8``'s layout: NUL-led magic,
#: dim, codes), handed to the handler as :attr:`Request.packed` with no
#: JSON attempt and no decode
PACKED_QUERY_CONTENT_TYPE = "application/x-pio-query-i8"


def keys_equal(provided: str, expected: str) -> bool:
    """Constant-time access-key comparison (no prefix-length timing leak)."""
    return hmac.compare_digest(
        provided.encode("utf-8", "replace"), expected.encode("utf-8", "replace")
    )


@dataclass
class Request:
    method: str
    path: str
    params: Dict[str, str]
    body: Optional[Any]  # parsed JSON (or raw str for non-JSON bodies)
    raw_body: bytes = b""
    #: header names lowercased (HTTP/2-origin clients send lowercase)
    headers: Dict[str, str] = field(default_factory=dict)
    path_args: Tuple[str, ...] = ()
    client_addr: str = ""
    #: handler-settable hook invoked AFTER the response is written to the
    #: socket — for actions that must not race the reply (e.g. /undeploy
    #: stopping the server)
    after_response: Optional[Callable[[], None]] = None
    #: body bytes of a :data:`PACKED_QUERY_CONTENT_TYPE` request: ``bytes``
    #: from the threaded front, a ``memoryview`` into the connection's read
    #: buffer from the event loop (valid only during the handler call);
    #: ``body`` and ``raw_body`` stay empty for these requests
    packed: Optional[Any] = None
    #: an ``application/octet-stream`` body, spooled off the socket
    #: (``raw_body`` stays empty); closed after the handler returns
    body_file: Optional[Any] = None
    #: seconds spent reading and parsing this request off the socket
    #: (first request-line byte to body parsed): the "accept" stage of a
    #: latency waterfall; keep-alive idle before the request line excluded
    read_s: float = 0.0
    #: handler-settable hook called with the response write's seconds
    #: once the reply is flushed: the "write" stage (the handler has
    #: returned by then, so tracing needs a callback)
    on_written: Optional[Callable[[float], None]] = None

    def header(self, name: str, default: Optional[str] = None):
        return self.headers.get(name.lower(), default)

    def bearer_key(self) -> str:
        """Access key from ?accessKey= or the Authorization header."""
        key = self.params.get("accessKey") or self.header("Authorization", "")
        if key.startswith("Bearer "):
            key = key[len("Bearer "):]
        return key


Handler = Callable[[Request], Tuple[int, Any]]


@dataclass
class RawResponse:
    """Handler output of its own type, or with extra headers: a text or
    bytes body."""

    body: Any  # str or bytes
    content_type: str = "text/plain; charset=utf-8"
    headers: Dict[str, str] = field(default_factory=dict)


def json_response(body: Any, headers: Dict[str, str]) -> RawResponse:
    """A JSON body that carries extra headers (a plain dict answer
    cannot): ``X-Pio-Trace``, ``X-Pio-Degraded``, ``Retry-After``."""
    return RawResponse(json.dumps(body),
                       content_type="application/json; charset=UTF-8",
                       headers=headers)


@dataclass
class FileResponse:
    """Stream a file to the client in constant memory (the blob daemon's
    GET path — a multi-GB model artifact must not be buffered per
    request). The file is opened at response time; a vanished file
    becomes a 404."""

    path: str
    content_type: str = "application/octet-stream"
    chunk_size: int = 1 << 20


#: Prometheus scrape content type (text format 0.0.4).
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def metrics_response(lines: List[str]) -> RawResponse:
    """Exposition lines in the Prometheus scrape content type — the body
    of every ``GET /metrics`` handler."""
    return RawResponse("\n".join(lines) + "\n",
                       content_type=METRICS_CONTENT_TYPE)


def int_param(params: Dict[str, str], name: str, default: int,
              lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    """A validated integer query param: not an integer, or below ``lo``,
    answers 400 (a typo'd ``?n=`` must not fall back to the default);
    above ``hi`` it clamps (asking for more than a ring holds is
    well-defined)."""
    raw = params.get(name)
    if raw is None:
        return default
    try:
        v = int(raw)
    except (TypeError, ValueError):
        raise HTTPError(400, f"query param {name}={raw!r} is not an integer")
    if lo is not None and v < lo:
        raise HTTPError(400, f"query param {name}={v} is below {lo}")
    if hi is not None and v > hi:
        v = hi
    return v


def float_param(params: Dict[str, str], name: str, default: float,
                lo: Optional[float] = None) -> float:
    """A validated float query param, :func:`int_param`'s contract
    (``/stats.json?window=abc`` is a 400, not the cumulative view)."""
    raw = params.get(name)
    if raw is None:
        return default
    try:
        v = float(raw)
    except (TypeError, ValueError):
        raise HTTPError(400, f"query param {name}={raw!r} is not a number")
    if v != v:  # NaN compares unequal to itself
        raise HTTPError(400, f"query param {name} must be a finite number")
    if lo is not None and v < lo:
        raise HTTPError(400, f"query param {name} must be >= {lo:g}")
    return v


def logs_route(req: "Request"):
    """``GET /logs.json`` of every server: the newest structured log
    entries (``?n=``, clamped to the ring), filtered by minimum ``level``,
    exact ``trace_id`` and ``logger`` prefix."""
    n = int_param(req.params, "n", 100, lo=0, hi=slog.ring().cap)
    try:
        return 200, slog.logs_payload(
            n=n, level=req.params.get("level"),
            trace_id=req.params.get("trace_id"),
            logger=req.params.get("logger"))
    except ValueError as e:
        raise HTTPError(400, str(e))


class HTTPError(Exception):
    """Handler-raised error, answered as ``{"message": ...}``; ``headers``
    (optional) go out on the answer (``Retry-After`` on a 429 or 503)."""

    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = dict(headers) if headers else {}


class Router:
    """Method+regex route table."""

    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method, re.compile(f"^{pattern}$"), handler))

    def dispatch(self, req: Request) -> Tuple[int, Any]:
        for method, pattern, handler in self._routes:
            if method != req.method:
                continue
            m = pattern.match(req.path)
            if m:
                req.path_args = m.groups()
                return handler(req)
        return 404, {"message": f"no route for {req.method} {req.path}"}


_REASONS = {
    200: "OK", 201: "Created", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    411: "Length Required", 413: "Content Too Large",
    429: "Too Many Requests",
    431: "Request Header Fields Too Large", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}

_ALLOWED_METHODS = frozenset(
    {"GET", "POST", "PUT", "DELETE", "HEAD", "OPTIONS", "PATCH"}
)


def _make_handler_class(router: Router, server_name: str,
                        pre_body: Optional[Callable[[Request], None]] = None,
                        large_uploads: bool = False):
    """Per-connection handler with a hand-rolled HTTP/1.1 parser.

    ``pre_body(req)`` (a request without its body) runs before any body
    byte is read and may raise :class:`HTTPError`; ``large_uploads`` lets
    octet-stream bodies up to :data:`MAX_BODY_MB` through."""

    class JsonHandler(socketserver.StreamRequestHandler):
        rbufsize = 64 * 1024
        wbufsize = 64 * 1024
        disable_nagle_algorithm = True
        # the socket timeout is the idle and slowloris guard: a keep-alive
        # connection (or a stalled read) silent this long raises and the
        # thread exits. Read once, when the server is built
        timeout = http_idle_timeout_s()

        command = ""  # current request method (HEAD gates body writes)
        http10 = False  # current request is HTTP/1.0 (keep-alive echo)

        def handle(self):
            self.close_connection = False
            try:
                while not self.close_connection:
                    if not self._handle_one():
                        break
            except OSError:  # covers ConnectionError and TimeoutError
                pass

        # -- response writing ------------------------------------------
        def _head(self, status: int, ctype: str, length: int,
                  extra=()) -> bytes:
            head = (
                f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
                f"Server: {server_name}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {length}\r\n"
            )
            for name, value in extra:
                head += f"{name}: {value}\r\n"
            if self.close_connection:
                head += "Connection: close\r\n"
            elif self.http10:
                # an HTTP/1.0 client assumes close unless keep-alive is
                # echoed back
                head += "Connection: keep-alive\r\n"
            return (head + "\r\n").encode("latin-1")

        def _send_file(self, status: int, body: FileResponse):
            try:
                f = open(body.path, "rb")
            except OSError:
                self._respond(404, {"message": "no such blob"})
                return
            with f:
                self.wfile.write(self._head(
                    status, body.content_type, os.fstat(f.fileno()).st_size))
                if self.command != "HEAD":
                    while chunk := f.read(body.chunk_size):
                        self.wfile.write(chunk)
            self.wfile.flush()

        def _respond(self, status: int, body: Any):
            if isinstance(body, FileResponse):
                self._send_file(status, body)
                return
            ctype = "application/json; charset=UTF-8"
            extra = ()
            try:
                if isinstance(body, RawResponse):
                    ctype = body.content_type
                    extra = body.headers.items()
                    payload = (body.body if isinstance(body.body, bytes)
                               else body.body.encode("utf-8"))
                elif isinstance(body, bytes):
                    payload = body  # ready JSON (the packed query wire)
                else:
                    payload = (json.dumps(body).encode()
                               if body is not None else b"")
            except (TypeError, ValueError):
                # un-serializable handler output must still produce an
                # HTTP response, not a dropped connection
                log.exception("response not JSON-serializable")
                status = 500
                payload = b'{"message": "response not JSON-serializable"}'
            out = self._head(status, ctype, len(payload), extra)
            # HEAD carries Content-Length but no body bytes (RFC 9110)
            if self.command != "HEAD":
                out += payload
            self.wfile.write(out)
            self.wfile.flush()

        def _reject(self, status: int, message: str) -> bool:
            """Terminal error response: close the connection after it."""
            self.close_connection = True
            self._respond(status, {"message": message})
            return False

        # -- request parsing -------------------------------------------
        def _handle_one(self) -> bool:
            self.command = ""
            line = self.rfile.readline(65537)
            if not line:
                return False  # client closed the keep-alive connection
            t_accept = monotonic_s()
            if len(line) > 65536:
                return self._reject(400, "request line too long")
            line = line.strip()
            if not line:
                return True  # stray CRLF between requests — tolerated
            parts = line.split()
            if len(parts) != 3:
                return self._reject(400, "malformed request line")
            try:
                method = parts[0].decode("ascii")
                target = parts[1].decode("latin-1")
            except UnicodeDecodeError:
                return self._reject(400, "malformed request line")
            version = parts[2]
            if not version.startswith(b"HTTP/1."):
                return self._reject(400, "unsupported HTTP version")
            if method not in _ALLOWED_METHODS:
                return self._reject(405, f"method {method!r} not allowed")

            headers: Dict[str, str] = {}
            last = None
            for _ in range(200):
                hline = self.rfile.readline(65537)
                if not hline:
                    return False  # peer vanished mid-headers
                if len(hline) > 65536:
                    return self._reject(431, "header line too long")
                if hline in (b"\r\n", b"\n"):
                    break
                if hline[:1] in (b" ", b"\t"):
                    # RFC 9112 obs-fold continuation line
                    if last is not None:
                        headers[last] += " " + hline.strip().decode("latin-1")
                    continue
                name, sep, value = hline.partition(b":")
                if not sep:
                    return self._reject(400, "malformed header")
                last = name.strip().decode("latin-1").lower()
                val = value.strip().decode("latin-1")
                if last in ("content-length", "transfer-encoding") \
                        and headers.get(last, val) != val:
                    # differing duplicate framing headers are a request-
                    # smuggling primitive behind a proxy (RFC 9112 §6.3)
                    return self._reject(400, f"duplicate {last}")
                headers[last] = val
            else:
                return self._reject(431, "too many headers")

            self.command = method
            conn_tok = headers.get("connection", "").lower()
            self.http10 = version == b"HTTP/1.0"
            if self.http10:
                self.close_connection = "keep-alive" not in conn_tok
            else:
                self.close_connection = "close" in conn_tok
            self._dispatch(method, target, headers, t_accept)
            return not self.close_connection

        def _dispatch(self, method: str, target: str, headers: Dict[str, str],
                      t_accept: Optional[float] = None):
            path, _, query = target.partition("?")
            params = (
                {k: v[0] for k, v in parse_qs(query).items()} if query else {}
            )
            if headers.get("transfer-encoding"):
                # chunked bodies aren't framed by Content-Length; reading
                # them naively corrupts keep-alive framing
                self._reject(411, "Content-Length required")
                return
            try:
                length = int(headers.get("content-length") or 0)
            except ValueError:
                self._reject(400, "bad Content-Length")
                return
            if length < 0:
                # read(-1) would mean read-to-EOF
                self._reject(400, "bad Content-Length")
                return
            if length > MAX_BODY_MB * 2 ** 20:
                # an over-limit body cannot be drained cheaply: close
                self._reject(413, f"body exceeds {MAX_BODY_MB:g} MiB limit")
                return
            ctype = headers.get("content-type", "")
            octet = ctype.lower().startswith("application/octet-stream")
            if length and (not octet or not large_uploads) \
                    and length > MAX_JSON_BODY_MB * 2 ** 20:
                # structured bodies are parsed in RAM; so is an octet-stream
                # body unless the server opted into large uploads (the blob
                # daemon, whose pre_body auth runs before any body byte)
                self._reject(
                    413, f"body exceeds {MAX_JSON_BODY_MB:g} MiB limit "
                         f"for {ctype.lower() or 'structured'} content")
                return
            if length and pre_body is not None:
                # auth runs before any body byte is consumed, or an
                # unauthenticated client could burn disk or RAM up to the
                # body limit a request
                try:
                    pre_body(Request(
                        method=method, path=path, params=params, body=None,
                        headers=headers, client_addr=self.client_address[0],
                    ))
                except HTTPError as e:
                    self._reject(e.status, e.message)  # body unread
                    return
                except Exception:  # boundary: answer, never drop
                    log.exception("pre_body hook failed")
                    self._reject(500, "internal server error")
                    return
            if length and headers.get("expect", "").lower().startswith(
                    "100-continue"):
                # invite the body only after the size cap and the
                # pre-body auth passed
                self.wfile.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                self.wfile.flush()
            body_file = None
            raw = b""
            if length and octet:
                # binary upload (blob daemon): spool off the socket in
                # chunks, never holding a whole artifact in memory
                body_file = tempfile.SpooledTemporaryFile(max_size=_SPOOL_BYTES)
                remaining = length
                while remaining:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    body_file.write(chunk)
                    remaining -= len(chunk)
                if remaining:
                    # the client died mid-upload: a truncated body must
                    # not be stored with a 201
                    body_file.close()
                    self._reject(400, "incomplete body")
                    return
                body_file.seek(0)
            elif length:
                raw = self.rfile.read(length)
                if len(raw) < length:
                    self._reject(400, "incomplete body")
                    return
            body = None
            packed = None
            if raw and ctype.startswith(PACKED_QUERY_CONTENT_TYPE):
                # packed binary query wire: the body is a lane frame
                packed, raw = raw, b""
            elif raw:
                # try JSON regardless of Content-Type — real clients (curl
                # -d without -H) post JSON bodies under the form type;
                # non-JSON bodies stay raw strings, which handlers that
                # need JSON objects reject with a 400
                try:
                    body = json.loads(raw.decode("utf-8"))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    body = raw.decode("utf-8", errors="replace")
            req = Request(
                method=method, path=path, params=params, body=body,
                raw_body=raw, headers=headers,
                client_addr=self.client_address[0], packed=packed,
                body_file=body_file,
            )
            if t_accept is not None:
                req.read_s = monotonic_s() - t_accept
            try:
                status, out = router.dispatch(req)
            except HTTPError as e:
                status = e.status
                out = (json_response({"message": e.message}, e.headers)
                       if e.headers else {"message": e.message})
            except Exception:  # boundary: the server keeps answering
                log.exception("unhandled error on %s %s", method, path)
                status, out = 500, {"message": "internal server error"}
            finally:
                if body_file is not None:
                    body_file.close()
            t_write = monotonic_s()
            self._respond(status, out)
            if req.on_written is not None:
                try:
                    req.on_written(monotonic_s() - t_write)
                except Exception:  # a tracing hook must not drop the link
                    log.exception("on_written hook failed")
            if req.after_response is not None:
                req.after_response()

    return JsonHandler


def ssl_context_from_env() -> Optional[ssl.SSLContext]:
    """TLS from the environment, or None for plain HTTP:
    ``PIO_TPU_SSL_CERTFILE`` and ``PIO_TPU_SSL_KEYFILE`` (PEM paths; the
    key file may be left unset where the certificate bundles the key)."""
    cert = knobs.knob_str("PIO_TPU_SSL_CERTFILE")
    if not cert:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, knobs.knob_str("PIO_TPU_SSL_KEYFILE") or None)
    return ctx


#: the default of ``ssl_context``: "none given, consult the environment".
#: Distinct from None, which forces plain HTTP even where ``PIO_TPU_SSL_*``
#: is set (a loopback endpoint beside a public HTTPS server)
SSL_FROM_ENV: Any = object()


class _Server(ThreadingHTTPServer):
    """TLS wrapped per connection, in the connection's own thread.

    Wrapping the listening socket would run the blocking handshake in the
    one accept loop, where a client that connects and never sends its
    ClientHello stalls every other connection; ``finish_request`` runs in
    the connection's thread, so a stalled handshake costs only that
    thread."""

    daemon_threads = True
    ssl_ctx: Optional[ssl.SSLContext] = None
    handshake_timeout = 30.0
    #: SO_REUSEPORT before bind: N worker processes share one port, the
    #: kernel balancing connections across them (the serving pool)
    reuse_port = False

    def server_bind(self):
        if self.reuse_port:
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()

    def finish_request(self, request, client_address):
        if self.ssl_ctx is None:
            super().finish_request(request, client_address)
            return
        prev = request.gettimeout()
        try:
            request.settimeout(self.handshake_timeout)
            tls_sock = self.ssl_ctx.wrap_socket(request, server_side=True)
            tls_sock.settimeout(prev)
        except (OSError, ssl.SSLError) as e:  # a bad or absent handshake
            log.debug("TLS handshake failed from %s: %s", client_address, e)
            try:
                request.close()
            except OSError:
                pass
            return
        try:
            super().finish_request(tls_sock, client_address)
        finally:
            # wrap_socket detached the original socket, so the outer
            # shutdown_request cannot close this descriptor: close it here
            try:
                tls_sock.close()
            except OSError:
                pass


class JsonHTTPServer:
    """Threaded server with programmatic start/stop (tests + CLI).
    ``ssl_context`` is :data:`SSL_FROM_ENV` (TLS where
    ``PIO_TPU_SSL_CERTFILE`` is set), an ``ssl.SSLContext``, or None for
    plain HTTP; :attr:`tls` says which it serves."""

    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 0,
                 name: str = "pio-tpu-torch", reuse_port: bool = False,
                 pre_body: Optional[Callable[[Request], None]] = None,
                 large_uploads: bool = False,
                 ssl_context: Any = SSL_FROM_ENV):
        self._httpd = _Server(
            (host, port),
            _make_handler_class(router, name, pre_body, large_uploads),
            bind_and_activate=False,
        )
        self._httpd.reuse_port = reuse_port
        self._httpd.request_queue_size = http_backlog()
        try:
            self._httpd.server_bind()
            self._httpd.server_activate()
        except BaseException:
            self._httpd.server_close()
            raise
        ctx = (ssl_context_from_env() if ssl_context is SSL_FROM_ENV
               else ssl_context)
        self.tls = ctx is not None
        self._httpd.ssl_ctx = ctx
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._stopped = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "JsonHTTPServer":
        """Serve in a background thread."""
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        """Serve in this thread until :meth:`stop` (from another)."""
        self._serving = True
        self._httpd.serve_forever()

    def stop(self):
        """Stop serving and close the socket; idempotent (``/undeploy``
        and the owner's ``close`` may race)."""
        if self._stopped:
            return
        self._stopped = True
        if self._serving:  # shutdown() waits for a loop that never ran
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
