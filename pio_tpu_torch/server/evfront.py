"""Selectors event-loop HTTP/1.1 front for the query server.

The port's copy of ``pio_tpu/server/evfront.py``. The threaded front in
:mod:`pio_tpu_torch.server.http` pays a thread a connection, and under
many keep-alive clients the cost of a request is scheduler wakeups and
lock hand-offs more than parsing or predict. This front serves every
connection from ONE loop a process:

* non-blocking accept off a listener (``SO_REUSEPORT`` when asked, so the
  workers of a pool share one port, a loop each),
* keep-alive with pipelining: requests already in the read buffer are
  served back to back, up to ``PIO_TPU_HTTP_MAX_PIPELINE`` between two
  flushes, and their answers leave in fewer writes,
* incremental header and body parsing over a per-connection buffer (no
  thread, no ``readline``), with the threaded parser's caps and statuses,
* write backpressure through the selector: above 256 KiB of unsent
  answer a connection is not read until the peer drains it,
* the idle and slowloris guard shared with the threaded front
  (``PIO_TPU_HTTP_IDLE_TIMEOUT_S``).

A body sent as :data:`~pio_tpu_torch.server.http.PACKED_QUERY_CONTENT_TYPE`
never touches JSON: the handler gets :attr:`Request.packed`, a
``memoryview`` into the connection's read buffer, which the lane client
copies into its shared-memory slot during the handler call. The buffer is
compacted only after the handler has returned.

Handlers run inline in the loop, so a query's forward launch and its copy
back to the host hold every other connection of the worker, as in the
reference. An exception in a handler answers 500 and the loop goes on.
The loop is a thread of its own: the query service gives every device
call its explicit ``torch.device``, so nothing here depends on a current
device.

Selection: ``PIO_TPU_HTTP_FRONT=evloop`` in
:func:`pio_tpu_torch.server.query_server.create_query_server` and
``deploy_query_server``, or a pool's ``http_front``. The threaded front
stays the default, and is the one that terminates TLS and spools the blob
daemon's large uploads: this constructor refuses both.
"""

from __future__ import annotations

import io
import json
import logging
import selectors
import socket
import threading
from collections import deque
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs

from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.server import http as _http
from pio_tpu_torch.server.http import (
    FileResponse,
    HTTPError,
    PACKED_QUERY_CONTENT_TYPE,
    RawResponse,
    Request,
    Router,
    SSL_FROM_ENV,
    json_response,
    ssl_context_from_env,
)
from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.server.evfront")

#: recv() chunk: one syscall drains a typical pipelined burst without
#: ballooning a connection's buffer
_RECV_CHUNK = 64 * 1024

#: output high-water mark: above this many unsent answer bytes the
#: connection is not read (or parsed) until the kernel drains it
_HIGH_WATER = 256 * 1024

#: request and header line length cap (the threaded parser's)
_MAX_LINE = 65536
#: header line count cap (the threaded parser's range(200))
_MAX_HEADERS = 200


def _packed_view(view, start: int, end: int):  # pio: hotpath=zerocopy
    """The packed query body sliced out of the connection's read buffer as
    a memoryview: the bytes the client sent are the bytes the lane client
    writes into its slot, with no ``bytes()`` copy between."""
    return view[start:end]


class _Conn:
    """Per-connection state: the socket, the read and write buffers, the
    incremental parse cursors and the post-write callback queue.

    ``obuf`` is per connection by design: one thread serves every
    connection here, so a shared buffer would interleave pipelined answers
    across connections."""

    __slots__ = (
        "sock", "peer", "ibuf", "obuf", "sent_abs", "cbs", "last",
        "closed", "close_after", "mask", "eof",
        # parse cursors (reset a request)
        "hdr_end", "scan_pos", "line_start", "n_lines", "t_req",
        # the parsed head (None or 0 until the header block completes)
        "method", "target", "headers", "length", "http10",
        "body_packed", "body_octet",
    )

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.peer = peer
        self.ibuf = bytearray()
        self.obuf = bytearray()
        self.sent_abs = 0          # bytes ever sent on this connection
        self.cbs: deque = deque()  # (abs_end, on_written, t_write, after)
        self.last = monotonic_s()
        self.closed = False
        self.close_after = False
        self.mask = 0
        self.eof = False
        self.reset_parse()

    def reset_parse(self) -> None:
        self.hdr_end = -1
        self.scan_pos = 0
        self.line_start = 0
        self.n_lines = 0
        self.t_req = -1.0
        self.method = ""
        self.target = ""
        self.headers = None
        self.length = 0
        self.http10 = False
        self.body_packed = False
        self.body_octet = False


class EvLoopHTTPServer:
    """:class:`~pio_tpu_torch.server.http.JsonHTTPServer`'s surface
    (``port``, ``start``, ``serve_forever``, ``stop``; the same
    :class:`Router` and :class:`Request` contract) over one selectors
    loop. Handlers run inline in the loop and must not park it.

    ``registry`` (a :class:`~pio_tpu_torch.obs.metrics.MetricsRegistry`,
    optional) gets ``pio_tpu_http_connections_active`` and
    ``pio_tpu_http_pipelined_total``."""

    def __init__(self, router: Router, host: str = "0.0.0.0",
                 port: int = 0, name: str = "pio-tpu-torch",
                 ssl_context: Any = SSL_FROM_ENV,
                 pre_body: Optional[Callable[[Request], None]] = None,
                 reuse_port: bool = False,
                 large_uploads: bool = False,
                 registry: Any = None):
        ctx = (ssl_context_from_env() if ssl_context is SSL_FROM_ENV
               else ssl_context)
        if ctx is not None:
            raise ValueError(
                "the evloop front has no TLS path — terminate TLS on the "
                "threaded front (PIO_TPU_HTTP_FRONT=threaded) or a proxy"
            )
        if large_uploads:
            raise ValueError(
                "the evloop front does not spool large uploads — the blob "
                "daemon requires the threaded front"
            )
        self.tls = False
        self._router = router
        self._name = name
        self._pre_body = pre_body
        self._idle_timeout_s = _http.http_idle_timeout_s()
        self._max_pipeline = knobs.knob_int("PIO_TPU_HTTP_MAX_PIPELINE")
        self._static_head: Dict[int, bytes] = {}
        self._conns: Dict[int, _Conn] = {}
        self._sel = selectors.DefaultSelector()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._last_sweep = monotonic_s()

        self._conn_gauge = None
        self._pipelined_total = None
        if registry is not None:
            self._conn_gauge = registry.gauge(
                "pio_tpu_http_connections_active",
                "Open connections on the event-loop HTTP front",
            )
            self._pipelined_total = registry.counter(
                "pio_tpu_http_pipelined_total",
                "Requests served from a read batch behind an earlier "
                "request on the same connection (pipelining depth proxy)",
            )
            # materialize the zero-label cells now: the workers of a pool
            # must create their cells in one order for the shared stripe
            # slots to line up
            self._conn_gauge.set(0.0)
            self._pipelined_total.labels()

        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if reuse_port:
                lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            lsock.bind((host, port))
            lsock.listen(_http.http_backlog())
            lsock.setblocking(False)
        except BaseException:
            lsock.close()
            raise
        self._lsock = lsock
        # a self-wake pair, so stop() from another thread breaks select()
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._sel.register(lsock, selectors.EVENT_READ, data=None)
        self._sel.register(self._waker_r, selectors.EVENT_READ, data="wake")

    # -- lifecycle -----------------------------------------------------

    @property
    def port(self) -> int:
        return self._lsock.getsockname()[1]

    def start(self) -> "EvLoopHTTPServer":
        """Serve in a background thread (the loop)."""
        self._thread = threading.Thread(
            target=self._run, name=f"{self._name}-evloop", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve in this thread until :meth:`stop` (from another)."""
        self._run()

    def stop(self) -> None:
        """Stop the loop and close every socket; idempotent (``/undeploy``
        and a pool's supervisor may race)."""
        if self._stopped:
            return
        self._stopped = True
        try:
            self._waker_w.send(b"x")
        except OSError:
            pass
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    # -- the loop ------------------------------------------------------

    def _run(self) -> None:  # pio: hotpath
        """One loop serves every connection: nothing reachable from here
        may park, or every other connection of the worker stalls."""
        try:
            while not self._stopped:
                timeout = min(1.0, self._idle_timeout_s)
                for key, mask in self._sel.select(timeout):
                    if self._stopped:
                        break
                    if key.data is None:
                        self._accept_ready()
                    elif key.data == "wake":
                        try:
                            self._waker_r.recv(64)
                        except OSError:
                            pass
                    else:
                        conn = key.data
                        try:
                            if mask & selectors.EVENT_WRITE \
                                    and not conn.closed:
                                self._on_writable(conn)
                            if mask & selectors.EVENT_READ \
                                    and not conn.closed:
                                self._on_readable(conn)
                        except Exception:  # boundary: the loop goes on
                            log.exception(
                                "connection handling failed (%s)", conn.peer
                            )
                            self._close(conn)
                self._sweep_idle()
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            try:
                self._sel.unregister(self._lsock)
            except (KeyError, ValueError):
                pass
            self._lsock.close()
            for s in (self._waker_r, self._waker_w):
                try:
                    s.close()
                except OSError:
                    pass
            self._sel.close()

    def _sweep_idle(self) -> None:  # pio: hotpath
        now = monotonic_s()
        if now - self._last_sweep < 1.0:
            return
        self._last_sweep = now
        for conn in list(self._conns.values()):
            if now - conn.last > self._idle_timeout_s:
                # idle or slowloris: no bytes for the whole window
                self._close(conn)

    def _accept_ready(self) -> None:  # pio: hotpath
        for _ in range(64):
            try:
                # non-blocking listener: EAGAIN ends the accept burst
                # instead of parking the loop
                # pio: disable=hotpath-blocking
                s, addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            s.setblocking(False)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(s, addr[0])
            self._conns[s.fileno()] = conn
            conn.mask = selectors.EVENT_READ
            self._sel.register(s, conn.mask, data=conn)
            if self._conn_gauge is not None:
                self._conn_gauge.inc(1.0)

    def _close(self, conn: _Conn) -> None:  # pio: hotpath
        if conn.closed:
            return
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        self._conns.pop(conn.sock.fileno(), None)
        try:
            conn.sock.close()
        except OSError:
            pass
        if self._conn_gauge is not None:
            self._conn_gauge.inc(-1.0)

    def _update_interest(self, conn: _Conn) -> None:  # pio: hotpath
        if conn.closed:
            return
        mask = selectors.EVENT_WRITE if conn.obuf else 0
        if len(conn.obuf) < _HIGH_WATER:
            mask |= selectors.EVENT_READ
        if mask != conn.mask:
            conn.mask = mask
            self._sel.modify(conn.sock, mask or selectors.EVENT_READ,
                             data=conn)

    # -- read side -----------------------------------------------------

    def _on_readable(self, conn: _Conn) -> None:  # pio: hotpath
        while True:
            try:
                # non-blocking socket: EAGAIN ends the drain instead of
                # parking the shared loop
                # pio: disable=hotpath-blocking
                chunk = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close(conn)
                return
            if not chunk:
                conn.eof = True
                break
            conn.ibuf += chunk
            if len(chunk) < _RECV_CHUNK:
                break
        if conn.ibuf and not conn.close_after:
            conn.last = monotonic_s()
            self._drain_requests(conn)
        if conn.eof and not conn.closed:
            if conn.headers is not None and not conn.close_after:
                # the peer half-closed mid-body: the threaded front's 400
                # for a short read
                self._reject(conn, 400, "incomplete body")
                self._flush(conn)
            self._close(conn)

    def _drain_requests(self, conn: _Conn) -> None:  # pio: hotpath
        """Serve every complete pipelined request in the buffer, in
        batches of ``PIO_TPU_HTTP_MAX_PIPELINE`` between flushes."""
        total = 0
        while not conn.closed:
            served = self._advance(conn)
            total += served
            if served == 0 or conn.obuf or conn.close_after:
                break
        if total > 1 and self._pipelined_total is not None:
            self._pipelined_total.inc(float(total - 1))

    def _advance(self, conn: _Conn) -> int:  # pio: hotpath
        served = 0
        while (not conn.close_after and served < self._max_pipeline
               and len(conn.obuf) < _HIGH_WATER):
            if self._serve_one(conn) is not True:
                break
            served += 1
        self._flush(conn)
        return served

    # -- incremental parser --------------------------------------------

    def _serve_one(self, conn: _Conn):  # pio: hotpath
        """Parse (incrementally) and dispatch ONE request from the
        connection's buffer: True when one was served, None when more
        bytes are needed, False when it was refused (the connection
        closes). Statuses and caps are the threaded parser's."""
        ibuf = conn.ibuf
        if conn.headers is None:
            if conn.hdr_end < 0:
                if conn.scan_pos == 0 and conn.n_lines == 0:
                    # stray CRLFs between requests are tolerated
                    while ibuf[:2] == b"\r\n" or ibuf[:1] == b"\n":
                        del ibuf[:2 if ibuf[:2] == b"\r\n" else 1]
                if not ibuf:
                    return None
                if conn.t_req < 0:
                    # the accept clock starts at the first request byte:
                    # keep-alive idle is not request latency
                    conn.t_req = monotonic_s()
                if self._scan_headers(conn) is not True:
                    return None if conn.hdr_end < 0 \
                        and not conn.close_after else False
            if self._parse_header_block(conn) is False:
                return False
            if conn.headers is None:
                return False  # refused inside the block parse
        need = conn.hdr_end + conn.length
        if len(ibuf) < need:
            return None
        return self._dispatch_one(conn, need)

    def _scan_headers(self, conn: _Conn):  # pio: hotpath
        """Advance the newline scan to the header block's blank line. The
        line-length and header-count caps hold on partial data, so a
        slowloris feeding one endless header line is refused long before
        any terminator."""
        ibuf = conn.ibuf
        while True:
            j = ibuf.find(b"\n", conn.scan_pos)
            if j < 0:
                conn.scan_pos = len(ibuf)
                if len(ibuf) - conn.line_start > _MAX_LINE:
                    if conn.n_lines == 0:
                        return self._reject(conn, 400,
                                            "request line too long")
                    return self._reject(conn, 431, "header line too long")
                return None
            if j + 1 - conn.line_start > _MAX_LINE:
                if conn.n_lines == 0:
                    return self._reject(conn, 400, "request line too long")
                return self._reject(conn, 431, "header line too long")
            blank = (j == conn.line_start
                     or (j == conn.line_start + 1
                         and ibuf[conn.line_start] == 0x0D))
            if blank:
                if conn.n_lines == 0:
                    # a stray blank line before the request line
                    conn.line_start = conn.scan_pos = j + 1
                    continue
                conn.hdr_end = j + 1
                return True
            conn.n_lines += 1
            if conn.n_lines > _MAX_HEADERS:
                return self._reject(conn, 431, "too many headers")
            conn.line_start = conn.scan_pos = j + 1

    def _parse_header_block(self, conn: _Conn):  # pio: hotpath
        """Request line and headers out of ``ibuf[:hdr_end]``, with the
        threaded parser's checks and messages. The block decodes once
        (latin-1 cannot fail) and splits on ``\\n`` only, as the byte scan
        does."""
        block = bytes(conn.ibuf[:conn.hdr_end]).decode("latin-1")
        lines = block.split("\n")
        parts = lines[0].strip().split()
        if len(parts) != 3:
            return self._reject(conn, 400, "malformed request line")
        method, target, version = parts
        if not method.isascii():
            # the threaded parser's ascii decode of the method: a latin-1
            # method byte stays a 400, not a 405
            return self._reject(conn, 400, "malformed request line")
        if not version.startswith("HTTP/1."):
            return self._reject(conn, 400, "unsupported HTTP version")
        if method not in _http._ALLOWED_METHODS:
            return self._reject(conn, 405, f"method {method!r} not allowed")
        headers: Dict[str, str] = {}
        last = None
        for hline in lines[1:]:
            stripped = hline.strip()
            if not stripped:
                continue
            if hline[0] in " \t":
                # RFC 9112 obs-fold continuation line
                if last is not None:
                    headers[last] += " " + stripped
                continue
            name, sep, value = hline.partition(":")
            if not sep:
                return self._reject(conn, 400, "malformed header")
            last = name.strip().lower()
            val = value.strip()
            if last in ("content-length", "transfer-encoding") \
                    and headers.get(last, val) != val:
                # differing duplicate framing headers are a request-
                # smuggling primitive behind a proxy (RFC 9112 §6.3)
                return self._reject(conn, 400, f"duplicate {last}")
            headers[last] = val
        if headers.get("transfer-encoding"):
            return self._reject(conn, 411, "Content-Length required")
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            return self._reject(conn, 400, "bad Content-Length")
        if length < 0:
            return self._reject(conn, 400, "bad Content-Length")
        if length > _http.MAX_BODY_MB * 2 ** 20:
            return self._reject(
                conn, 413, f"body exceeds {_http.MAX_BODY_MB:g} MiB limit"
            )
        ctype = headers.get("content-type", "").lower()
        packed = ctype.startswith(PACKED_QUERY_CONTENT_TYPE)
        octet = ctype.startswith("application/octet-stream")
        if length and length > _http.MAX_JSON_BODY_MB * 2 ** 20:
            # every body is held in RAM on this front (no large_uploads),
            # packed and octet-stream ones too
            return self._reject(
                conn, 413,
                f"body exceeds {_http.MAX_JSON_BODY_MB:g} MiB limit "
                f"for {ctype or 'structured'} content",
            )
        conn.http10 = version == "HTTP/1.0"
        if self._pre_body is not None and length:
            # auth before the body is dispatched (the kernel delivers it
            # anyway on a shared loop, but no handler sees it)
            try:
                self._pre_body(Request(
                    method=method, path=target.partition("?")[0],
                    params={}, body=None, headers=headers,
                    client_addr=conn.peer,
                ))
            except HTTPError as e:
                return self._reject(conn, e.status, e.message)
            except Exception:  # boundary: answer, never drop
                log.exception("pre_body hook failed")
                return self._reject(conn, 500, "internal server error")
        if length and headers.get(
            "expect", ""
        ).lower().startswith("100-continue"):
            # invite the body only after the caps and the auth passed
            conn.obuf += b"HTTP/1.1 100 Continue\r\n\r\n"
        conn.method = method
        conn.target = target
        conn.headers = headers
        conn.length = length
        conn.body_packed = bool(packed and length)
        conn.body_octet = bool(octet and length)
        return True

    def _dispatch_one(self, conn: _Conn, need: int):  # pio: hotpath
        """The body is complete: build the Request, run the handler
        inline, queue the answer, reclaim the consumed buffer prefix."""
        ibuf = conn.ibuf
        method, target, headers = conn.method, conn.target, conn.headers
        hdr_end, length = conn.hdr_end, conn.length
        conn_tok = headers.get("connection", "").lower()
        http10 = conn.http10
        if http10:
            close = "keep-alive" not in conn_tok
        else:
            close = "close" in conn_tok
        if close:
            conn.close_after = True
        head_only = method == "HEAD"
        path, _, query = target.partition("?")
        params = (
            {k: v[0] for k, v in parse_qs(query).items()} if query else {}
        )
        base_mv = None
        body = None
        raw = b""
        body_file = None
        packed = None
        if conn.body_packed:
            # zero-copy: the handler gets a view into ibuf, valid only for
            # the (synchronous) handler call; the prefix is reclaimed below
            base_mv = memoryview(ibuf)
            packed = _packed_view(base_mv, hdr_end, need)
        elif length:
            raw = bytes(ibuf[hdr_end:need])
            if conn.body_octet:
                # no spooling on this front: a body within the cap is
                # handed over as an in-memory file
                body_file = io.BytesIO(raw)
                raw = b""
            else:
                try:
                    body = json.loads(raw.decode("utf-8"))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    body = raw.decode("utf-8", errors="replace")
        req = Request(
            method=method, path=path, params=params, body=body,
            raw_body=raw, body_file=body_file, headers=headers,
            client_addr=conn.peer, packed=packed,
        )
        req.read_s = monotonic_s() - conn.t_req
        try:
            status, out = self._router.dispatch(req)
        except HTTPError as e:
            status = e.status
            out = (
                json_response({"message": e.message}, e.headers)
                if e.headers else {"message": e.message}
            )
        except Exception:  # boundary: a handler's fault (a CUDA error
            # too) answers 500 and the loop serves on
            log.exception("unhandled error on %s %s", method, path)
            status, out = 500, {"message": "internal server error"}
        finally:
            if body_file is not None:
                body_file.close()
        t_write = monotonic_s()
        self._respond(conn, status, out, head_only, http10, req, t_write)
        if base_mv is not None:
            try:
                packed.release()
                base_mv.release()
            except BufferError:
                # a handler kept a reference to the view: copy the tail out
                # instead of compacting in place
                conn.ibuf = bytearray(ibuf[need:])
                conn.reset_parse()
                return True
        del ibuf[:need]
        conn.reset_parse()
        return True

    # -- write side ----------------------------------------------------

    def _head_prefix(self, status: int) -> bytes:  # pio: hotpath
        got = self._static_head.get(status)
        if got is None:
            got = (
                f"HTTP/1.1 {status} {_http._REASONS.get(status, '')}\r\n"
                f"Server: {self._name}\r\n"
            ).encode("latin-1")
            self._static_head[status] = got
        return got

    def _respond(self, conn, status, body, head_only, http10, req, t_write):  # pio: hotpath
        """Serialize one answer into the connection's write buffer and
        queue its post-write hooks at its absolute end offset."""
        extra: Any = ()
        ctype = "application/json; charset=UTF-8"
        if isinstance(body, FileResponse):
            try:
                # a local file for the Router's parity (status pages); the
                # blob daemon's large streams stay on the threaded front
                # pio: disable=hotpath-blocking
                f = open(body.path, "rb")
            except OSError:
                self._respond(conn, 404, {"message": "no such blob"},
                              head_only, http10, req, t_write)
                return
            with f:
                payload = f.read()
            ctype = body.content_type
        elif isinstance(body, RawResponse):
            payload = (
                body.body if isinstance(body.body, bytes)
                else body.body.encode("utf-8")
            )
            ctype = body.content_type
            extra = body.headers.items()
        elif isinstance(body, bytes):
            payload = body  # ready JSON (the packed query wire)
        else:
            try:
                payload = (
                    json.dumps(body).encode() if body is not None else b""
                )
            except (TypeError, ValueError):
                log.exception("response not JSON-serializable")
                status = 500
                payload = b'{"message": "response not JSON-serializable"}'
        obuf = conn.obuf
        obuf += self._head_prefix(status)
        obuf += f"Content-Type: {ctype}\r\n".encode("latin-1")
        obuf += b"Content-Length: %d\r\n" % len(payload)
        for k, v in extra:
            obuf += f"{k}: {v}\r\n".encode("latin-1")
        if conn.close_after:
            obuf += b"Connection: close\r\n"
        elif http10:
            obuf += b"Connection: keep-alive\r\n"
        obuf += b"\r\n"
        if payload and not head_only:
            obuf += payload
        if req is not None and (req.on_written is not None
                                or req.after_response is not None):
            conn.cbs.append((conn.sent_abs + len(obuf), req.on_written,
                             t_write, req.after_response))

    def _reject(self, conn: _Conn, status: int, message: str):  # pio: hotpath
        """Terminal error answer, as the threaded front's ``_reject``:
        answer, then close once the bytes drain."""
        conn.close_after = True
        self._respond(conn, status, {"message": message},
                      False, conn.http10, None, 0.0)
        return False

    def _on_writable(self, conn: _Conn) -> None:  # pio: hotpath
        self._flush(conn)
        if not conn.closed and not conn.obuf and conn.ibuf \
                and not conn.close_after:
            # backpressure released: serve what arrived meanwhile
            self._drain_requests(conn)

    def _flush(self, conn: _Conn) -> None:  # pio: hotpath
        if conn.closed:
            return
        obuf = conn.obuf
        while obuf:
            try:
                # non-blocking send(): takes what fits in the kernel's
                # buffer; EAGAIN re-arms EVENT_WRITE instead of parking
                n = conn.sock.send(obuf)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close(conn)
                return
            if n <= 0:
                break
            conn.sent_abs += n
            del obuf[:n]
        self._fire_written(conn)
        if not obuf and conn.close_after:
            self._close(conn)
            return
        self._update_interest(conn)

    def _fire_written(self, conn: _Conn) -> None:  # pio: hotpath
        cbs = conn.cbs
        while cbs and cbs[0][0] <= conn.sent_abs:
            _, on_written, t_write, after = cbs.popleft()
            if on_written is not None:
                try:
                    on_written(monotonic_s() - t_write)
                except Exception:  # a tracing hook must not drop the link
                    log.exception("on_written hook failed")
            if after is not None:
                try:
                    after()
                except Exception:
                    log.exception("after_response hook failed")
