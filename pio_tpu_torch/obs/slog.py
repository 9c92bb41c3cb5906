"""Structured JSON logging with trace correlation.

The port's copy of ``pio_tpu/obs/slog.py`` (the port imports nothing of
``pio_tpu``). Three pieces:

- :class:`JsonLogHandler` — a ``logging.Handler`` that renders each
  record as ONE line of JSON (``ts/level/logger/msg/trace_id/span/
  worker`` plus exception text), so the serving daemons' stderr is
  machine-parseable by any log shipper without a custom grok pattern.
- A **trace contextvar**: :class:`pio_tpu_torch.obs.tracing.Tracer` publishes
  the active ``(trace_id, span)`` here on entry and restores it on exit,
  so ANY log emitted inside a span — handler code, storage, an
  algorithm's own logger — carries the id of the request that caused it.
  ``/logs.json?trace_id=...`` then answers "what did request X log"
  and joins against the same id in ``/traces.json``.
- A bounded in-process **ring** of recent entries surfaced as
  ``GET /logs.json?level=&trace_id=&n=`` on the query and event
  servers and the trainer's sidecar — the last N log lines without shell
  access to the serving host.

Volume is metered by ``pio_tpu_log_messages_total{level,logger}`` in the
process-global registry (a log-rate spike is an incident signal in its
own right); HTTP services re-expose those lines on their own ``/metrics``
via a collector (:func:`exposition_lines`).

The ring + counter are always on once :func:`install` runs (cheap: one
dict per record). JSON **console** rendering is opt-in — the CLI entry
points pass ``stream`` (or set ``PIO_TPU_LOG_JSON=1``) so interactive
``pytest``/REPL sessions keep the human format.

The handler attaches to the ``pio_tpu_torch`` logger tree, never to the
root logger: ``pio_tpu_torch`` is not a child of the reference's
``pio_tpu`` logger, so when both packages run in one process each ring
holds only its own package's records.
"""

from __future__ import annotations

import contextvars
import datetime as _dt
import io
import json
import logging
import sys
import threading
from typing import Dict, List, Optional, Tuple

from pio_tpu_torch.obs.metrics import REGISTRY
from pio_tpu_torch.utils import knobs

#: the active (trace_id, span) for THIS thread/task — set by Tracer.trace
#: and _TraceHandle.span, read by every JsonLogHandler.emit. A contextvar
#: (not a threading.local) so async frameworks layered on top inherit it
#: across await points for free.
TRACE_CONTEXT: contextvars.ContextVar[Tuple[Optional[str], Optional[str]]] = \
    contextvars.ContextVar("pio_tpu_torch_trace", default=(None, None))

#: log records by severity and origin logger (process-global registry:
#: logging has no per-service owner; HTTP services re-expose via
#: exposition_lines collectors)
_LOG_MESSAGES = REGISTRY.counter(
    "pio_tpu_log_messages_total",
    "Log records emitted, by level and logger",
    ("level", "logger"),
)

#: default ring capacity (override with PIO_TPU_LOG_RING)
DEFAULT_RING = 512


def current_trace_id() -> Optional[str]:
    """The trace id of the enclosing span, if any."""
    return TRACE_CONTEXT.get()[0]


class LogRing:
    """Bounded ring of structured log entries (dicts), oldest evicted."""

    def __init__(self, cap: int = DEFAULT_RING):
        self._lock = threading.Lock()
        self._cap = max(int(cap), 1)
        self._ring: List[dict] = []
        self._pos = 0
        self.dropped = 0  # entries evicted since start

    @property
    def cap(self) -> int:
        return self._cap

    def append(self, entry: dict) -> None:
        with self._lock:
            if len(self._ring) < self._cap:
                self._ring.append(entry)
            else:
                self._ring[self._pos] = entry
                self._pos = (self._pos + 1) % self._cap
                self.dropped += 1

    def tail(self, n: int = 100, level: Optional[str] = None,
             trace_id: Optional[str] = None,
             logger: Optional[str] = None) -> List[dict]:
        """The newest ``n`` entries matching the filters, in
        chronological order. ``level`` is a minimum severity (``WARNING``
        matches WARNING and above); ``trace_id`` an exact match;
        ``logger`` a name prefix."""
        min_no = None
        if level:
            min_no = logging.getLevelName(level.upper())
            if not isinstance(min_no, int):
                raise ValueError(f"unknown level {level!r}")
        with self._lock:
            # chronological: the tail after the cursor is oldest
            entries = self._ring[self._pos:] + self._ring[:self._pos]
        out = []
        for e in entries:
            if min_no is not None and e.get("levelno", 0) < min_no:
                continue
            if trace_id is not None and e.get("trace_id") != trace_id:
                continue
            if logger is not None and not str(
                e.get("logger", "")
            ).startswith(logger):
                continue
            out.append(e)
        return out[-n:] if n >= 0 else out

    def snapshot(self) -> List[dict]:
        return self.tail(n=-1)


def _public(entry: dict) -> dict:
    """The wire shape of one entry (drops the internal levelno)."""
    return {k: v for k, v in entry.items() if k != "levelno"}


class JsonLogHandler(logging.Handler):
    """Renders records as one-line JSON; feeds the ring + counter.

    ``stream`` is optional — without one the handler only records (ring
    + metrics), leaving console formatting to whatever other handlers
    are installed. With one (the CLI daemons pass stderr) every line the
    process logs becomes machine-parseable.
    """

    def __init__(self, ring: Optional[LogRing] = None,
                 stream: Optional[io.TextIOBase] = None,
                 worker: Optional[int] = None,
                 level: int = logging.DEBUG):
        super().__init__(level=level)
        self.ring = ring if ring is not None else LogRing()
        self.stream = stream
        self.worker = worker

    def entry_for(self, record: logging.LogRecord) -> dict:
        try:
            msg = record.getMessage()
        except Exception:  # a bad %-format must not kill the logger
            msg = str(record.msg)
        trace_id, span = TRACE_CONTEXT.get()
        entry = {
            "ts": _dt.datetime.fromtimestamp(
                record.created, _dt.timezone.utc
            ).isoformat(timespec="milliseconds"),
            "level": record.levelname,
            "levelno": record.levelno,
            "logger": record.name,
            "msg": msg,
            "trace_id": trace_id,
            "span": span,
            "worker": self.worker,
        }
        if record.exc_info and record.exc_info[0] is not None:
            try:
                entry["exc"] = logging.Formatter().formatException(
                    record.exc_info
                )
            except Exception:
                pass
        return entry

    def format_line(self, record: logging.LogRecord) -> str:
        return json.dumps(_public(self.entry_for(record)), default=str)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = self.entry_for(record)
            _LOG_MESSAGES.inc(level=record.levelname, logger=record.name)
            self.ring.append(entry)
            if self.stream is not None:
                self.stream.write(
                    json.dumps(_public(entry), default=str) + "\n"
                )
                self.stream.flush()
        except Exception:
            self.handleError(record)


# -- process-wide installation ---------------------------------------------
_install_lock = threading.Lock()
_handler: Optional[JsonLogHandler] = None


def install(stream: Optional[io.TextIOBase] = None,
            worker: Optional[int] = None,
            logger_name: str = "pio_tpu_torch") -> JsonLogHandler:
    """Attach ONE JsonLogHandler to the ``pio_tpu_torch`` logger tree
    (idempotent — later calls may upgrade a record-only handler with a
    stream or a worker index, never stack a second handler).

    ``PIO_TPU_LOG_JSON=1`` forces console JSON even when no stream is
    passed (containerized deploys where stdout IS the log shipper).
    """
    global _handler
    with _install_lock:
        if _handler is None:
            if stream is None and knobs.knob_str("PIO_TPU_LOG_JSON") == "1":
                stream = sys.stderr

            ring = LogRing(knobs.knob_int("PIO_TPU_LOG_RING"))
            _handler = JsonLogHandler(ring, stream=stream, worker=worker)
            target = logging.getLogger(logger_name)
            target.addHandler(_handler)
            if target.level == logging.NOTSET and logger_name:
                # the root logger's default WARNING threshold would
                # silence the INFO serving logs the ring exists to hold
                target.setLevel(logging.INFO)
        else:
            if stream is not None:
                _handler.stream = stream
            if worker is not None:
                _handler.worker = worker
        return _handler


def ring() -> LogRing:
    """The installed ring (installing record-only logging on demand)."""
    return install().ring


def set_worker(worker: int) -> None:
    """Stamp subsequent log entries with a pool worker index."""
    install(worker=worker)


def exposition_lines() -> List[str]:
    """``pio_tpu_log_messages_total`` exposition lines — registered as a
    collector by HTTP services so their ``/metrics`` carries log-volume
    counters without sharing a registry."""
    return _LOG_MESSAGES.render()


# pio: endpoint=/logs.json
def logs_payload(n: int = 100, level: Optional[str] = None,
                 trace_id: Optional[str] = None,
                 logger: Optional[str] = None) -> Dict[str, object]:
    """The ``GET /logs.json`` response body."""
    r = ring()
    entries = r.tail(n=n, level=level, trace_id=trace_id, logger=logger)
    return {
        "logs": [_public(e) for e in entries],
        "ringCapacity": r.cap,
        "dropped": r.dropped,
    }


def _reset_for_tests() -> None:
    """Detach the installed handler (test isolation only)."""
    global _handler
    with _install_lock:
        if _handler is not None:
            logging.getLogger("pio_tpu_torch").removeHandler(_handler)
            _handler = None
