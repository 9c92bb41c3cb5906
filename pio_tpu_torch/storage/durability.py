"""The fsync policy knob: what an acknowledged write means on durable media.

The port's copy of ``pio_tpu/storage/durability.py`` (the port imports
nothing of ``pio_tpu``). One environment variable, ``PIO_TPU_DURABILITY``,
read by every backend that persists bytes:

- ``commit`` — fsync before acking: every event-log group-commit flush
  fsyncs the log, SQLite runs ``synchronous=FULL``, and the blob store
  fsyncs the temp file and its parent directory around ``os.replace``.
  An ack survives power loss.
- ``batch`` (default) — fsync at batch granularity: the event-log leader
  fsyncs when :data:`BATCH_SYNC_INTERVAL_S` has elapsed since the last
  sync of that file, SQLite stays on ``synchronous=NORMAL`` (WAL), and
  the blob store still gets the full durable rename (models are written
  rarely). An ack survives process death always, power loss up to the
  sync interval.
- ``os`` — no explicit fsync anywhere and SQLite ``synchronous=OFF``: the
  kernel's writeback decides. An ack survives process death (the write
  reached the page cache) but not power loss.

The port's ``localfs`` model store always syncs its file and directory.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

from pio_tpu_torch.obs import monotonic_s
from pio_tpu_torch.utils import knobs

ENV_VAR = "PIO_TPU_DURABILITY"
MODES = ("commit", "batch", "os")
DEFAULT = "batch"

#: under ``batch``, the event-log leader fsyncs a file at most this often
BATCH_SYNC_INTERVAL_S = 0.05


def mode() -> str:
    """Effective durability mode; raises ValueError on an unknown value
    (misconfigured durability must be loud — a typo'd mode silently
    running ``os`` would void the ack guarantee the operator asked for)."""
    v = knobs.knob_str(ENV_VAR).lower() or DEFAULT
    if v not in MODES:
        raise ValueError(
            f"{ENV_VAR}={v!r} is not one of {'|'.join(MODES)}"
        )
    return v


def fsync_fileobj(f) -> None:
    """Flush + fsync an open file object unless mode is ``os``."""
    if mode() == "os":
        return
    f.flush()
    os.fsync(f.fileno())


def replace_durable(tmp: str, dst: str) -> None:
    """``os.replace`` + (mode permitting) fsync of the parent directory —
    the rename itself is not durable until the directory entry is. The
    temp file must already be synced (:func:`fsync_fileobj` before
    close); this completes the other half of the durable-rename pair."""
    os.replace(tmp, dst)
    if mode() == "os":
        return
    parent = os.path.dirname(os.path.abspath(dst))
    fd = os.open(parent, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class IntervalSyncer:
    """Per-key sync scheduling for ``batch`` mode: ``due(key)`` answers
    "should this write fsync?" per the current mode, and ``mark(key)``
    records that it did. ``commit`` → always, ``os`` → never, ``batch``
    → once per :data:`BATCH_SYNC_INTERVAL_S` per key."""

    def __init__(self, interval_s: float = BATCH_SYNC_INTERVAL_S):
        self._interval_s = interval_s
        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def due(self, key: str) -> bool:
        m = mode()
        if m == "commit":
            return True
        if m == "os":
            return False
        with self._lock:
            last = self._last.get(key)
        return last is None or monotonic_s() - last >= self._interval_s

    def mark(self, key: str) -> None:
        with self._lock:
            self._last[key] = monotonic_s()
