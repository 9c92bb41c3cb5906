"""Bounded, jittered retries for *transient* storage errors.

The port's copy of ``retrying`` from ``pio_tpu/storage/retry.py`` (the
port imports nothing of ``pio_tpu``), with the reference's defaults as
constants and without the QoS deadline and the retry counter, which come
with the event server's QoS slice. A SQLITE_BUSY under a concurrent
checkpoint is not an outage — retrying it locally turns a would-be 5xx
into a slightly slower 2xx.

Backoff is decorrelated jitter (the AWS-architecture formulation):
``sleep = uniform(base, prev * 3)`` capped — concurrent victims of one
stall don't re-converge into a retry thundering herd.
"""

from __future__ import annotations

import random
import sqlite3
import time
from typing import Callable, TypeVar

from pio_tpu_torch.faults import FaultInjected

T = TypeVar("T")

ATTEMPTS = 3
BASE_S = 0.02
CAP_S = 0.5

#: sqlite3 messages that mean "try again", not "broken": lock/busy states
#: from concurrent writers and WAL checkpoints
_SQLITE_TRANSIENT = ("locked", "busy")


def is_transient(exc: BaseException) -> bool:
    """``sqlite3.OperationalError`` mentioning busy/locked (SQLITE_BUSY /
    SQLITE_LOCKED under WAL contention), and
    :class:`~pio_tpu_torch.faults.FaultInjected`: an injected ``error``
    models exactly that class of failure, so a fault drill exercises the
    retry."""
    if isinstance(exc, FaultInjected):
        return True
    if isinstance(exc, sqlite3.OperationalError):
        msg = str(exc).lower()
        return any(t in msg for t in _SQLITE_TRANSIENT)
    return False


def retrying(fn: Callable[[], T]) -> T:
    """Call ``fn``, retrying transient failures up to ATTEMPTS total tries.
    Non-transient errors propagate immediately; so does the last transient
    one once the attempts run out."""
    sleep_s = BASE_S
    for attempt in range(1, ATTEMPTS + 1):
        try:
            return fn()
        except Exception as exc:
            if attempt >= ATTEMPTS or not is_transient(exc):
                raise
            sleep_s = min(CAP_S, random.uniform(BASE_S, sleep_s * 3))
            time.sleep(sleep_s)
    raise AssertionError("unreachable")  # loop returns or raises
