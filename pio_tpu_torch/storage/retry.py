"""Bounded, jittered retries for *transient* storage errors.

The port's copy of ``pio_tpu/storage/retry.py`` (the port imports nothing
of ``pio_tpu``).

The event server's circuit breaker decides when to stop calling a sick
store; this layer decides what to do about the errors that precede
that verdict. A SQLITE_BUSY under a concurrent checkpoint or a blob
server mid-restart is not an outage — retrying it locally converts a
would-be 5xx into a slightly slower 2xx. The wrapper sits INSIDE the
breaker (``_guarded_insert`` wraps the retried call), so the breaker
scores the final outcome: a request saved by retry is a success, a
request that exhausted retries is one failure, not ``attempts`` of them.

Backoff is decorrelated jitter (the AWS-architecture formulation):
``sleep = uniform(base, prev * 3)`` capped — concurrent victims of one
stall don't re-converge into a retry thundering herd. The loop is
deadline-aware via the QoS clock: it never sleeps past ``deadline``,
re-raising the last error instead of burning budget no response can use.
"""

from __future__ import annotations

import random
import sqlite3
import time
from typing import Callable, Optional, TypeVar

from pio_tpu_torch.obs.metrics import REGISTRY
from pio_tpu_torch.qos.deadline import Deadline

T = TypeVar("T")

#: the reference's defaults: tries in all, first and largest sleep
ATTEMPTS = 3
BASE_S = 0.02
CAP_S = 0.5

_RETRIES = REGISTRY.counter(
    "pio_tpu_storage_retries_total",
    "Transient storage errors retried by the retrying() wrapper",
    ("site",),
)

#: sqlite3 messages that mean "try again", not "broken": lock/busy states
#: from concurrent writers and WAL checkpoints
_SQLITE_TRANSIENT = ("locked", "busy")


def is_transient(exc: BaseException) -> bool:
    """Default transience classifier.

    - ``sqlite3.OperationalError`` mentioning busy/locked (SQLITE_BUSY /
      SQLITE_LOCKED under WAL contention);
    - :class:`StorageError` for an unreachable blob server (connection
      refused/reset while it restarts);
    - :class:`FaultInjected` — injected ``error`` actions model exactly
      this class of failure, so chaos specs exercise this code path.
    """
    from pio_tpu_torch.faults import FaultInjected
    from pio_tpu_torch.storage.base import StorageError

    if isinstance(exc, FaultInjected):
        return True
    if isinstance(exc, sqlite3.OperationalError):
        msg = str(exc).lower()
        return any(t in msg for t in _SQLITE_TRANSIENT)
    if isinstance(exc, StorageError):
        return "unreachable" in str(exc).lower()
    return False


def retrying(
    fn: Callable[[], T],
    *,
    site: str = "storage",
    attempts: int = ATTEMPTS,
    base_s: float = BASE_S,
    cap_s: float = CAP_S,
    deadline: Optional[Deadline] = None,
    classify: Callable[[BaseException], bool] = is_transient,
) -> T:
    """Call ``fn``, retrying transient failures up to ``attempts`` total
    tries. Non-transient errors propagate immediately; so does the last
    transient one once attempts or the deadline run out.
    """
    sleep_s = base_s
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except BaseException as exc:
            if attempt >= attempts or not classify(exc):
                raise
            if deadline is not None and deadline.expired():
                raise
            sleep_s = min(cap_s, random.uniform(base_s, sleep_s * 3))
            if deadline is not None:
                remaining = deadline.remaining_s()
                if remaining <= sleep_s:
                    # a sleep that outlives the deadline retries for a
                    # client that already gave up — fail now instead
                    raise
            _RETRIES.inc(site=site)
            time.sleep(sleep_s)
    raise AssertionError("unreachable")  # loop returns or raises
