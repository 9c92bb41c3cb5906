"""Token-bucket rate limiting + bounded-queue concurrency limiting.

The port's copy of ``pio_tpu/qos/limiter.py`` (the port imports nothing of
``pio_tpu``), its locks plain ``threading`` ones.

A bucket is pool-wide through the observability shared-memory segment
(``obs/shm.py``), single-writer per stripe: each worker keeps a local
bucket refilled at the whole pool's rate, mirrors its admissions into its
stripe through a pool-bound counter cell, and before deciding deducts the
admissions its peers made since it last looked (the pool sum minus what
it already counted). Every worker converges on one bucket level, so
``--workers N`` shares one budget; the race is one in-flight admission a
peer, not N times the rate. Per-key buckets stay a process's own, as in
the reference.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

from pio_tpu_torch.analysis.runtime import make_condition, make_lock
from pio_tpu_torch.obs.metrics import monotonic_s


class TokenBucket:
    """Thread-safe token bucket.

    ``cell`` (optional) is a metrics counter cell mirroring this
    worker's admission count into the pool segment — when bound, the
    bucket deducts every peer worker's admissions too, making the budget
    pool-wide. ``floor`` on :meth:`try_acquire` reserves a fraction of
    the burst for higher-priority classes (see ``policy.PRIORITY_FLOORS``).
    """

    def __init__(self, rate: float, burst: float, cell=None,
                 clock: Callable[[], float] = monotonic_s):
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self._cell = cell
        self._clock = clock
        self._lock = make_lock("qos.bucket")
        self._tokens = self.burst
        self._last = clock()
        #: pool-wide admitted total already deducted from ``_tokens``
        self._seen = self._pool_total()

    def _pool_total(self) -> float:
        return self._cell._pool_value() if self._cell is not None else 0.0

    def rebase(self) -> None:
        """Forget pool history — call right after the cell is bound to
        the shared segment, so admissions that predate this worker (or
        survive in an adopted respawn stripe) don't drain a fresh bucket."""
        with self._lock:
            self._seen = self._pool_total()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now
        pool = self._pool_total()
        if pool > self._seen:  # peers admitted since we last looked
            self._tokens -= pool - self._seen
            self._seen = pool

    def try_acquire(self, cost: float = 1.0,
                    floor: float = 0.0) -> Tuple[bool, float]:
        """``(admitted, retry_after_s)``. Admission requires the bucket
        to keep ``floor * burst`` tokens AFTER paying ``cost``."""
        reserve = floor * self.burst
        with self._lock:
            self._refill_locked()
            if self._tokens - cost >= reserve:
                self._tokens -= cost
                if self._cell is not None:
                    self._cell._add(cost)
                    self._seen += cost  # ours: already deducted above
                return True, 0.0
            need = reserve + cost - self._tokens
            return False, need / self.rate

    def level(self) -> float:
        """Current token count (for ``/qos.json``)."""
        with self._lock:
            self._refill_locked()
            return max(self._tokens, 0.0)


class KeyedBuckets:
    """Lazily-created per-key token buckets (access-key rate limits on
    the event server). Local to the process; bounded: least-recently-hit
    keys are evicted past ``max_keys`` — an evicted hot key merely
    restarts with a full bucket."""

    def __init__(self, rate: float, burst: float, max_keys: int = 4096,
                 clock: Callable[[], float] = monotonic_s):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.max_keys = max_keys
        self._clock = clock
        self._lock = make_lock("qos.keyed_buckets")
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()

    def _bucket(self, key: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = TokenBucket(self.rate, self.burst, clock=self._clock)
                self._buckets[key] = b
                while len(self._buckets) > self.max_keys:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(key)
            return b

    def try_acquire(self, key: str, cost: float = 1.0,
                    floor: float = 0.0) -> Tuple[bool, float]:
        return self._bucket(key).try_acquire(cost, floor)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)


class ConcurrencyLimiter:
    """``max_inflight`` concurrent executions with a bounded admission
    queue of ``max_queue`` waiters behind them; anyone beyond that is
    shed immediately (the whole point — waiting costs a server thread,
    and an unbounded queue is just a slower way to fall over)."""

    #: :meth:`enter` outcomes
    OK, QUEUE_FULL, TIMEOUT = "ok", "queue_full", "timeout"

    def __init__(self, max_inflight: int, max_queue: int = 0,
                 clock: Callable[[], float] = monotonic_s):
        if max_inflight <= 0:
            raise ValueError("max_inflight must be > 0")
        self.max_inflight = int(max_inflight)
        self.max_queue = max(int(max_queue), 0)
        self._clock = clock
        self._cond = make_condition("qos.limiter")
        self._inflight = 0
        self._waiting = 0

    def enter(self, timeout_s: Optional[float] = None) -> str:
        """Take a slot, queueing up to ``timeout_s`` (None ⇒ wait for a
        slot indefinitely). Returns OK / QUEUE_FULL / TIMEOUT."""
        deadline = (
            None if timeout_s is None else self._clock() + timeout_s
        )
        with self._cond:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                return self.OK
            if self._waiting >= self.max_queue:
                return self.QUEUE_FULL
            self._waiting += 1
            try:
                while self._inflight >= self.max_inflight:
                    if deadline is None:
                        self._cond.wait(0.5)
                        continue
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return self.TIMEOUT
                    self._cond.wait(remaining)
                self._inflight += 1
                return self.OK
            finally:
                self._waiting -= 1
                # lost-wakeup guard: exit() notifies ONE waiter. If that
                # notify landed on us and we leave without taking the
                # freed slot (deadline passed → TIMEOUT), or slots remain
                # after we took ours, pass the baton so the capacity is
                # used now instead of idling until another waiter's
                # timeout or poll tick.
                if self._inflight < self.max_inflight and self._waiting > 0:
                    self._cond.notify()

    def exit(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify()

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queued(self) -> int:
        return self._waiting
