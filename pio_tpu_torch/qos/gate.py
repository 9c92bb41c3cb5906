"""``QoSGate`` — the per-service composition of policy, limiters,

The port's copy of ``pio_tpu/qos/gate.py`` (the port imports nothing of
``pio_tpu``), its locks plain ``threading`` ones.
breakers, and the stale cache, with its metrics pre-registered so pool
workers bind them into the shared segment.

Both servers build one gate in ``__init__`` (BEFORE any pool binding —
slot assignment is by registration order) and consult it at the top of
every request handler. Shed decisions return an :class:`Admission` the
handler turns into a 429/503 + ``Retry-After`` or a stale-cache serve.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from pio_tpu_torch.analysis.runtime import make_lock
from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.qos.breaker import STATE_CODES, CircuitBreaker
from pio_tpu_torch.qos.degrade import StaleCache
from pio_tpu_torch.qos.limiter import (
    ConcurrencyLimiter,
    KeyedBuckets,
    TokenBucket,
)
from pio_tpu_torch.qos.policy import QoSPolicy, priority_floor

#: every shed reason, pre-created so the counter cells exist at
#: pool-bind time (cells created later would stay local-only)
SHED_REASONS = (
    "rate_limit", "key_rate_limit", "queue_full", "queue_timeout",
    "deadline", "breaker",
)


class Admission:
    """Outcome of :meth:`QoSGate.admit`. When ``ok``, call
    :meth:`release` exactly once after the request finishes; when shed,
    ``reason`` names the cause and ``retry_after_s`` hints the client."""

    __slots__ = ("ok", "reason", "retry_after_s", "_gate", "_released",
                 "queue_wait_s")

    def __init__(self, ok: bool, reason: Optional[str] = None,
                 retry_after_s: float = 0.0, gate: "QoSGate" = None,
                 queue_wait_s: float = 0.0):
        self.ok = ok
        self.reason = reason
        self.retry_after_s = retry_after_s
        self._gate = gate
        self._released = False
        #: seconds spent blocked in the concurrency limiter's admission
        #: queue — the server turns this into an ``admit.queue`` span
        self.queue_wait_s = queue_wait_s

    def release(self) -> None:
        if self.ok and not self._released and self._gate is not None:
            self._released = True
            self._gate._release()

    def retry_after_header(self) -> Dict[str, str]:
        return retry_after_header(self.retry_after_s)


def retry_after_header(retry_after_s: float) -> Dict[str, str]:
    """``Retry-After`` is delta-seconds, integral, minimum 1 — a 0 would
    invite an instant retry storm from well-behaved clients."""
    return {"Retry-After": str(max(int(math.ceil(retry_after_s)), 1))}


class QoSGate:
    def __init__(self, policy: QoSPolicy, registry, scope: str,
                 clock=None):
        self.policy = policy
        self.scope = scope
        self._clock = clock or monotonic_s

        # -- metrics (pre-created: pool binding is by registration order)
        self.shed_total = registry.counter(
            "pio_tpu_qos_shed_total",
            "Requests rejected by admission control, by reason",
            labelnames=("scope", "reason"),
        )
        for reason in SHED_REASONS:
            self.shed_total.labels(scope, reason)
        self.degraded_total = registry.counter(
            "pio_tpu_qos_degraded_total",
            "Requests answered from the stale cache instead of shed",
            labelnames=("scope",),
        )
        self.degraded_total.labels(scope)
        admitted = registry.counter(
            "pio_tpu_qos_admitted_total",
            "Requests admitted past the engine token bucket "
            "(each worker's stripe carries its own admissions; the "
            "pool-wide sum is the shared budget's consumption)",
            labelnames=("scope",),
        )
        self._admitted_cell = admitted.labels(scope)
        self.inflight_gauge = registry.gauge(
            "pio_tpu_qos_inflight",
            "Requests currently executing past admission (this worker)",
            labelnames=("scope",),
        )
        self.queue_gauge = registry.gauge(
            "pio_tpu_qos_queue_depth",
            "Requests waiting in the bounded admission queue (this worker)",
            labelnames=("scope",),
        )
        self.inflight_gauge.set(0, scope=scope)
        self.queue_gauge.set(0, scope=scope)
        self.breaker_state_gauge = registry.gauge(
            "pio_tpu_qos_breaker_state",
            "Circuit breaker state (0=closed, 1=open, 2=half_open)",
            labelnames=("scope", "dependency"),
        )

        # -- mechanisms (each enabled only when its knob is set)
        self.bucket: Optional[TokenBucket] = None
        if policy.rps:
            self.bucket = TokenBucket(
                policy.rps, policy.effective_burst(),
                cell=self._admitted_cell, clock=self._clock,
            )
        self.key_buckets: Optional[KeyedBuckets] = None
        if policy.key_rps:
            self.key_buckets = KeyedBuckets(
                policy.key_rps, policy.effective_key_burst(),
                clock=self._clock,
            )
        self.limiter: Optional[ConcurrencyLimiter] = None
        if policy.inflight:
            self.limiter = ConcurrencyLimiter(
                policy.inflight, policy.queue or 0, clock=self._clock,
            )
        self.stale: Optional[StaleCache] = None
        if policy.cache:
            self.stale = StaleCache(policy.cache)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._breaker_lock = make_lock("qos.gate.breakers")

    # -- pool --------------------------------------------------------------
    def on_pool_bound(self) -> None:
        """Call right after ``registry.bind_pool_segment`` so the bucket
        doesn't treat pre-existing stripe totals as fresh admissions."""
        if self.bucket is not None:
            self.bucket.rebase()

    # -- breakers ----------------------------------------------------------
    def breaker(self, dependency: str) -> CircuitBreaker:
        """The named breaker (created on first use, watched by a state
        gauge)."""
        with self._breaker_lock:
            b = self._breakers.get(dependency)
            if b is None:
                gauge, scope = self.breaker_state_gauge, self.scope

                def on_change(state, _dep=dependency):
                    gauge.set(
                        STATE_CODES[state], scope=scope, dependency=_dep
                    )

                b = CircuitBreaker(
                    failure_rate=self.policy.fail_rate,
                    window=self.policy.fail_window,
                    cooldown_s=self.policy.cooldown_s,
                    probes=self.policy.probes,
                    clock=self._clock,
                    on_state_change=on_change,
                )
                gauge.set(0.0, scope=scope, dependency=dependency)
                self._breakers[dependency] = b
            return b

    # -- admission ---------------------------------------------------------
    def admit(self, priority: Optional[str] = None,
              key: Optional[str] = None,
              timeout_s: Optional[float] = None) -> Admission:
        """Run the cheap checks in shedding order: engine bucket, per-key
        bucket, then the concurrency gate (the only one that queues).
        ``timeout_s`` bounds the queue wait (a deadline's remaining
        budget); sheds are NOT counted here — the caller counts them via
        :meth:`count_shed` once it knows whether the stale cache saved
        the request."""
        floor = priority_floor(priority)
        if self.bucket is not None:
            ok, retry = self.bucket.try_acquire(floor=floor)
            if not ok:
                return Admission(False, "rate_limit", retry, self)
        if self.key_buckets is not None and key:
            ok, retry = self.key_buckets.try_acquire(key, floor=floor)
            if not ok:
                return Admission(False, "key_rate_limit", retry, self)
        queue_wait_s = 0.0
        if self.limiter is not None:
            self.queue_gauge.set(
                self.limiter.queued + 1, scope=self.scope
            )
            t_enter = self._clock()
            outcome = self.limiter.enter(timeout_s)
            queue_wait_s = self._clock() - t_enter
            self.queue_gauge.set(self.limiter.queued, scope=self.scope)
            if outcome != ConcurrencyLimiter.OK:
                reason = (
                    "queue_full"
                    if outcome == ConcurrencyLimiter.QUEUE_FULL
                    else "queue_timeout"
                )
                # a full queue drains at roughly max_inflight per
                # service time; 1s is an honest coarse hint
                return Admission(False, reason, 1.0, self,
                                 queue_wait_s=queue_wait_s)
            self.inflight_gauge.set(self.limiter.inflight, scope=self.scope)
        return Admission(True, gate=self, queue_wait_s=queue_wait_s)

    def _release(self) -> None:
        if self.limiter is not None:
            self.limiter.exit()
            self.inflight_gauge.set(self.limiter.inflight, scope=self.scope)
            self.queue_gauge.set(self.limiter.queued, scope=self.scope)

    # -- accounting --------------------------------------------------------
    def count_shed(self, reason: str) -> None:
        self.shed_total.inc(scope=self.scope, reason=reason)

    def count_degraded(self) -> None:
        self.degraded_total.inc(scope=self.scope)

    # -- /qos.json ---------------------------------------------------------
    # pio: endpoint=/qos.json
    def snapshot(self) -> dict:
        out = {
            "enabled": True,
            "scope": self.scope,
            "policy": self.policy.to_dict(),
            "shed": {
                reason: self.shed_total.value(self.scope, reason)
                for reason in SHED_REASONS
            },
            "degraded": self.degraded_total.value(self.scope),
            "admitted": self._admitted_cell._pool_value(),
            "breakers": {
                dep: b.snapshot() for dep, b in self._breakers.items()
            },
        }
        if self.bucket is not None:
            out["bucket"] = {
                "rate": self.bucket.rate,
                "burst": self.bucket.burst,
                "tokens": round(self.bucket.level(), 3),
            }
        if self.key_buckets is not None:
            out["keyBuckets"] = {
                "rate": self.key_buckets.rate,
                "burst": self.key_buckets.burst,
                "keys": len(self.key_buckets),
            }
        if self.limiter is not None:
            out["concurrency"] = {
                "maxInflight": self.limiter.max_inflight,
                "maxQueue": self.limiter.max_queue,
                "inflight": self.limiter.inflight,
                "queued": self.limiter.queued,
            }
        if self.stale is not None:
            out["staleCache"] = self.stale.stats()
        return out


def qos_payload(gate: Optional[QoSGate]) -> dict:
    """The ``GET /qos.json`` body of a server (``enabled`` false without a
    gate)."""
    return {"enabled": False} if gate is None else gate.snapshot()
