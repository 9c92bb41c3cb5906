"""Admission control & QoS: pool-wide rate limiting, deadline-aware

The port's copy of ``pio_tpu/qos/__init__.py`` (the port imports nothing of
``pio_tpu``).
shedding, circuit breaking, and graceful degradation.

The SLO engine (``obs/slo.py``) *observes* an overload; this package
*acts* on one.
The pieces, in request order:

- :mod:`policy` — priority classes + the ``rps=500,queue=64,deadline=100ms``
  spec grammar (``pio deploy --qos`` / ``PIO_TPU_QOS`` / engine.json
  ``qos`` block);
- :mod:`limiter` — token buckets (per engine, per access key; one
  process's, as the port has no shared metrics segment) and a
  concurrency limiter with a bounded admission queue;
- :mod:`deadline` — ``X-Pio-Deadline-Ms`` propagation into the
  micro-batcher, shedding expired-in-queue work before execution;
- :mod:`breaker` — closed/open/half-open circuit breakers around storage
  and scorer calls;
- :mod:`degrade` — a bounded LRU serving explicitly-marked stale
  responses (``X-Pio-Degraded: stale-cache``) instead of hard 503s;
- :mod:`gate` — the per-service composition + metrics
  (``pio_tpu_qos_shed_total{reason}``, inflight/queue gauges, breaker
  state) surfaced on ``GET /qos.json``.
"""

from pio_tpu_torch.qos.breaker import BreakerCall, CircuitBreaker
from pio_tpu_torch.qos.deadline import (
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceeded,
    parse_deadline_ms,
)
from pio_tpu_torch.qos.degrade import (
    DEGRADED_HEADER,
    DEGRADED_VALUE,
    StaleCache,
    cache_key,
)
from pio_tpu_torch.qos.gate import (
    Admission,
    QoSGate,
    SHED_REASONS,
    qos_payload,
    retry_after_header,
)
from pio_tpu_torch.qos.limiter import (
    ConcurrencyLimiter,
    KeyedBuckets,
    TokenBucket,
)
from pio_tpu_torch.qos.policy import (
    PRIORITY_CLASSES,
    PRIORITY_FLOORS,
    PRIORITY_HEADER,
    QoSError,
    QoSPolicy,
    parse_qos,
    policy_from_dict,
    priority_floor,
    resolve_policy,
)

__all__ = [
    "Admission",
    "BreakerCall",
    "CircuitBreaker",
    "ConcurrencyLimiter",
    "DEADLINE_HEADER",
    "DEGRADED_HEADER",
    "DEGRADED_VALUE",
    "Deadline",
    "DeadlineExceeded",
    "KeyedBuckets",
    "PRIORITY_CLASSES",
    "PRIORITY_FLOORS",
    "PRIORITY_HEADER",
    "QoSError",
    "QoSGate",
    "QoSPolicy",
    "SHED_REASONS",
    "StaleCache",
    "TokenBucket",
    "cache_key",
    "parse_deadline_ms",
    "parse_qos",
    "policy_from_dict",
    "priority_floor",
    "qos_payload",
    "resolve_policy",
    "retry_after_header",
]
