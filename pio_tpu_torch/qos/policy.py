"""QoS policy: priority classes + the ``rps=500,queue=64,deadline=100ms``

The port's copy of ``pio_tpu/qos/policy.py`` (the port imports nothing of
``pio_tpu``).
spec grammar shared by ``pio deploy --qos``, the ``PIO_TPU_QOS``
environment variable, and the ``engine.json`` ``qos`` block.

Precedence (highest wins): explicit spec (CLI flag / constructor arg) >
``PIO_TPU_QOS`` > ``engine.json``. No source at all means QoS is OFF —
the servers behave exactly as before this subsystem existed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

from pio_tpu_torch.obs.slo import parse_duration_s
from pio_tpu_torch.utils import knobs


class QoSError(ValueError):
    pass


#: Priority classes, most- to least-important. Lower classes see a HIGHER
#: token-bucket floor: a ``shadow`` request is only admitted while the
#: bucket still holds >50% of its burst, ``batchpredict`` >25%, so under
#: pressure the background traffic is shed first and ``interactive``
#: queries keep the whole remaining budget.
PRIORITY_CLASSES = ("interactive", "batchpredict", "shadow")
PRIORITY_FLOORS: Dict[str, float] = {
    "interactive": 0.0,
    "batchpredict": 0.25,
    "shadow": 0.5,
}

#: Request header naming the priority class (unknown/absent ⇒ interactive).
PRIORITY_HEADER = "X-Pio-Priority"


def priority_floor(name: Optional[str]) -> float:
    """Bucket floor (fraction of burst that must remain) for a priority
    class name; unknown names are treated as ``interactive`` — a typo'd
    header must not silently deprioritize a user query."""
    return PRIORITY_FLOORS.get((name or "interactive").strip().lower(), 0.0)


@dataclasses.dataclass(frozen=True)
class QoSPolicy:
    """Parsed admission-control policy. Every knob is optional; an unset
    knob disables that mechanism (``rps=None`` ⇒ no rate limit, …)."""

    #: engine-wide admission rate (requests/second) + bucket depth
    rps: Optional[float] = None
    burst: Optional[float] = None
    #: per-access-key rate (event-server ingest) + bucket depth
    key_rps: Optional[float] = None
    key_burst: Optional[float] = None
    #: concurrency cap + bounded admission-queue depth behind it
    inflight: Optional[int] = None
    queue: Optional[int] = None
    #: default per-request deadline (ms) when the client sends none
    deadline_ms: Optional[float] = None
    #: stale-response LRU entries (0 ⇒ degradation disabled)
    cache: int = 0
    #: circuit breaker: trip when ≥ ``fail_rate`` of the last
    #: ``fail_window`` calls failed (given ≥ ``fail_window`` samples);
    #: stay open ``cooldown`` seconds; close after ``probes`` successes
    fail_rate: float = 0.5
    fail_window: int = 20
    cooldown_s: float = 5.0
    probes: int = 3

    def effective_burst(self) -> float:
        """Bucket depth: explicit ``burst=`` or one second of ``rps``."""
        if self.burst is not None:
            return self.burst
        return max(self.rps or 0.0, 1.0)

    def effective_key_burst(self) -> float:
        if self.key_burst is not None:
            return self.key_burst
        return max(self.key_rps or 0.0, 1.0)

    # pio: endpoint=/qos.json
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["priorities"] = dict(PRIORITY_FLOORS)
        return d


_FLOAT_KEYS = {"rps", "burst", "key_rps", "key_burst", "fail_rate"}
_INT_KEYS = {"inflight", "queue", "cache", "fail_window", "probes"}
_DURATION_KEYS = {"deadline": "deadline_ms", "cooldown": "cooldown_s"}


def parse_qos(spec: str) -> QoSPolicy:
    """Parse ``rps=500,queue=64,deadline=100ms`` into a policy.

    Keys: ``rps burst key_rps key_burst inflight queue deadline cache
    fail_rate fail_window probes cooldown``. Durations take the SLO
    suffixes (``us ms s m h d``); everything else is a plain number.
    """
    kw: Dict[str, Any] = {}
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        key, sep, raw = item.partition("=")
        key, raw = key.strip().lower(), raw.strip()
        if not sep or not raw:
            raise QoSError(f"qos spec item {item!r} is not key=value")
        try:
            if key in _FLOAT_KEYS:
                kw[key] = float(raw)
                if kw[key] < 0:
                    raise ValueError("negative")
            elif key in _INT_KEYS:
                kw[key] = int(raw)
                if kw[key] < 0:
                    raise ValueError("negative")
            elif key in _DURATION_KEYS:
                v = parse_duration_s(raw)
                kw[_DURATION_KEYS[key]] = (
                    v * 1000.0 if key == "deadline" else v
                )
            else:
                raise QoSError(
                    f"unknown qos key {key!r} (expected one of: "
                    f"{', '.join(sorted(_FLOAT_KEYS | _INT_KEYS | set(_DURATION_KEYS)))})"
                )
        except QoSError:
            raise
        except (TypeError, ValueError) as e:
            raise QoSError(f"bad qos value {item!r}: {e}") from None
    if kw.get("fail_rate") is not None and kw["fail_rate"] > 1.0:
        raise QoSError("fail_rate is a fraction in [0, 1]")
    return QoSPolicy(**kw)


def policy_from_dict(d: Dict[str, Any]) -> QoSPolicy:
    """An ``engine.json`` ``qos`` block: either ``{"spec": "rps=..."}`` or
    the policy fields spelled out as JSON keys."""
    if "spec" in d:
        return parse_qos(d["spec"])
    allowed = {f.name for f in dataclasses.fields(QoSPolicy)}
    unknown = set(d) - allowed
    if unknown:
        raise QoSError(f"unknown qos keys in engine.json: {sorted(unknown)}")
    try:
        return QoSPolicy(**d)
    except TypeError as e:
        raise QoSError(f"bad engine.json qos block: {e}") from None


def resolve_policy(
    spec: Union[None, str, QoSPolicy],
    variant: Optional[Dict[str, Any]] = None,
) -> Optional[QoSPolicy]:
    """Resolve the effective policy: explicit spec > ``PIO_TPU_QOS`` >
    ``engine.json`` ``qos`` block > None (QoS off)."""
    if isinstance(spec, QoSPolicy):
        return spec
    if spec:
        return parse_qos(spec)
    env = knobs.knob_str("PIO_TPU_QOS")
    if env:
        return parse_qos(env)
    block = (variant or {}).get("qos")
    if isinstance(block, str):
        return parse_qos(block)
    if isinstance(block, dict):
        return policy_from_dict(block)
    return None
