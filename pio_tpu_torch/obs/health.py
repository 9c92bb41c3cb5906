"""Deep health and readiness probes.

The port's copy of ``pio_tpu/obs/health.py``. Two questions, as in the
Kubernetes probe model:

- **liveness** (``GET /healthz``): is this process still making
  progress (supervision-loop heartbeat fresh, critical background
  threads such as the micro-batch dispatcher and the lane drainer
  alive). A 503 here means restart me; the serving pool's supervisor
  probes it.
- **readiness** (``GET /readyz``): can this process serve correctly
  right now (engine deployed and models loaded, storage reachable). A
  503 here means take me out of rotation.

:class:`HealthMonitor` is a named-check registry; each check is a
zero-arg callable returning truthy/falsy, ``(ok, detail)``, or raising
(a raise is a failure carrying the exception text). Both probes return
the full per-check report.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from pio_tpu_torch.obs.metrics import monotonic_s


class Heartbeat:
    """Freshness probe for a supervision/event loop: the loop calls
    :meth:`beat` each iteration; :meth:`check` fails once the last beat
    is older than ``max_age_s`` — catching a loop that is WEDGED (stuck
    in a call, deadlocked) even though its thread object is alive."""

    def __init__(self, max_age_s: float = 30.0):
        self.max_age_s = float(max_age_s)
        self._last = monotonic_s()

    def beat(self) -> None:
        self._last = monotonic_s()

    def age_s(self) -> float:
        return monotonic_s() - self._last

    def check(self) -> Tuple[bool, str]:
        age = self.age_s()
        return age <= self.max_age_s, f"last beat {age:.1f}s ago"


def thread_alive(thread_getter: Callable[[], Optional[threading.Thread]]
                 ) -> Callable[[], Tuple[bool, str]]:
    """Liveness check over a critical background thread. Takes a getter
    (not the thread) because restarts/reloads may swap the object."""

    def check() -> Tuple[bool, str]:
        t = thread_getter()
        if t is None:
            return True, "not running (disabled)"
        if t.is_alive():
            return True, f"alive ({t.name})"
        return False, f"thread {t.name!r} is dead"

    return check


def _run_check(fn: Callable) -> Tuple[bool, str]:
    try:
        out = fn()
    except Exception as e:  # a failing dependency flips the probe
        return False, f"{type(e).__name__}: {e}"
    if isinstance(out, tuple):
        ok, detail = out
        return bool(ok), str(detail)
    return bool(out) if out is not None else True, ""


class HealthMonitor:
    """Named liveness + readiness check registry for one service."""

    def __init__(self):
        self._lock = threading.Lock()
        self._liveness: List[Tuple[str, Callable]] = []
        self._readiness: List[Tuple[str, Callable]] = []

    # -- registration ------------------------------------------------------
    def add_liveness(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._liveness.append((name, fn))

    def add_readiness(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._readiness.append((name, fn))

    def add_critical_thread(
        self, name: str,
        thread_getter: Callable[[], Optional[threading.Thread]],
    ) -> None:
        """A background thread whose death means the process can no
        longer make progress (→ liveness failure → restart)."""
        self.add_liveness(name, thread_alive(thread_getter))

    # -- evaluation --------------------------------------------------------
    def _evaluate(self, checks) -> Tuple[bool, Dict[str, dict]]:
        report: Dict[str, dict] = {}
        ok = True
        for name, fn in checks:
            c_ok, detail = _run_check(fn)
            report[name] = {"ok": c_ok}
            if detail:
                report[name]["detail"] = detail
            ok = ok and c_ok
        return ok, report

    def liveness(self) -> Tuple[bool, dict]:
        with self._lock:
            checks = list(self._liveness)
        ok, report = self._evaluate(checks)
        return ok, {"status": "ok" if ok else "unhealthy", "checks": report}

    def readiness(self) -> Tuple[bool, dict]:
        with self._lock:
            checks = list(self._readiness)
        ok, report = self._evaluate(checks)
        return ok, {"status": "ready" if ok else "not ready",
                    "checks": report}
