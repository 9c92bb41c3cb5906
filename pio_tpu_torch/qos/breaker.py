"""Circuit breaker (closed → open → half-open) with failure-RATE

The port's copy of ``pio_tpu/qos/breaker.py`` (the port imports nothing of
``pio_tpu``), its locks plain ``threading`` ones.
tripping over a bounded outcome window.

Guards the two dependencies a serving request leans on — storage reads
and scorer calls. A dependency that is failing for everyone should fail
FAST for everyone: tripping converts a pile-up of slow errors into
immediate sheds (which the degradation layer may turn into stale
answers), and the half-open probe trickle discovers recovery without a
thundering herd.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from pio_tpu_torch.analysis.runtime import make_lock
from pio_tpu_torch.obs.metrics import monotonic_s

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

#: numeric state for the ``pio_tpu_qos_breaker_state`` gauge
STATE_CODES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class BreakerCall:
    """One guarded call, handed out by :meth:`CircuitBreaker.acquire`.

    Exactly one of :meth:`success` / :meth:`failure` after the call;
    :meth:`cancel` in a ``finally`` releases an ABANDONED grant (a path
    that never reached the dependency — parse errors, deadline sheds)
    without recording an outcome. All three are idempotent-once, so
    ``cancel`` after ``success``/``failure`` is a no-op and the finally
    can run it unconditionally — a half-open probe grant can therefore
    never leak, whatever exit the handler takes.

    The call is tagged with the breaker generation at grant time; an
    outcome recorded after the breaker changed state (a straggler
    admitted under the previous CLOSED epoch finishing in HALF_OPEN) is
    dropped instead of polluting the new state's probe accounting.
    """

    __slots__ = ("allowed", "retry_after_s", "_breaker", "_gen", "_probe",
                 "_done")

    def __init__(self, breaker: "CircuitBreaker", allowed: bool,
                 retry_after_s: float, gen: int, probe: bool):
        self.allowed = allowed
        self.retry_after_s = retry_after_s
        self._breaker = breaker
        self._gen = gen
        self._probe = probe
        self._done = not allowed  # a refused call has nothing to record

    def success(self) -> None:
        self._finish(failed=False)

    def failure(self) -> None:
        self._finish(failed=True)

    def cancel(self) -> None:
        """Release the grant without an outcome (call abandoned before
        it touched the dependency). No-op after success/failure."""
        self._finish(failed=False, abandoned=True)

    def _finish(self, failed: bool, abandoned: bool = False) -> None:
        if self._done:
            return
        self._done = True
        self._breaker._record(self._gen, self._probe, failed, abandoned)


class CircuitBreaker:
    """:meth:`acquire` before the call, then exactly one of
    ``success()`` / ``failure()`` on the returned :class:`BreakerCall`
    (with ``cancel()`` in a finally for abandoned paths). The legacy
    ``allow()`` / ``record_success()`` / ``record_failure()`` trio is
    kept for simple bracketed callers.

    - CLOSED: everything passes; the last ``window`` outcomes are kept,
      and once ≥ ``window`` samples show a failure fraction ≥
      ``failure_rate`` the breaker opens.
    - OPEN: every call is refused (with the cooldown remaining as a
      Retry-After hint) until ``cooldown_s`` elapses, then HALF_OPEN.
    - HALF_OPEN: up to ``probes`` calls pass; any probe failure reopens,
      ``probes`` probe successes close and clear the window. Outcomes
      from calls granted under an earlier state (generation mismatch)
      are ignored — stragglers can neither close nor reopen it.
    """

    def __init__(self, failure_rate: float = 0.5, window: int = 20,
                 cooldown_s: float = 5.0, probes: int = 3,
                 clock: Callable[[], float] = monotonic_s,
                 on_state_change: Optional[Callable[[str], None]] = None):
        if not 0.0 < failure_rate <= 1.0:
            raise ValueError("failure_rate must be in (0, 1]")
        self.failure_rate = failure_rate
        self.window = max(int(window), 1)
        self.cooldown_s = cooldown_s
        self.probes = max(int(probes), 1)
        self._clock = clock
        self._on_change = on_state_change
        self._lock = make_lock("qos.breaker")
        self._state = CLOSED
        self._outcomes = []  # bounded ring of bools (True = failure)
        self._opened_at = 0.0
        self._probe_inflight = 0
        self._probe_successes = 0
        #: bumped on every state change; outcomes carry the generation
        #: they were granted under and stale ones are dropped
        self._gen = 0

    # -- state -------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _transition_locked(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        self._gen += 1
        if state == OPEN:
            self._opened_at = self._clock()
        if state in (OPEN, HALF_OPEN):
            self._probe_inflight = 0
            self._probe_successes = 0
        if state == CLOSED:
            self._outcomes.clear()
        if self._on_change is not None:
            try:
                self._on_change(state)
            except Exception:
                pass  # a metrics/log hook must never wedge the breaker

    def _maybe_half_open_locked(self) -> None:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            self._transition_locked(HALF_OPEN)

    # -- call protocol -----------------------------------------------------
    def acquire(self) -> BreakerCall:
        """Grant or refuse one call; the returned handle carries the
        Retry-After hint when refused and records the outcome (or
        releases an abandoned grant) when allowed."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return BreakerCall(self, True, 0.0, self._gen, False)
            if self._state == OPEN:
                retry = max(
                    self.cooldown_s - (self._clock() - self._opened_at), 0.0
                )
                return BreakerCall(self, False, retry, self._gen, False)
            # HALF_OPEN: a bounded probe trickle
            if self._probe_inflight < self.probes:
                self._probe_inflight += 1
                return BreakerCall(self, True, 0.0, self._gen, True)
            return BreakerCall(self, False, 0.0, self._gen, False)

    def allow(self) -> Tuple[bool, float]:
        """Legacy ``(allowed, retry_after_s)`` — retry_after is the
        cooldown remaining when refused (0 when refused only by probe
        contention). Prefer :meth:`acquire`, whose handle cannot leak a
        probe grant and ignores cross-state stragglers."""
        call = self.acquire()
        return call.allowed, call.retry_after_s

    def record_success(self) -> None:
        with self._lock:
            self._record_locked(
                self._gen, self._state == HALF_OPEN, failed=False,
                abandoned=False,
            )

    def record_failure(self) -> None:
        with self._lock:
            self._record_locked(
                self._gen, self._state == HALF_OPEN, failed=True,
                abandoned=False,
            )

    def _record(self, gen: int, probe: bool, failed: bool,
                abandoned: bool) -> None:
        with self._lock:
            self._record_locked(gen, probe, failed, abandoned)

    def _record_locked(self, gen: int, probe: bool, failed: bool,
                       abandoned: bool) -> None:
        if gen != self._gen:
            # granted under a previous state: its probe/window counters
            # were reset at the transition, so there is nothing to
            # release and counting the outcome would let stragglers
            # close (or reopen) a breaker no real probe has touched
            return
        if self._state == HALF_OPEN:
            if not probe:
                return  # pre-half-open straggler (legacy untagged only)
            self._probe_inflight = max(self._probe_inflight - 1, 0)
            if abandoned:
                return  # grant released, no outcome to count
            if failed:
                # the dependency is still sick — restart the cooldown
                self._transition_locked(OPEN)
                return
            self._probe_successes += 1
            if self._probe_successes >= self.probes:
                self._transition_locked(CLOSED)
            return
        if abandoned or self._state == OPEN:
            return
        self._record_outcome_locked(failed)
        if failed:
            n = len(self._outcomes)
            if n >= self.window:
                fails = sum(1 for f in self._outcomes if f)
                if fails / n >= self.failure_rate:
                    self._transition_locked(OPEN)

    def _record_outcome_locked(self, failed: bool) -> None:
        self._outcomes.append(failed)
        if len(self._outcomes) > self.window:
            del self._outcomes[0]

    # pio: endpoint=/qos.json
    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open_locked()
            n = len(self._outcomes)
            return {
                "state": self._state,
                "windowSamples": n,
                "windowFailures": sum(1 for f in self._outcomes if f),
                "cooldownRemainingS": (
                    max(self.cooldown_s
                        - (self._clock() - self._opened_at), 0.0)
                    if self._state == OPEN else 0.0
                ),
            }
