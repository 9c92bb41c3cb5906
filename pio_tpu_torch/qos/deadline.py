"""Request deadlines: the ``X-Pio-Deadline-Ms`` header gives the query a

The port's copy of ``pio_tpu/qos/deadline.py`` (the port imports nothing of
``pio_tpu``).
time budget counted from server receipt. A request whose budget elapses
while it sits in the micro-batch queue is shed BEFORE model execution —
the client already gave up; running the scorer for it is pure waste —
and a forming batch never waits past its tightest member's deadline.
"""

from __future__ import annotations

from typing import Callable, Optional

from pio_tpu_torch.obs.metrics import monotonic_s

#: request header carrying the budget, in milliseconds (lowercase — the
#: HTTP layer lowercases header names)
DEADLINE_HEADER = "X-Pio-Deadline-Ms"


class DeadlineExceeded(Exception):
    """A request's budget elapsed before (or while) it could execute."""


def parse_deadline_ms(raw: Optional[str]) -> Optional[float]:
    """Header value → budget in ms. ``None``/empty → None; malformed or
    non-positive raises ``ValueError`` (the server maps it to a 400 — a
    garbled deadline must not silently become "no deadline")."""
    if raw is None or not str(raw).strip():
        return None
    v = float(raw)  # ValueError on garbage propagates
    if v != v or v <= 0:
        raise ValueError(f"deadline must be a positive number of ms: {raw!r}")
    return v


class Deadline:
    """Absolute deadline on the monotonic clock."""

    __slots__ = ("at", "_clock")

    def __init__(self, budget_ms: float,
                 clock: Callable[[], float] = monotonic_s):
        self._clock = clock
        self.at = clock() + budget_ms / 1000.0

    @classmethod
    def from_header(cls, raw: Optional[str],
                    default_ms: Optional[float] = None,
                    clock: Callable[[], float] = monotonic_s
                    ) -> Optional["Deadline"]:
        budget = parse_deadline_ms(raw)
        if budget is None:
            budget = default_ms
        return None if budget is None else cls(budget, clock=clock)

    def remaining_s(self) -> float:
        return self.at - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self.at
