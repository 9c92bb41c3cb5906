"""The failpoint registry: spec grammar, matching, actions, counters.

The port's copy of ``pio_tpu/faults/registry.py`` (the port imports
nothing of ``pio_tpu``), with the duration parser of the reference's
``obs/slo.py`` inlined. Same grammar, actions, modifiers, errors, counters
and ``/faults.json`` payload.

Design constraints, in priority order:

1. **Inert means free.** With no spec installed, :func:`failpoint` must
   cost one dict lookup on the serving hot path. So the disarmed fast path is a
   single ``dict.get`` against an empty resolution cache — no locks, no
   string formatting, no allocation.
2. **Fail loudly on bad specs.** The grammar errors (:class:`FaultError`,
   a ``ValueError`` like ``QoSError``) are raised at parse time —
   ``pio deploy --faults`` validates before exporting the env var, so a
   typo'd action name never ships to spawned workers as a silent no-op.
3. **Deterministic bookkeeping.** Every trigger is counted under a lock
   BEFORE the action runs: a ``crash`` that kills the process mid-flush
   still leaves the count observable in the parent's assertions via the
   pre-crash stderr line.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import random
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from pio_tpu_torch.utils import knobs

#: spawned workers / subprocesses inherit the armed spec through this
ENV_VAR = "PIO_TPU_FAULTS"

_ACTIONS = ("error", "latency", "torn-write", "crash")

#: the duration suffixes of ``latency:<duration>`` (the SLO grammar's)
_DUR_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
              "h": 3600.0, "d": 86400.0}


def parse_duration_s(text: str) -> float:
    """``50ms`` → 0.05: a number with one of the suffixes
    ``us ms s m h d``."""
    m = re.match(r"^([0-9.]+)(us|ms|s|m|h|d)$", text.strip())
    if not m:
        raise ValueError(f"cannot parse duration {text!r} (want e.g. 50ms)")
    return float(m.group(1)) * _DUR_UNITS[m.group(2)]


#: exit status for the ``crash`` action — the conventional 128+SIGKILL,
#: so a supervisor reading the code cannot tell it from a real kill -9
CRASH_EXIT_CODE = 137


class FaultError(ValueError):
    """A faults spec that does not parse (bad point/action/modifier)."""


class FaultInjected(Exception):
    """Raised by an armed ``error`` (or siteless ``torn-write``)
    failpoint. The storage retry layer classifies this transient, so
    low-rate injected errors exercise retries instead of surfacing."""

    def __init__(self, point: str, action: str = "error"):
        super().__init__(f"injected {action} at failpoint {point!r}")
        self.point = point
        self.action = action


@dataclasses.dataclass
class FaultRule:
    """One armed spec item. ``pattern`` may be an exact point name or a
    glob (``eventlog.flush.*``); first matching rule in spec order wins."""

    pattern: str
    action: str
    delay_s: Optional[float] = None  # latency only
    probability: float = 1.0
    once: bool = False
    triggered: int = 0
    disarmed: bool = False

    def to_dict(self) -> dict:
        d = {
            "pattern": self.pattern,
            "action": self.action,
            "probability": self.probability,
            "once": self.once,
            "triggered": self.triggered,
            "disarmed": self.disarmed,
        }
        if self.delay_s is not None:
            d["delay_ms"] = self.delay_s * 1000.0
        return d


def parse_faults(spec: str) -> List[FaultRule]:
    """Parse ``point=action[:arg[:modifier]],...`` into rules.

    Examples: ``eventlog.flush.*=error:0.1`` (10% of matching hits),
    ``storage.sqlite.commit=latency:200ms``, ``worker.serve=crash:once``.
    ``latency`` requires a leading duration; every action then takes an
    optional modifier — a probability in ``(0, 1]`` or ``once``.
    """
    rules: List[FaultRule] = []
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        point, sep, raw = item.partition("=")
        point, raw = point.strip(), raw.strip()
        if not sep or not raw or not point:
            raise FaultError(
                f"faults spec item {item!r} is not point=action"
            )
        parts = [p.strip() for p in raw.split(":")]
        # torn_write accepted for shells where '-' invites quoting issues
        action = parts[0].lower().replace("_", "-")
        if action not in _ACTIONS:
            raise FaultError(
                f"unknown fault action {parts[0]!r} in {item!r} "
                f"(expected one of: {', '.join(_ACTIONS)})"
            )
        mods = parts[1:]
        delay_s = None
        if action == "latency":
            if not mods or not mods[0]:
                raise FaultError(
                    f"latency needs a duration in {item!r} "
                    "(e.g. latency:200ms)"
                )
            try:
                delay_s = parse_duration_s(mods.pop(0))
            except (TypeError, ValueError) as e:
                raise FaultError(f"bad latency in {item!r}: {e}") from None
        probability, once = 1.0, False
        if mods:
            if len(mods) > 1:
                raise FaultError(
                    f"too many modifiers in {item!r} (one of: a "
                    "probability in (0, 1], or 'once')"
                )
            m = mods[0].lower()
            if m == "once":
                once = True
            else:
                try:
                    probability = float(m)
                except ValueError:
                    raise FaultError(
                        f"bad modifier {mods[0]!r} in {item!r} (expected "
                        "a probability in (0, 1], or 'once')"
                    ) from None
                if not (0.0 < probability <= 1.0):
                    raise FaultError(
                        f"fault probability must be in (0, 1], got "
                        f"{probability} in {item!r}"
                    )
        rules.append(
            FaultRule(point, action, delay_s, probability, once)
        )
    return rules


# -- registry state ----------------------------------------------------------
_lock = threading.Lock()
_rules: List[FaultRule] = []
_spec: str = ""
#: point name → first matching rule (or None = no match). THE hot-path
#: structure: disarmed processes see an empty dict, and .get() on it is
#: the entire failpoint cost. Entries are only ever added under _lock;
#: dict reads are safe against concurrent insertion in CPython.
_resolved: Dict[str, Optional[FaultRule]] = {}
_counts: Dict[Tuple[str, str], int] = {}


def install(spec: Optional[str] = None) -> List[FaultRule]:
    """Arm the registry. ``spec=None`` reads :data:`ENV_VAR`; an empty
    resolved spec disarms (every failpoint back to inert). Trigger
    counts survive re-installs — only :func:`uninstall` clears them."""
    if spec is None:
        spec = knobs.knob_str(ENV_VAR)
    rules = parse_faults(spec) if spec else []
    global _rules, _spec
    with _lock:
        _rules = rules
        _spec = spec if rules else ""
        # resolution is lazy (first hit per point) so first-match-wins
        # follows SPEC order even when a glob precedes an exact pattern
        _resolved.clear()
    return rules


def uninstall() -> None:
    """Disarm and forget everything, counts included (test isolation)."""
    global _rules, _spec
    with _lock:
        _rules = []
        _spec = ""
        _resolved.clear()
        _counts.clear()


def _match(point: str) -> Optional[FaultRule]:
    rule = _resolved.get(point)
    if rule is not None or point in _resolved:
        return rule
    with _lock:
        rule = None
        for r in _rules:
            if r.pattern == point or fnmatch.fnmatchcase(point, r.pattern):
                rule = r
                break
        _resolved[point] = rule
    return rule


def _arm_check(rule: FaultRule, point: str) -> bool:
    """Probability/once bookkeeping; True = the action fires now."""
    with _lock:
        if rule.disarmed:
            return False
        if rule.probability < 1.0 and random.random() >= rule.probability:
            return False
        rule.triggered += 1
        if rule.once:
            rule.disarmed = True
        key = (point, rule.action)
        _counts[key] = _counts.get(key, 0) + 1
    return True


def failpoint(point: str, data: Optional[bytes] = None) -> Optional[bytes]:
    """The hook. Inert (no matching armed rule) → returns None having
    cost one dict lookup. Armed:

    - ``latency`` sleeps, returns None;
    - ``error`` raises :class:`FaultInjected`;
    - ``crash`` writes one stderr line and ``os._exit(137)``s;
    - ``torn-write`` with ``data`` returns a random strict prefix of it —
      the caller persists that prefix and then fails, simulating a crash
      mid-write; without ``data`` (a site that has no payload) it
      degrades to ``error``.
    """
    if not _rules:
        return None
    rule = _match(point)
    if rule is None or not _arm_check(rule, point):
        return None
    action = rule.action
    if action == "latency":
        # the injected stall IS the fault under test; only armed
        # latency rules (tests) ever reach this sleep
        # pio: disable=hotpath-blocking
        time.sleep(rule.delay_s or 0.0)
        return None
    if action == "crash":
        # stderr is unbuffered-ish and this is the last observable trace
        # of the injection for crash-consistency tests' parent process
        sys.stderr.write(f"pio-tpu: injected crash at failpoint {point!r}\n")
        sys.stderr.flush()
        os._exit(CRASH_EXIT_CODE)
    if action == "torn-write" and data is not None:
        # the truncated copy is the injected wound; test-only path
        # pio: disable=hotpath-zero-copy
        return data[: random.randrange(0, max(1, len(data)))]
    raise FaultInjected(point, action)


def trigger_counts() -> Dict[Tuple[str, str], int]:
    with _lock:
        return dict(_counts)


def exposition_lines() -> List[str]:
    """Prometheus rendering of the trigger counter, for
    ``MetricsRegistry.add_collector`` on the serving daemons."""
    with _lock:
        items = sorted(_counts.items())
    if not items:
        return []
    lines = [
        "# HELP pio_tpu_fault_triggered_total Armed failpoint triggers",
        "# TYPE pio_tpu_fault_triggered_total counter",
    ]
    for (point, action), n in items:
        lines.append(
            "pio_tpu_fault_triggered_total"
            f'{{point="{point}",action="{action}"}} {n}'
        )
    return lines


def snapshot() -> dict:
    """``GET /faults.json`` payload."""
    with _lock:
        return {
            "enabled": bool(_rules),
            "spec": _spec,
            "rules": [r.to_dict() for r in _rules],
            "triggered": [
                {"point": p, "action": a, "count": n}
                for (p, a), n in sorted(_counts.items())
            ],
        }


# arm from the environment at import: spawned pool workers and forked
# test writers inherit the spec without any plumbing. A bad env spec
# raises here — same fail-fast the CLI gives the flag form.
if knobs.knob_str(ENV_VAR):
    install()
