"""Runtime lock-order detection: debug-armed instrumented sync
primitives, the dynamic twin of the static ``lock-order-cycle`` rule.

The serving stack creates its locks through the factories here::

    self._qlock = make_lock("groupcommit.qlock")
    self._cond = make_condition("qos.limiter")

Disarmed (the default) the factories return plain ``threading``
primitives — zero overhead, zero behaviour change. With
``PIO_TPU_DEBUG_SYNC=1`` (or ``raise``) set **at creation time** they
return instrumented wrappers that

* keep a per-thread stack of currently-held locks,
* record every (held -> newly-acquired) edge into a process-global
  order graph, and
* on an acquisition that would close a cycle in that graph (i.e. some
  other code path takes these locks in the opposite order), log the
  inversion with both hold sites and raise :class:`LockOrderInversion`.

``PIO_TPU_DEBUG_SYNC=log`` records + logs but does not raise (for
soaking a live system). The detector is deliberately name-annotated:
inversions print ``groupcommit.qlock -> qos.limiter`` rather than
``<locked _thread.lock object>``.

Re-entrant acquisition of the *same* instance (RLock, Condition re-use)
records nothing; ``Condition.wait`` releases through the wrapper, so
the held-stack stays truthful across waits.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Dict, List, Optional, Set, Tuple

from pio_tpu_torch.utils import knobs

ENV_VAR = "PIO_TPU_DEBUG_SYNC"

log = logging.getLogger("pio_tpu_torch.analysis.sync")


class LockOrderInversion(RuntimeError):
    """Acquiring this lock here contradicts an order observed earlier."""


class SyncDebugger:
    """Process-global acquisition-order graph + per-thread held stacks."""

    def __init__(self) -> None:
        self._graph_lock = threading.Lock()
        #: edge a -> {b: (thread name, b acquired while a held)}
        self._edges: Dict[int, Dict[int, str]] = {}
        self._names: Dict[int, str] = {}
        self._tls = threading.local()
        self._inversions: List[str] = []

    # -- per-thread held stack ---------------------------------------------
    def _held(self) -> List[int]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    # -- events from the wrappers ------------------------------------------
    def register(self, lock: "_DebugBase") -> None:
        """Track the lock's name and prune its graph node when the lock
        is garbage-collected — ``id()`` values get reused, and a fresh
        lock aliasing a dead one's id would inherit its stale edges
        (phantom inversions)."""
        lid = id(lock)
        with self._graph_lock:
            self._names[lid] = lock.name
        weakref.finalize(lock, self._forget, lid)

    def _forget(self, lid: int) -> None:
        with self._graph_lock:
            self._edges.pop(lid, None)
            for nbrs in self._edges.values():
                nbrs.pop(lid, None)
            self._names.pop(lid, None)

    def on_acquired(self, lock: "_DebugBase") -> Optional[str]:
        """Record the acquisition; returns the inversion description if
        this acquisition contradicts a previously-observed order (the
        wrapper decides whether to raise)."""
        held = self._held()
        lid = id(lock)
        self._names[lid] = lock.name
        if lid in held:          # re-entrant: no new ordering information
            held.append(lid)
            return None
        inversion = None
        with self._graph_lock:
            for h in held:
                if h == lid:
                    continue
                # would edge (h -> lid) close a cycle? i.e. lid already
                # orders before h somewhere else
                if self._reaches(lid, h):
                    inversion = (
                        f"lock-order inversion: acquiring "
                        f"`{self._names[lid]}` while holding "
                        f"`{self._names[h]}`, but the opposite order "
                        f"`{self._names[lid]}` -> `{self._names[h]}` was "
                        f"observed earlier ({self._edges[lid].get(h, '?')})"
                    )
                self._edges.setdefault(h, {}).setdefault(
                    lid, threading.current_thread().name)
            if inversion:
                self._inversions.append(inversion)
        held.append(lid)
        if inversion:
            log.warning("%s", inversion)
        return inversion

    def on_released(self, lock: "_DebugBase") -> None:
        held = self._held()
        lid = id(lock)
        # release in LIFO discipline is the norm; tolerate out-of-order
        # release by removing the most recent matching entry
        for i in range(len(held) - 1, -1, -1):
            if held[i] == lid:
                del held[i]
                break

    def _reaches(self, src: int, dst: int) -> bool:
        """DFS: is there a path src -> ... -> dst in the order graph?"""
        seen: Set[int] = set()
        stack = [src]
        while stack:
            node = stack.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self._edges.get(node, ()))
        return False

    # -- inspection / test hooks -------------------------------------------
    def inversions(self) -> List[str]:
        with self._graph_lock:
            return list(self._inversions)

    def edges(self) -> List[Tuple[str, str]]:
        with self._graph_lock:
            return sorted(
                (self._names.get(a, "?"), self._names.get(b, "?"))
                for a, nbrs in self._edges.items() for b in nbrs
            )

    def reset(self) -> None:
        with self._graph_lock:
            self._edges.clear()
            self._names.clear()
            self._inversions.clear()


_DEBUGGER = SyncDebugger()


def sync_debugger() -> SyncDebugger:
    """The process-global detector (test/inspection surface)."""
    return _DEBUGGER


def _mode() -> str:
    return knobs.knob_str(ENV_VAR).strip().lower()


def _armed() -> bool:
    return _mode() not in ("", "0", "off")


#: lock waits shorter than this never become spans — an uncontended
#: acquire costs ~1 µs and would bury real stages in lock.* noise.
LOCK_SPAN_MIN_S = 100e-6


def _report_lock_wait(name: str, wait_s: float) -> None:
    """Attach a ``lock.<name>`` span to the active request trace (armed
    runs only — disarmed factories hand out plain primitives, so this
    costs nothing in production). Lazy import: analysis must stay
    importable without the obs stack."""
    try:
        from pio_tpu_torch.obs.tracing import add_active_span
    except Exception:
        return
    add_active_span(f"lock.{name}", wait_s)


class _DebugBase:
    """Common acquire/release bookkeeping over an inner primitive."""

    def __init__(self, name: str, inner) -> None:
        self.name = name
        self._inner = inner
        _DEBUGGER.register(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t_req = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            wait_s = time.perf_counter() - t_req
            if wait_s >= LOCK_SPAN_MIN_S:
                _report_lock_wait(self.name, wait_s)
            inversion = _DEBUGGER.on_acquired(self)
            if inversion is not None and _mode() != "log":
                # back out so the raising thread doesn't strand the lock
                _DEBUGGER.on_released(self)
                self._inner.release()
                raise LockOrderInversion(inversion)
        return ok

    def release(self) -> None:
        self._inner.release()
        _DEBUGGER.on_released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class DebugLock(_DebugBase):
    def __init__(self, name: str):
        super().__init__(name, threading.Lock())

    def locked(self) -> bool:
        return self._inner.locked()


class DebugRLock(_DebugBase):
    def __init__(self, name: str):
        super().__init__(name, threading.RLock())

    # threading.Condition probes these when handed an RLock-like object
    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def make_lock(name: str) -> "threading.Lock | DebugLock":
    """A mutex named for diagnostics; plain ``threading.Lock`` unless
    ``PIO_TPU_DEBUG_SYNC`` is armed at creation time."""
    return DebugLock(name) if _armed() else threading.Lock()


def make_rlock(name: str) -> "threading.RLock | DebugRLock":
    return DebugRLock(name) if _armed() else threading.RLock()


def make_condition(name: str,
                   lock: Optional[object] = None) -> threading.Condition:
    """A condition variable whose underlying mutex participates in
    lock-order detection (``Condition`` routes every acquire/release —
    including the release inside ``wait()`` — through the lock object
    it is given)."""
    if lock is not None:
        return threading.Condition(lock)  # caller supplied (maybe debug)
    if _armed():
        return threading.Condition(DebugLock(name))
    return threading.Condition()
