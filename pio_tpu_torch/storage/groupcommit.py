"""Leader/follower cross-request write coalescing (group commit).

The port's copy of ``pio_tpu/storage/groupcommit.py`` (the port imports
nothing of ``pio_tpu``), with its failpoint (``groupcommit.flush.<store>``,
inside the flush's try, so an injected error takes the solo-retry path)
and without its tracing and metrics, the
partial-flush outcome and outcome-count check of backends that cannot
write a batch atomically or in order (SQLite's flush does both) and the
liveness probe (the event server's ``/healthz``), which come with later
slices.

This is the classic database group-commit protocol, chosen over a
dedicated committer thread because it is free for serial traffic: a lone
request enqueues, immediately wins the commit lock, and flushes just its
own payload — no handoff, no extra context switches. Under concurrency,
threads that arrive while a leader is mid-flush queue up and the next
leader flushes them all in one backend write.

Durability semantics are unchanged: ``submit`` returns only after the
flush containing the payload completed, so a 201 still means "landed in
the store with the backend's configured durability" — coalescing changes
who performs the write, never when success is reported.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Sequence

from pio_tpu_torch.faults import failpoint


class _Item:
    __slots__ = ("payload", "done", "result", "exc")

    def __init__(self, payload):
        self.payload = payload
        self.done = threading.Event()
        self.result = None
        self.exc: Any = None


class GroupCommitter:
    """Coalesce concurrent ``submit`` calls into batched ``flush`` calls.

    ``flush(payloads)`` must write every payload ATOMICALLY (one backend
    transaction — nothing persisted if it raises) and return one result
    per payload, in order. If a batched flush raises, each payload is
    retried ALONE so one poisoned write cannot fail its batch-mates;
    per-payload errors re-raise in their own submitting thread.
    """

    def __init__(self, flush: Callable[[Sequence[Any]], List[Any]],
                 store: str = "unnamed"):
        self._flush = flush
        #: names the failpoint ``groupcommit.flush.<store>``
        self._store = store
        self._q: List[_Item] = []
        self._qlock = threading.Lock()
        self._commit_lock = threading.Lock()

    def submit(self, payload):
        item = _Item(payload)
        with self._qlock:
            self._q.append(item)
        while not item.done.is_set():
            # either become the leader or wait out the current one (whose
            # batch may already include us — it sets done before release)
            if not self._commit_lock.acquire(timeout=0.05):
                continue
            try:
                if item.done.is_set():
                    break
                with self._qlock:
                    batch = self._q
                    self._q = []
                self._flush_batch(batch)
                for i in batch:
                    i.done.set()
            finally:
                self._commit_lock.release()
        if item.exc is not None:
            raise item.exc
        return item.result

    def _flush_batch(self, batch: List[_Item]) -> None:
        """One leader flush: every item of ``batch`` gets its result or
        its exception."""
        try:
            # inside the try: an injected error takes the solo retry below,
            # and an injected crash kills the leader mid-flush
            failpoint(f"groupcommit.flush.{self._store}")
            results = self._flush([i.payload for i in batch])
            for i, r in zip(batch, results):
                i.result = r
        except Exception:
            for i in batch:  # isolate the poisoned payload
                try:
                    i.result = self._flush([i.payload])[0]
                except Exception as exc:
                    i.exc = exc
