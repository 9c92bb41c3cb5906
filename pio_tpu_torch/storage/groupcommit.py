"""Leader/follower cross-request write coalescing (group commit).

The port's copy of ``pio_tpu/storage/groupcommit.py`` (the port imports
nothing of ``pio_tpu``): its failpoint (``groupcommit.flush.<store>``,
inside the flush's try, so an injected error takes the solo-retry path),
the partial-flush outcome of backends that cannot write a batch
atomically (the event log's appends across several files), the
outcome-count check, the liveness ``probe``, and its tracing and metrics:
each leader flush is a trace of :data:`COMMIT_TRACER` linking its members'
request traces, each member's own trace gets ``store.commit_wait`` and
``store.flush`` spans, and ``pio_tpu_groupcommit_flush_seconds`` /
``pio_tpu_groupcommit_batch_size`` meter the flushes on the process-global
registry (the event server shows them on its ``/metrics``).

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

from pio_tpu_torch.analysis.runtime import make_lock
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs.metrics import REGISTRY, monotonic_s
from pio_tpu_torch.obs.slog import current_trace_id
from pio_tpu_torch.obs.tracing import Tracer, active_trace

#: leader flush duration + coalescing effectiveness, labelled by the
#: owning store (process-global registry: storage has no HTTP surface of
#: its own; the event server re-exposes these)
_FLUSH_SECONDS = REGISTRY.histogram(
    "pio_tpu_groupcommit_flush_seconds",
    "Group-commit leader flush duration",
    ("store",),
)
_BATCH_SIZE = REGISTRY.histogram(
    "pio_tpu_groupcommit_batch_size",
    "Payloads coalesced per group-commit flush",
    ("store",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)

#: one trace per leader flush, LINKING the member request traces — the
#: join point of the event path's waterfall ("which requests rode this
#: flush, and which flush did request X wait on"). Feeds
#: ``pio_tpu_commit_stage_seconds``; the event server merges this ring
#: into its ``/traces.json``.
COMMIT_TRACER = Tracer(
    "commit", registry=REGISTRY, stages=("store.flush",), ring=64,
)


class PartialFlushOutcome(Exception):
    """Raised BY a flush callable whose backend cannot make a multi-
    payload write all-or-nothing (e.g. appends across several log
    files): carries one outcome per payload — a result, or an Exception
    for the payloads that failed. The committer assigns them verbatim
    instead of blind-retrying, which would duplicate the payloads that
    already landed."""

    def __init__(self, outcomes):
        super().__init__("partial flush")
        self.outcomes = outcomes


class FlushProtocolError(RuntimeError):
    """A flush (or PartialFlushOutcome) returned a different number of
    outcomes than payloads. The committer cannot tell which payloads
    landed — zip would silently mark the tail done with result=None
    (success with nothing written), and a blind solo retry could
    duplicate the ones that did land — so the whole batch fails."""

    def __init__(self, got: int, expected: int):
        super().__init__(
            f"flush returned {got} outcomes for {expected} payloads"
        )


class _Item:
    __slots__ = ("payload", "done", "result", "exc", "trace_id",
                 "t_submit", "flush_s", "commit_id")

    def __init__(self, payload):
        self.payload = payload
        self.done = threading.Event()
        self.result = None
        self.exc: Any = None
        # trace propagation: the submitting request's trace id rides the
        # item so the leader's flush trace can link its batch-mates
        self.trace_id = current_trace_id()
        self.t_submit = monotonic_s()
        self.flush_s = 0.0          # stamped by the leader
        self.commit_id = None       # the flush trace that carried us


class GroupCommitter:
    """Coalesce concurrent ``submit`` calls into batched ``flush`` calls.

    ``flush(payloads)`` must write every payload ATOMICALLY (one backend
    transaction — nothing persisted if it raises) and return one result
    per payload, in order. If a batched flush raises, each payload is
    retried ALONE so one poisoned write cannot fail its batch-mates;
    per-payload errors re-raise in their own submitting thread. A
    backend that cannot make the batched write all-or-nothing must
    instead raise :class:`PartialFlushOutcome` with per-payload
    outcomes — the committer then assigns them without retrying (a blind
    retry would duplicate the payloads that already landed).
    """

    def __init__(self, flush: Callable[[Sequence[Any]], List[Any]],
                 store: str = "unnamed"):
        self._flush = flush
        #: names the failpoint ``groupcommit.flush.<store>``
        self._store = store
        self._q: List[_Item] = []
        self._qlock = make_lock(f"groupcommit.{store}.qlock")
        self._commit_lock = make_lock(f"groupcommit.{store}.commit")

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
                t_flush = monotonic_s()
                _BATCH_SIZE.observe(len(batch), store=self._store)
                # the leader's flush gets its own trace LINKING every
                # member request
                member_ids = [i.trace_id for i in batch if i.trace_id]
                with COMMIT_TRACER.trace(
                    "commit", links=member_ids,
                    store=self._store, batch=len(batch),
                ) as ctr:
                    self._flush_batch(batch)
                    flush_s = monotonic_s() - t_flush
                    ctr.add_span("store.flush", flush_s, rel_start_s=0.0)
                    if any(i.exc is not None for i in batch):
                        ctr.mark_error()
                _FLUSH_SECONDS.observe(flush_s, store=self._store)
                for i in batch:
                    i.flush_s = flush_s
                    i.commit_id = ctr.trace_id
                    i.done.set()
            finally:
                self._commit_lock.release()
        # attribute the submit on the SUBMITTING request's waterfall:
        # commit_wait (queued behind another leader's flush) + flush
        handle = active_trace()
        if handle is not None:
            total_s = monotonic_s() - item.t_submit
            flush_s = min(item.flush_s, total_s)
            wait_s = max(total_s - flush_s, 0.0)
            rel = handle.elapsed_s - total_s
            if wait_s >= 100e-6:
                handle.add_span("store.commit_wait", wait_s,
                                rel_start_s=rel)
            handle.add_span("store.flush", flush_s,
                            rel_start_s=rel + wait_s)
            if item.commit_id:
                handle.note(commit=item.commit_id)
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
            # list() before the length check: a generator return would
            # raise TypeError on len() after the flush already committed,
            # and the solo retry below would then duplicate every payload
            results = list(self._flush([i.payload for i in batch]))
            if len(results) != len(batch):
                raise FlushProtocolError(len(results), len(batch))
            for i, r in zip(batch, results):
                i.result = r
        except FlushProtocolError as proto:
            for i in batch:
                i.exc = proto
        except PartialFlushOutcome as partial:
            if len(partial.outcomes) != len(batch):
                proto = FlushProtocolError(len(partial.outcomes), len(batch))
                for i in batch:
                    i.exc = proto
            else:
                for i, outcome in zip(batch, partial.outcomes):
                    if isinstance(outcome, Exception):
                        i.exc = outcome
                    else:
                        i.result = outcome
        except Exception:
            for i in batch:  # isolate the poisoned payload
                try:
                    i.result = self._flush([i.payload])[0]
                except Exception as exc:
                    i.exc = exc

    def probe(self, timeout: float = 0.5):
        """Liveness check: try to take the commit lock within ``timeout``.

        Group commit is leader/follower — there is no dedicated thread
        whose aliveness a probe could check. What can wedge is the commit
        lock itself (a leader stuck inside a hung backend flush holds it
        forever, and every later submit spins behind it), so the probe
        measures exactly that: lock acquirable → healthy; ``timeout``
        elapsed → a flush has been in flight at least that long."""
        if self._commit_lock.acquire(timeout=timeout):
            self._commit_lock.release()
            return True, "commit lock acquirable"
        return False, (
            f"commit lock held > {timeout}s (flush in flight or wedged)"
        )
