"""Cross-worker shared-memory batch lane for the serving pool.

The port's copy of ``pio_tpu/server/batchlane.py``, with the same
``PIOLANE1`` layout, so that either package opens a segment the other
created. Failpoints: ``batchlane.submit`` (a client's submission) and
``batchlane.drain`` (one drainer cycle).

The SO_REUSEPORT pool multiplies host-path QPS, but it FRAGMENTS batch
occupancy: each worker process runs its own micro-batcher over 1/N of
the traffic, so no worker ever collects a batch worth dispatching and
the device sits idle between N small calls. The lane re-aggregates:
non-device workers enqueue their (already admitted + validated) query
bodies into a shared-memory ring and block on an event; the
device-owning worker (``device_worker=True``, idx 0 in
``worker_pool.py``) drains every stripe, serves ALL workers' queries as
ONE bucket-shaped dispatch (see ``bucketcache.py``), and writes each
result back into the slot it came from — batch occupancy scales with
pool size instead of per-process concurrency.

Machinery: one mmapped file of fixed layout (the ``PoolMetricsSegment``
supervisor creates, workers reopen by path; works under the ``spawn``
context), plus two ``multiprocessing.Event`` doorbells: one
shared request doorbell the drainer sleeps on, one response event per
worker. Any object with ``set/clear/wait`` works, so tests drive the
protocol with ``threading.Event`` in a single process.

Slot protocol (single writer per field — no cross-process locks):

- Each worker owns one STRIPE of slots; only that worker's request
  threads ever write a slot's ``req_seq``/request payload, and only the
  drainer ever writes ``resp_seq``/response payload. Ownership of the
  shared payload region passes with the seq handshake (SPSC style).
- Post:    write payload + lengths, then ``req_seq = s`` (odd).
- Drain:   a slot with odd ``req_seq != resp_seq`` holds a request.
- Respond: write payload + status, then ``resp_seq = s``.
- Free:    the submitter consumes the response and sets
  ``req_seq = s + 1`` (even). A submitter that TIMED OUT leaves the
  slot alone (the drainer may still be writing); the allocator reclaims
  it later, once ``resp_seq`` catches up — a lost wakeup can strand a
  slot for one drain cycle, never corrupt it.

Payloads are UTF-8 JSON (query body in, jsonable result out): the lane
moves REQUESTS, not tensors, so every template — and every query-path
hook on the device worker — works unchanged. Oversized bodies and a
full stripe degrade to the submitter's local predict path (counted by
reason), never to an error.

Request payloads have ONE binary alternative: an int8-wire
query packed as ``PACKED_MAGIC + u32 dim + dim int8 codes``. A JSON
body always starts with ``{``/``[``/a quote, so the NUL-led magic can
never collide; the drainer hands a decoded :class:`PackedQuery` to its
dispatch function instead of a JSON body, and the device worker
dequantizes it with the resident scorer's training scales (exact
round trip — see ``server/residency.py``). Responses stay JSON in both
cases: the win is the REQUEST direction, where a feature vector crosses
the ring as one byte per column instead of its decimal text.

Layout (little-endian)::

    0   8s  magic  b"PIOLANE1"
    8   I   n_workers
    12  I   slots_per_worker
    16  I   payload_bytes (per slot)
    20  12x reserved
    32  n_workers stripes of slots_per_worker slots
        slot: 32-byte header (req_seq Q, resp_seq Q, req_len I,
        resp_len I, status I, reserved I) + payload_bytes
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import struct
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.batchlane")

MAGIC = b"PIOLANE1"
HEADER_BYTES = 32
SLOT_HEADER_BYTES = 32

#: per-worker ring depth — bounds how many requests one worker can have
#: in flight through the lane (beyond it: local fallback, not an error)
DEFAULT_SLOTS = 64
#: per-slot payload capacity; a top-N query body is ~100 bytes and its
#: response ~1 KiB, so 16 KiB rides out fat black_lists comfortably
DEFAULT_PAYLOAD_BYTES = 16384

#: response status codes (drainer-written)
STATUS_OK = 0
STATUS_ERROR = 1

_SLOT_HDR = struct.Struct("<QQIII4x")

#: packed int8 request frame: magic + u32 code count + the codes. The
#: leading NUL is the JSON/binary discriminator (see module docstring).
PACKED_MAGIC = b"\x00Q8\x01"
_PACKED_HDR = struct.Struct("<4sI")


class PackedQuery:
    """An int8-wire query off the lane ring: ``codes`` is a ``[dim]``
    int8 numpy array of quantized features. The drainer's dispatch
    function (the device worker) rebuilds the template Query via the
    resident scorer's ``dequantize`` + ``query_factory``."""

    __slots__ = ("codes",)

    def __init__(self, codes):
        self.codes = codes

    def __len__(self):
        return len(self.codes)


def pack_query_i8(codes) -> bytes:
    """Encode a ``[dim]`` int8 code vector as a lane request frame."""
    codes = np.ascontiguousarray(codes, np.int8).reshape(-1)
    # the one serialization copy: codes -> wire frame
    return _PACKED_HDR.pack(PACKED_MAGIC, len(codes)) + codes.tobytes()


def unpack_query_i8(payload: bytes) -> PackedQuery:
    """Decode a packed frame (the caller already matched the magic)."""
    magic, dim = _PACKED_HDR.unpack_from(payload)
    if magic != PACKED_MAGIC or len(payload) != _PACKED_HDR.size + dim:
        raise ValueError("malformed packed lane frame")
    return PackedQuery(
        np.frombuffer(payload, np.int8, count=dim,
                      offset=_PACKED_HDR.size).copy()
    )


def packed_frame_ok(frame) -> bool:
    """Structural check of a packed frame (any bytes-like) WITHOUT
    decoding it: magic matches and the declared dim accounts for the
    length exactly. The HTTP fast path gates on this before shipping
    body bytes straight into the shm ring — a malformed frame must be a
    client 400, not a drainer-side ValueError burning a lane slot."""
    if len(frame) < _PACKED_HDR.size:
        return False
    magic, dim = _PACKED_HDR.unpack_from(frame)
    return magic == PACKED_MAGIC and len(frame) == _PACKED_HDR.size + dim


class LaneFallback(Exception):
    """Lane unavailable for this request (stripe full, oversize body,
    response timeout, oversize/failed response) — the caller serves the
    query locally. ``reason`` feeds the full/fallback counter label-free
    log line."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class BatchLaneSegment:
    """One mmapped lane file; created by the pool supervisor, reopened
    by every worker."""

    def __init__(self, path: str, n_workers: int, slots_per_worker: int,
                 payload_bytes: int, _file=None, _map=None):
        self.path = path
        self.n_workers = n_workers
        self.slots_per_worker = slots_per_worker
        self.payload_bytes = payload_bytes
        self._f = _file
        self._m = _map

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, path: str, n_workers: int,
               slots_per_worker: int = 0,
               payload_bytes: int = 0) -> "BatchLaneSegment":
        slots_per_worker = slots_per_worker or knobs.knob_int(
            "PIO_TPU_LANE_SLOTS"
        )
        payload_bytes = payload_bytes or knobs.knob_int(
            "PIO_TPU_LANE_SLOT_BYTES"
        )
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        slot_bytes = SLOT_HEADER_BYTES + payload_bytes
        size = HEADER_BYTES + n_workers * slots_per_worker * slot_bytes
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack(
                "<III", n_workers, slots_per_worker, payload_bytes
            ))
            f.write(b"\0" * (size - 20))
        return cls.open(path)

    @classmethod
    def open(cls, path: str) -> "BatchLaneSegment":
        f = open(path, "r+b")
        try:
            head = f.read(HEADER_BYTES)
            if len(head) < HEADER_BYTES or head[:8] != MAGIC:
                raise ValueError(f"{path}: not a batch lane segment")
            n_workers, slots, payload = struct.unpack_from("<III", head, 8)
            slot_bytes = SLOT_HEADER_BYTES + payload
            size = HEADER_BYTES + n_workers * slots * slot_bytes
            m = mmap.mmap(f.fileno(), size)
        except BaseException:
            f.close()
            raise
        return cls(path, n_workers, slots, payload, _file=f, _map=m)

    def close(self) -> None:
        if self._m is not None:
            self._m.close()
            self._m = None
        if self._f is not None:
            self._f.close()
            self._f = None

    def unlink(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # -- slot access -------------------------------------------------------
    def _slot_off(self, worker: int, slot: int) -> int:
        if not (0 <= worker < self.n_workers):
            raise IndexError(f"worker {worker} of {self.n_workers}")
        if not (0 <= slot < self.slots_per_worker):
            raise IndexError(f"slot {slot} of {self.slots_per_worker}")
        slot_bytes = SLOT_HEADER_BYTES + self.payload_bytes
        return HEADER_BYTES + (
            worker * self.slots_per_worker + slot
        ) * slot_bytes

    def _hdr(self, worker: int, slot: int) -> Tuple[int, int, int, int, int]:
        """(req_seq, resp_seq, req_len, resp_len, status)."""
        return _SLOT_HDR.unpack_from(self._m, self._slot_off(worker, slot))

    def post_request(self, worker: int, slot: int, payload: bytes) -> int:
        """Submitter side: write the request and publish it by bumping
        ``req_seq`` to odd. Returns the posted seq. The caller must own
        the slot (even ``req_seq`` == ``resp_seq`` state)."""
        off = self._slot_off(worker, slot)
        req_seq, _, _, _, _ = _SLOT_HDR.unpack_from(self._m, off)
        s = req_seq + 1  # even -> odd
        body_off = off + SLOT_HEADER_BYTES
        self._m[body_off:body_off + len(payload)] = payload
        struct.pack_into("<I", self._m, off + 16, len(payload))
        # seq write LAST: publishing the request is the linearization
        # point the drainer scans for
        struct.pack_into("<Q", self._m, off, s)
        return s

    def read_request(self, worker: int, slot: int) -> Optional[Tuple[int, bytes]]:
        """Drainer side: (req_seq, payload) when the slot holds an
        unanswered request, else None."""
        off = self._slot_off(worker, slot)
        req_seq, resp_seq, req_len, _, _ = _SLOT_HDR.unpack_from(self._m, off)
        if req_seq % 2 == 0 or resp_seq == req_seq:
            return None
        body_off = off + SLOT_HEADER_BYTES
        # copy-out is deliberate: the mmap slot is reused as soon
        # as the response posts, so the request must not alias it
        return req_seq, bytes(self._m[body_off:body_off + req_len])

    def post_response(self, worker: int, slot: int, req_seq: int,
                      payload: bytes, status: int = STATUS_OK) -> None:
        """Drainer side: write the response and publish it by advancing
        ``resp_seq`` to the request's seq."""
        off = self._slot_off(worker, slot)
        body_off = off + SLOT_HEADER_BYTES
        self._m[body_off:body_off + len(payload)] = payload
        struct.pack_into("<II", self._m, off + 20, len(payload), status)
        struct.pack_into("<Q", self._m, off + 8, req_seq)

    def read_response(self, worker: int, slot: int,
                      req_seq: int) -> Optional[Tuple[int, bytes]]:
        """Submitter side: (status, payload) once the drainer answered
        seq ``req_seq``, else None."""
        off = self._slot_off(worker, slot)
        _, resp_seq, _, resp_len, status = _SLOT_HDR.unpack_from(self._m, off)
        if resp_seq != req_seq:
            return None
        body_off = off + SLOT_HEADER_BYTES
        # copy-out is deliberate: release() frees the slot for the
        # next request before the caller finishes with the payload
        return status, bytes(self._m[body_off:body_off + resp_len])

    def release(self, worker: int, slot: int, req_seq: int) -> None:
        """Submitter side: response consumed; free the slot (odd seq →
        even)."""
        struct.pack_into(
            "<Q", self._m, self._slot_off(worker, slot), req_seq + 1
        )

    def reclaimable(self, worker: int, slot: int) -> bool:
        """True when the slot is idle from the drainer's point of view:
        even seq (free) or answered-but-unreleased (abandoned by a
        timed-out submitter — safe to recycle, the drainer is done with
        it)."""
        req_seq, resp_seq, _, _, _ = self._hdr(worker, slot)
        return req_seq % 2 == 0 or resp_seq == req_seq

    def pending_depth(self) -> int:
        """Unanswered requests across all stripes (depth gauge)."""
        n = 0
        for w in range(self.n_workers):
            for s in range(self.slots_per_worker):
                req_seq, resp_seq, _, _, _ = self._hdr(w, s)
                if req_seq % 2 == 1 and resp_seq != req_seq:
                    n += 1
        return n


class LaneClient:
    """Non-device worker's submit side: one instance per worker process,
    shared by its request threads (slot allocation is locked; the wait
    is per-thread)."""

    def __init__(self, seg: BatchLaneSegment, worker_idx: int,
                 doorbell, resp_event, timeout_s: float = 0.0):
        self._seg = seg
        self._idx = worker_idx
        self._doorbell = doorbell
        self._resp_event = resp_event
        self._timeout_s = timeout_s or knobs.knob_float(
            "PIO_TPU_LANE_TIMEOUT_S"
        )
        self._alloc_lock = threading.Lock()
        #: slots a thread of this process holds (its own stripe: this
        #: worker is the only submitter writing it, so local bookkeeping
        #: is authoritative)
        self._busy: set = set()
        #: slots whose submitter timed out and left them in flight; each
        #: is reclaimed once the drainer has answered it
        self._abandoned: set = set()

    @property
    def timeout_s(self) -> float:
        """Default wait for a response (deadline-aware callers clamp)."""
        return self._timeout_s

    def _acquire_slot(self) -> Optional[int]:
        with self._alloc_lock:
            for s in range(self._seg.slots_per_worker):
                req_seq, resp_seq, _, _, _ = self._seg._hdr(self._idx, s)
                if s in self._busy:
                    # a live submitter's, answered or not: only it reads
                    # the response and frees the slot. (The reference
                    # steals an answered slot here as a timed-out one's,
                    # and so can hand a slot whose submitter has not yet
                    # read its answer to a new request, which overwrites
                    # that answer.)
                    continue
                if s in self._abandoned:
                    # its submitter timed out and will never touch it
                    # again: recycle once the drainer answered
                    if resp_seq != req_seq:
                        continue
                    self._abandoned.discard(s)
                    self._seg.release(self._idx, s, req_seq)
                elif req_seq % 2 == 1:
                    # stale in-flight from a previous process life: safe
                    # to recycle once the drainer answered, else skip
                    if resp_seq == req_seq:
                        self._seg.release(self._idx, s, req_seq)
                    else:
                        continue
                self._busy.add(s)
                return s
        return None

    def _submit_payload(self, payload,
                        timeout_s: Optional[float] = None):
        """Ship one pre-encoded request payload (bytes or memoryview)
        through the ring and park until the drainer answers or the
        timeout elapses; returns ``(status, response_bytes)``. The
        payload is written straight into the shm slot by post_request —
        this function never copies or re-encodes it. Raises
        :class:`LaneFallback` whenever the lane cannot answer."""
        failpoint("batchlane.submit")
        if len(payload) > self._seg.payload_bytes:
            raise LaneFallback("oversize")
        slot = self._acquire_slot()
        if slot is None:
            raise LaneFallback("full")
        seq = self._seg.post_request(self._idx, slot, payload)
        self._doorbell.set()
        deadline = monotonic_s() + (timeout_s or self._timeout_s)
        while True:
            got = self._seg.read_response(self._idx, slot, seq)
            if got is not None:
                break
            if monotonic_s() >= deadline:
                # leave the slot in flight; _acquire_slot reclaims it
                # once the drainer responds
                with self._alloc_lock:
                    self._busy.discard(slot)
                    self._abandoned.add(slot)
                raise LaneFallback("timeout")
            # clear-then-check-then-wait: the event may have been set for
            # an earlier response; the slot header is the ground truth
            self._resp_event.clear()
            got = self._seg.read_response(self._idx, slot, seq)
            if got is not None:
                break
            # bounded 2 ms doze between slot-header polls; submit
            # is synchronous RPC, the caller expects to park here
            self._resp_event.wait(0.002)
        status, resp = got
        self._seg.release(self._idx, slot, seq)
        with self._alloc_lock:
            self._busy.discard(slot)
        return status, resp

    def submit(self, body: dict, timeout_s: Optional[float] = None,
               packed: Optional[bytes] = None):
        """Serve one query body through the device worker; blocks until
        the response lands or the timeout elapses. Raises
        :class:`LaneFallback` whenever the lane cannot answer — the
        caller's local predict path is the degradation, so the lane can
        never make a request fail that would have succeeded without it.

        ``packed`` ships a pre-encoded binary frame (``pack_query_i8``)
        instead of JSON-encoding ``body`` — the int8 wire's request
        direction. Callers that also want the RESPONSE undecoded use
        :meth:`submit_packed` instead."""
        if packed is not None:
            payload = packed
        else:
            try:
                # JSON envelope for un-packed callers; the packed int8
                # branch above is the binary wire
                payload = json.dumps(body).encode("utf-8")
            except (TypeError, ValueError):
                raise LaneFallback("unserializable")
        status, resp = self._submit_payload(payload, timeout_s)
        if status != STATUS_OK:
            raise LaneFallback("remote_error")
        try:
            # JSON envelope decode, mirror of the encode above
            return json.loads(resp.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            raise LaneFallback("undecodable_response")

    def submit_packed(self, packed,
                      timeout_s: Optional[float] = None) -> bytes:
        """Raw-frame submit for the zero-copy HTTP ingest: ``packed``
        is an already-wire-shaped frame (bytes or a memoryview into the
        front's connection buffer) and the return value is the
        drainer's response payload UNDECODED — already JSON bytes that
        the front hands straight to the response writer. Socket → shm
        ring → socket with no codec and no intermediate copies on this
        side of the lane."""
        status, resp = self._submit_payload(packed, timeout_s)
        if status != STATUS_OK:
            raise LaneFallback("remote_error")
        return resp


class LaneDrainer:
    """Device worker's drain loop: sleeps on the doorbell, gathers every
    stripe's pending requests, serves them through ``dispatch_fn`` (one
    bucket-shaped batch), and answers each slot.

    ``dispatch_fn(bodies) -> results`` returns one jsonable result per
    body; raising fails the WHOLE drain cycle's requests to their local
    fallbacks (status=error), mirroring the micro-batcher's poisoned-
    batch semantics.
    """

    def __init__(self, seg: BatchLaneSegment,
                 dispatch_fn: Callable[[List[dict]], List],
                 doorbell, resp_events, poll_s: float = 0.05,
                 on_drain: Optional[Callable[[int, int], None]] = None):
        self._seg = seg
        self._dispatch = dispatch_fn
        self._doorbell = doorbell
        self._resp_events = resp_events
        self._poll_s = poll_s
        #: on_drain(n_requests, n_batches) after each served cycle —
        #: metric accounting hook (drained/batches counters, depth gauge)
        self._on_drain = on_drain
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.cycles = 0
        self.drained = 0

    def start(self) -> "LaneDrainer":
        self._thread = threading.Thread(
            target=self._run, name="pio-tpu-batchlane", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped = True
        self._doorbell.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    @property
    def thread(self) -> Optional[threading.Thread]:
        return self._thread

    def _collect(self) -> List[Tuple[int, int, int, dict]]:
        """(worker, slot, req_seq, body) for every pending request.
        Undecodable bodies are answered with an error immediately."""
        out = []
        for w in range(self._seg.n_workers):
            for s in range(self._seg.slots_per_worker):
                got = self._seg.read_request(w, s)
                if got is None:
                    continue
                seq, payload = got
                try:
                    if payload[:4] == PACKED_MAGIC:
                        body = unpack_query_i8(payload)
                    else:
                        body = json.loads(payload.decode("utf-8"))
                except (UnicodeDecodeError, ValueError):
                    self._seg.post_response(
                        w, s, seq, b'"undecodable"', STATUS_ERROR
                    )
                    continue
                out.append((w, s, seq, body))
        return out

    def drain_once(self) -> int:
        """One collect→dispatch→respond cycle; returns requests served.
        Public so tests (and a pool-less embedding) can drive the lane
        without the thread."""
        failpoint("batchlane.drain")
        pending = self._collect()
        if not pending:
            return 0
        bodies = [p[3] for p in pending]
        try:
            results = self._dispatch(bodies)
            if len(results) != len(bodies):
                raise ValueError(
                    f"dispatch returned {len(results)} results "
                    f"for {len(bodies)} bodies"
                )
            payloads = [
                (json.dumps(r).encode("utf-8"), STATUS_OK) for r in results
            ]
        except Exception:
            log.exception(
                "lane dispatch failed; members fall back to local predict"
            )
            payloads = [(b'"dispatch failed"', STATUS_ERROR)] * len(bodies)
        woken = set()
        for (w, s, seq, _), (payload, status) in zip(pending, payloads):
            if len(payload) > self._seg.payload_bytes:
                payload, status = b'"oversize response"', STATUS_ERROR
            self._seg.post_response(w, s, seq, payload, status)
            woken.add(w)
        for w in woken:
            self._resp_events[w].set()
        self.cycles += 1
        self.drained += len(pending)
        if self._on_drain is not None:
            self._on_drain(len(pending), 1)
        return len(pending)

    def _run(self) -> None:
        while not self._stopped:
            # the drain loop parks on the doorbell by design; the
            # wait bounds idle latency, not request latency
            self._doorbell.wait(self._poll_s)
            self._doorbell.clear()
            if self._stopped:
                return
            try:
                while self.drain_once():
                    pass  # drain to empty before sleeping again
            except Exception:
                log.exception("lane drain cycle failed")
