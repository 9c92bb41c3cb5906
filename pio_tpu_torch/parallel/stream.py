"""Streamed host→device feed executor: the one streaming discipline of the
port's trainers.

Counterpart of ``pio_tpu/parallel/stream.py``, in PyTorch's own idiom. An
epoch is sliced into chunks; each chunk is encoded on the host (sliced to
this rank's rows), copied to the device, and handed to the chunk's
compute, which waits only on its own copy: chunk k's compute runs while
chunk k+1 is still crossing the link. The two-tower and sequence
trainers feed their per-step minibatch spans through it when the staged
epoch does not fit ``PIO_TPU_DEVICE_BUDGET_BYTES`` beside the params, or
when asked to (``stream="on"``).

On a CUDA device:

- **The copy stream.** The copies run on a dedicated
  ``torch.cuda.Stream``; each chunk records a copy-done event, and the
  compute stream waits on that event (``wait_event``), not on the whole
  copy stream.
- **Pinned staging.** Each chunk is staged in pinned host memory, so
  that ``copy_(non_blocking=True)`` really is asynchronous (a copy from
  pageable memory is synchronous and would silently lose the overlap).
  The staging buffers are a ring of ``lookahead + 1`` slots, sized to
  the largest span (``stage_bytes``, else grown to the largest chunk
  seen); a slot is refilled only once its previous copy-done event has
  completed. :func:`pinned_buffers_allocated` counts the allocations.
- **Freed memory.** Each device chunk is marked
  ``record_stream(compute)``, so that the caching allocator does not hand
  its memory to a later copy while a kernel still reads it.
- **The throttle.** A compute-done event is recorded after each chunk's
  dispatch; before chunk ``i + lookahead`` is shipped, the event of chunk
  ``i - lookahead`` is synchronized. ``torch.cuda.synchronize()`` is
  never called.

On the CPU there is no copy stream, no pinning and no event: a chunk is
``torch.from_numpy(...).to(device)``.

Two scheduling modes, as in the reference:

- **queue-ahead** (``lookahead=0``): every chunk's copy is issued up
  front, then the chunk programs are chained;
- **double-buffered** (``lookahead=k``): at most ``k`` chunks are
  shipped ahead of the chunk being dispatched, and the host waits on
  chunk ``i - k``'s compute before shipping further.

With a ``stats`` dict the phases are *serialized* (encode all → ship all
and wait → dispatch all and wait) so that each is measurable, overlap
off: ``h2d_s``, ``device_s``, ``encode_s`` and ``h2d_bytes``.
:func:`record_overlap_ratio` turns a profiled pair into
``pio_tpu_train_stream_overlap_ratio``. With an active trainwatch
recorder an overlapped run measures itself: chunk 0 runs serialized as a
probe (extra waits only, the same math) and the remaining chunks' wall
time gives the ratio.

Every shipped chunk adds to ``pio_tpu_train_h2d_bytes_total``, the
recorder's ``h2d_bytes`` and the device watch's ``stream`` ledger (until
its dispatch, or the feed's end where ``finalize`` retains the chunks);
each chunk dispatch is a ``stream_dispatch`` compile site keyed by its
shapes. Failpoints: ``stream.encode``, ``stream.put`` and
``stream.dispatch`` fire once a chunk a phase.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs import devicewatch, trainwatch
from pio_tpu_torch.obs.metrics import REGISTRY, monotonic_s
from pio_tpu_torch.parallel.partition import device_budget_bytes
from pio_tpu_torch.utils import knobs

#: host→device bytes shipped by the streamed training feed
_H2D_BYTES = REGISTRY.counter(
    "pio_tpu_train_h2d_bytes_total",
    "Host-to-device bytes shipped by the streamed training feed",
)

#: transfer time hidden behind compute, from the last profiled pair
_OVERLAP = REGISTRY.gauge(
    "pio_tpu_train_stream_overlap_ratio",
    "Fraction of streamed-feed transfer time hidden behind compute "
    "(profiled h2d_s + device_s vs overlapped wall time)",
)

#: pinned staging buffers allocated by every feed of the process
_PINNED_ALLOCS = [0]


def pinned_buffers_allocated() -> int:
    """Pinned staging buffers the feeds of this process have allocated
    (one a ring slot and leaf, plus any regrowth)."""
    return _PINNED_ALLOCS[0]


def n_stream_chunks(n_bytes: int, env_var: str, cap: int = 8) -> int:
    """Chunk count for a streamed host→device shipment: ``ceil(bytes /
    chunk_mb)`` capped at ``cap``, ``chunk_mb`` the knob ``env_var``
    (declared in ``utils/knobs.py``); 1 (streaming off) when it is
    ≤ 0."""
    mb = knobs.knob_float(env_var)
    if mb <= 0:
        return 1
    return int(min(cap, -(-n_bytes // max(1, int(mb * 2 ** 20)))))


def n_spans(epoch_nbytes: int, device_nbytes: int, params_nbytes: int,
            n_batches: int) -> int:
    """The trainers' span count for a streamed epoch (the reference's
    rule, ``two_tower.py`` l.426-440, ``seqrec.py`` l.497-505): spans of
    ``PIO_TPU_TRAIN_STREAM_MB`` over ``epoch_nbytes`` (2 to 256), raised
    until one span of the ``device_nbytes`` a device would stage fits the
    headroom of ``PIO_TPU_DEVICE_BUDGET_BYTES`` beside ``params_nbytes``,
    at most one a batch."""
    n = max(2, n_stream_chunks(epoch_nbytes, "PIO_TPU_TRAIN_STREAM_MB",
                               cap=256))
    budget = device_budget_bytes()
    if budget > params_nbytes:
        n = max(n, -(-device_nbytes // (budget - params_nbytes)))
    return min(n_batches, n)


def span_bounds(n_batches: int, n_stream: int) -> list:
    """``n_stream`` near-even contiguous span boundaries over an epoch of
    ``n_batches`` batches (``n_stream`` clipped to ``[1, n_batches]``)."""
    n_stream = max(1, min(n_batches, n_stream))
    return [n_batches * c // n_stream for c in range(n_stream + 1)]


def epoch_spans(step0: int, n_steps: int, n_batches: int,
                bounds: Sequence[int]) -> list:
    """Batch spans covering steps ``[step0, step0 + n_steps)`` of a
    wrapped epoch schedule (step ``s`` consumes batch ``s % n_batches``)
    as ``(b0, b1)`` ranges, each a contiguous run of batches inside one
    span of ``bounds``, clipped to the step range per epoch pass. The
    streamed feed replays exactly the staged batch order, which is what
    makes a streamed run give the staged run's bits."""
    work = []
    s, end = step0, step0 + n_steps
    while s < end:
        base = (s // n_batches) * n_batches
        b0 = s - base
        c = bisect.bisect_right(bounds, b0) - 1
        b1 = min(bounds[c + 1], end - base)
        work.append((b0, b1))
        s = base + b1
    return work


def _leaves(host) -> list:
    return list(host) if isinstance(host, (tuple, list)) else [host]


def _tree_nbytes(host) -> int:
    return sum(int(getattr(a, "nbytes", 0) or 0) for a in _leaves(host))


def _rebuild(host, leaves: list):
    return tuple(leaves) if isinstance(host, (tuple, list)) else leaves[0]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _CudaCopier:
    """The CUDA side of a feed: the copy stream, the pinned ring and the
    per-chunk copy-done and compute-done events."""

    def __init__(self, device: torch.device, n_slots: int,
                 stage_bytes: Optional[Sequence[int]]):
        self.device = device
        self.compute = torch.cuda.current_stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        #: slot → per-leaf flat pinned uint8 buffers
        self._ring: List[Optional[list]] = [None] * n_slots
        #: slot → copy-done event of the chunk that last filled it
        self._slot_done: List[Optional[torch.cuda.Event]] = [None] * n_slots
        #: chunk → copy-done event (the compute stream waits on it)
        self.copied: dict = {}
        #: chunk → compute-done event (the throttle synchronizes it)
        self.computed: dict = {}
        if stage_bytes is not None:
            for s in range(n_slots):
                self._ring[s] = [self._pin(int(b)) for b in stage_bytes]

    @staticmethod
    def _pin(nbytes: int) -> torch.Tensor:
        _PINNED_ALLOCS[0] += 1
        return torch.empty(max(1, nbytes), dtype=torch.uint8,
                           pin_memory=True)

    def put(self, host, i: int):
        """Stage chunk ``i`` in its ring slot and queue its copies on the
        copy stream; returns the device tensors."""
        s = i % len(self._ring)
        if self._slot_done[s] is not None:
            # the slot's previous copy must have left the buffer
            self._slot_done[s].synchronize()
        leaves = _leaves(host)
        bufs = self._ring[s]
        if bufs is None or len(bufs) != len(leaves):
            bufs = self._ring[s] = [self._pin(a.nbytes) for a in leaves]
        out = []
        with torch.cuda.stream(self.copy_stream):
            for k, a in enumerate(leaves):
                if bufs[k].numel() < a.nbytes:  # a larger span than seen
                    bufs[k] = self._pin(a.nbytes)
                dt = _torch_dtype(a.dtype)
                staged = bufs[k][:a.nbytes].view(dt).reshape(a.shape)
                np.copyto(staged.numpy(), a)
                dev = torch.empty(a.shape, dtype=dt, device=self.device)
                dev.copy_(staged, non_blocking=True)
                # the allocator must not reuse it while the compute
                # stream may still read it
                dev.record_stream(self.compute)
                out.append(dev)
        ev = torch.cuda.Event()
        ev.record(self.copy_stream)
        self._slot_done[s] = self.copied[i] = ev
        return _rebuild(host, out)

    def before_dispatch(self, i: int) -> None:
        ev = self.copied.pop(i, None)
        if ev is not None:
            self.compute.wait_event(ev)

    def after_dispatch(self, i: int) -> None:
        ev = torch.cuda.Event()
        ev.record(self.compute)
        self.computed[i] = ev

    def wait_copies(self) -> None:
        """Wait for every queued copy (one stream: an event behind the
        last one)."""
        ev = torch.cuda.Event()
        ev.record(self.copy_stream)
        ev.synchronize()

    def wait_compute(self, i: Optional[int] = None) -> None:
        """Wait for chunk ``i``'s compute (None: everything queued on the
        compute stream so far)."""
        if i is None:
            ev = torch.cuda.Event()
            ev.record(self.compute)
            ev.synchronize()
            return
        ev = self.computed.pop(i, None)
        if ev is not None:
            ev.synchronize()


class _CpuCopier:
    """The CPU side: a chunk is ``torch.from_numpy(...).to(device)``, and
    every wait is a no-op (the compute has run when dispatch returns)."""

    def __init__(self, device: torch.device):
        self.device = device

    def put(self, host, i: int):
        return _rebuild(host, [
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in _leaves(host)])

    def before_dispatch(self, i: int) -> None:
        pass

    def after_dispatch(self, i: int) -> None:
        pass

    def wait_copies(self) -> None:
        pass

    def wait_compute(self, i: Optional[int] = None) -> None:
        pass


def stream_feed(
    chunks: Sequence[Any],
    *,
    encode: Callable[[Any], Any],
    dispatch: Callable[[Any, Any, int], Any],
    init_carry: Callable[[], Any],
    put: Optional[Callable[[Any, int], Any]] = None,
    finalize: Optional[Callable[[Any, tuple], Any]] = None,
    lookahead: int = 0,
    stats: Optional[dict] = None,
    device: DeviceLike = None,
    stage_bytes: Optional[Sequence[int]] = None,
) -> Any:
    """Run the streamed feed over ``chunks``; returns the final carry (or
    ``finalize``'s result).

    Args:
        chunks: opaque per-chunk descriptors (span bounds, slices, …).
        encode: ``chunk → host arrays`` (a numpy array or a tuple of
            them): the host-side slice of this rank's rows.
        dispatch: ``(carry, device_chunk, idx) → carry``: the chunk's
            compute, queued on the current stream; it must not wait.
        init_carry: builds the initial carry at the dispatch phase's start
            (inside ``device_s`` when profiling).
        put: ``(host, idx) → device chunk``; default the copier of
            ``device`` (the copy stream and the pinned ring on CUDA).
        finalize: ``(carry, device_chunks) → result``. When present the
            device chunks are retained and handed over; when absent each
            chunk is dropped right after its dispatch, so a streamed epoch
            never accumulates on the device.
        lookahead: 0 → queue every put up front; k > 0 → at most k chunks
            shipped ahead of the chunk being dispatched.
        stats: phase-serialized profiling (module docstring): overlap is
            off while measuring.
        device: where the chunks go (CUDA unless the caller asks for the
            CPU).
        stage_bytes: per-leaf bytes of the largest chunk: the pinned ring
            is allocated at that size up front (CUDA only).
    """
    dev = resolve_device(device)
    copier = (_CudaCopier(dev, max(1, lookahead + 1), stage_bytes)
              if dev.type == "cuda" else _CpuCopier(dev))
    if put is None:
        put = copier.put
    n = len(chunks)
    retain = finalize is not None

    def _encode(i):
        failpoint("stream.encode")
        return encode(chunks[i])

    shipped = [0]  # bytes shipped this call (overlap-probe bookkeeping)
    chunk_bytes: dict = {}  # in-flight chunk footprint (device ledger)

    def _put(host, i):
        failpoint("stream.put")
        nbytes = _tree_nbytes(host)
        _H2D_BYTES.inc(nbytes)
        shipped[0] += nbytes
        trainwatch.record_h2d(nbytes)
        chunk_bytes[i] = nbytes
        devicewatch.stream_carry(nbytes, dev.index or 0)
        if stats is not None:
            stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + nbytes
        return put(host, i)

    def _dispatch(carry, chunk, i):
        failpoint("stream.dispatch")
        copier.before_dispatch(i)
        # compile attribution: a chunk whose shapes are new to the feed
        # (typically the first chunk and a ragged tail)
        with devicewatch.compile_span(
            "stream_dispatch", key=devicewatch.shape_key(chunk)
        ):
            out = dispatch(carry, chunk, i)
        copier.after_dispatch(i)
        if not retain:
            # the chunk is consumed: its tensors go with the references
            devicewatch.stream_carry(-chunk_bytes.pop(i, 0), dev.index or 0)
        return out

    def _release_retained():
        if chunk_bytes:  # retained chunks freed with finalize's result
            devicewatch.stream_carry(-sum(chunk_bytes.values()),
                                     dev.index or 0)
            chunk_bytes.clear()

    if stats is not None:
        # serialized phases: the host encode must not pollute the
        # transfer measurement, so every chunk encodes first
        t0 = monotonic_s()
        encoded = [_encode(i) for i in range(n)]
        stats["encode_s"] = stats.get("encode_s", 0.0) + (
            monotonic_s() - t0)
        t0 = monotonic_s()
        devs = [_put(encoded[i], i) for i in range(n)]
        del encoded
        copier.wait_copies()
        stats["h2d_s"] = stats.get("h2d_s", 0.0) + (monotonic_s() - t0)
        t0 = monotonic_s()
        carry = init_carry()
        for i in range(n):
            carry = _dispatch(carry, devs[i], i)
            if not retain:
                devs[i] = None
        result = finalize(carry, tuple(devs)) if retain else carry
        copier.wait_compute()
        stats["device_s"] = stats.get("device_s", 0.0) + (
            monotonic_s() - t0)
        _release_retained()
        return result

    # overlapped: copies drain on the copy stream while earlier chunks'
    # compute runs on the compute stream
    window = n if lookahead <= 0 else lookahead
    devs: dict = {}
    put_idx = 0
    carry = init_carry()
    probe = None
    start = 0
    rec = trainwatch.active_recorder()
    if rec is not None and lookahead > 0 and n >= 3:
        # the overlap probe of a recorded run: chunk 0 runs serialized
        # (extra waits only, the same math) to sample its transfer and
        # compute costs; the other chunks run overlapped under a wall
        # clock, and the serialized pair scales by shipped bytes
        host0 = _encode(0)
        bytes0 = _tree_nbytes(host0)
        t0 = monotonic_s()
        devs[0] = _put(host0, 0)
        copier.wait_copies()
        h2d_s0 = monotonic_s() - t0
        t0 = monotonic_s()
        carry = _dispatch(carry, devs[0], 0)
        copier.wait_compute(0)
        device_s0 = monotonic_s() - t0
        if not retain:
            del devs[0]
        put_idx = start = 1
        probe = (bytes0, h2d_s0, device_s0, monotonic_s())
    for i in range(start, n):
        while put_idx < min(n, i + window):
            devs[put_idx] = _put(_encode(put_idx), put_idx)
            put_idx += 1
        carry = _dispatch(carry, devs[i], i)
        if not retain:
            del devs[i]
        if lookahead > 0 and i - lookahead >= 0:
            # bound device residency: chunk i-lookahead's compute is done
            # before chunk i+lookahead ships; the next chunks are already
            # queued, so the device does not starve while the host waits
            copier.wait_compute(i - lookahead)
    if probe is not None:
        copier.wait_compute()
        bytes0, h2d_s0, device_s0, t_rest = probe
        wall_rest = monotonic_s() - t_rest
        bytes_rest = shipped[0] - bytes0
        if bytes0 > 0 and bytes_rest > 0:
            scale = bytes_rest / bytes0
            rec.set_overlap(record_overlap_ratio(
                h2d_s0 * scale, device_s0 * scale, wall_rest))
    result = (finalize(carry, tuple(devs[i] for i in range(n))) if retain
              else carry)
    _release_retained()
    return result


def record_overlap_ratio(h2d_s: float, device_s: float,
                         wall_s: float) -> float:
    """Overlap achieved by a (profiled, overlapped) run pair: the fraction
    of the smaller phase hidden inside the larger one, ``(h2d_s +
    device_s - wall_s) / min(h2d_s, device_s)`` clamped to [0, 1].
    Publishes ``pio_tpu_train_stream_overlap_ratio``."""
    lo = min(h2d_s, device_s)
    ratio = 0.0 if lo <= 0 else max(
        0.0, min(1.0, (h2d_s + device_s - wall_s) / lo)
    )
    _OVERLAP.set(ratio)
    return ratio
