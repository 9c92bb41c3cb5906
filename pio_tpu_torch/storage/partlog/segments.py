"""Per-partition segment chain: append-only files with CRC framing.

One partition of the partitioned event log is a directory of segment
files (``p003/seg-00000001.log``, ``seg-00000002.log``, …). The
partition is ONE logical byte stream — the concatenation of its
segments in index order — and every position in the replication
protocol, follower handshake and failover election is an offset into
that stream. Segments exist so sealing can hand replication and
compaction immutable units without copying the active file.

Crash discipline (same contract as the native event log):

- the LAST segment may carry a torn tail after a crash; it is repaired
  (truncated, loudly) on open and before the first append after a
  failed write;
- sealed segments are never torn by construction (sealed after a
  clean flush) — a bad crc inside one is corruption and raises.
"""

from __future__ import annotations

import os
import re
import threading
from typing import List, Optional, Tuple

from pio_tpu_torch.utils import knobs
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs import REGISTRY
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.durability import IntervalSyncer, fsync_fileobj
from pio_tpu_torch.storage.partlog import framing

#: active segment seals once it reaches this many bytes (the blob that
#: crosses the line still lands whole — records never split segments)
SEGMENT_BYTES_VAR = "PIO_TPU_PARTLOG_SEGMENT_BYTES"
DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024

_SEG_RE = re.compile(r"^seg-(\d{8})\.log$")

_APPENDS = REGISTRY.counter(
    "pio_tpu_partlog_appends_total",
    "Record-batch appends per partition of the partitioned event log",
    ("partition",),
)
_SEALED = REGISTRY.counter(
    "pio_tpu_partlog_segments_sealed_total",
    "Segments sealed (rolled over) per partition",
    ("partition",),
)


class SegmentLog:
    """One partition's segment chain; thread-safe."""

    def __init__(self, pdir: str, *, partition: int,
                 syncer: Optional[IntervalSyncer] = None,
                 seg_bytes: Optional[int] = None):
        self.pdir = pdir
        self.partition = partition
        self._label = str(partition)
        self._syncer = syncer or IntervalSyncer()
        self._seg_bytes = (
            seg_bytes if seg_bytes is not None
            else knobs.knob_int(SEGMENT_BYTES_VAR)
        )
        self._lock = threading.RLock()
        os.makedirs(pdir, exist_ok=True)
        #: [(path, committed bytes)] in stream order; on-disk files may be
        #: longer than the recorded size while a torn tail awaits repair —
        #: reads always cap at the recorded (verified) size
        self._segs: List[Tuple[str, int]] = []
        self._fh = None
        self._needs_repair = False
        names = sorted(
            n for n in os.listdir(pdir) if _SEG_RE.match(n)
        )
        for i, name in enumerate(names):
            path = os.path.join(pdir, name)
            if i == len(names) - 1:
                framing.repair(path)  # crash may have torn the last one
            self._segs.append((path, os.path.getsize(path)))
        if not self._segs:
            self._segs.append((self._seg_path(1), 0))

    def _seg_path(self, index: int) -> str:
        return os.path.join(self.pdir, f"seg-{index:08d}.log")

    # -- positions -----------------------------------------------------------
    @property
    def committed(self) -> int:
        """Committed (verified, replicable) length of the stream."""
        with self._lock:
            return sum(size for _, size in self._segs)

    def segments(self) -> List[dict]:
        """Topology view: one dict per segment."""
        with self._lock:
            out, base_off = [], 0
            for path, size in self._segs:
                out.append({
                    "file": os.path.basename(path),
                    "start": base_off,
                    "bytes": size,
                })
                base_off += size
            return out

    # -- append --------------------------------------------------------------
    def append(self, data: bytes) -> Tuple[int, int]:
        """Append framed bytes; returns ``(start, end)`` stream offsets.

        A failed append (torn-write injection, ENOSPC) may leave a torn
        tail on disk past the committed size; the next append repairs it
        first, so new records never land behind unreachable bytes."""
        with self._lock:
            if self._needs_repair:
                self._close_fh()
                path, size = self._segs[-1]
                # torn-tail repair must finish before any append runs,
                # so its fsync deliberately holds the segment lock
                framing.repair(path)  # pio: disable=lock-blocking-call
                if os.path.getsize(path) != size:
                    raise base.StorageError(
                        f"partlog segment {path} lost committed bytes "
                        f"({os.path.getsize(path)} != {size})"
                    )
                self._needs_repair = False
            path, size = self._segs[-1]
            if self._fh is None:
                self._fh = open(path, "ab")
            # fault injection only sleeps when a latency rule is armed
            # (tests); the production path returns immediately
            # pio: disable=lock-blocking-call
            torn = failpoint("partlog.append.before_write", data)
            if torn is not None:
                # injected torn write: persist a strict prefix and fail —
                # the wound a crash mid-append leaves, which the repair
                # pass above must heal before the next append
                self._fh.write(torn)
                self._fh.flush()
                self._needs_repair = True
                raise base.StorageError(
                    f"partlog append failed for partition "
                    f"{self.partition} (injected torn write)"
                )
            try:
                self._fh.write(data)
                self._fh.flush()
            except OSError as e:
                self._needs_repair = True
                raise base.StorageError(
                    f"partlog append failed for partition "
                    f"{self.partition}: {e}"
                )
            if self._syncer.due(path):
                os.fsync(self._fh.fileno())
                self._syncer.mark(path)
            start = self.committed
            new_size = size + len(data)
            self._segs[-1] = (path, new_size)
            end = start + len(data)
            _APPENDS.inc(partition=self._label)
            if new_size >= self._seg_bytes:
                # rollover seals + fsyncs under the lock on purpose:
                # the next append must land in the new segment
                self._seal()  # pio: disable=lock-blocking-call
            return start, end

    def _seal(self) -> None:
        """Roll the active segment: sync it, open the next index."""
        fsync_fileobj(self._fh)  # sealed segments are never torn
        self._close_fh()
        failpoint("partlog.seal")
        index = len(self._segs) + 1
        # index collisions impossible: segment files are never deleted
        # out from under a live handle (compaction writes snapshots
        # beside the chain, it does not rewrite it)
        self._segs.append((self._seg_path(index), 0))
        _SEALED.inc(partition=self._label)

    def _close_fh(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None

    def sync(self) -> None:
        """Force-fsync the active segment (commit-durability flush)."""
        with self._lock:
            if self._fh is not None:
                # the durability flush IS the serialization point —
                # appends must not race the fsync of their own bytes
                # pio: disable=lock-blocking-call
                fsync_fileobj(self._fh)

    # -- reads ---------------------------------------------------------------
    def read_range(self, start: int, end: int) -> bytes:
        """Committed bytes ``[start, end)`` of the logical stream (the
        replication catch-up read). ``end`` is clamped to committed."""
        chunks: List[bytes] = []
        with self._lock:
            end = min(end, self.committed)
            base_off = 0
            for path, size in self._segs:
                seg_end = base_off + size
                if seg_end > start and base_off < end:
                    lo = max(start, base_off) - base_off
                    hi = min(end, seg_end) - base_off
                    with open(path, "rb") as f:
                        f.seek(lo)
                        chunks.append(f.read(hi - lo))
                base_off = seg_end
                if base_off >= end:
                    break
        return b"".join(chunks)

    def payloads(self) -> List[bytes]:
        """Every committed record payload, in stream order. Raises on
        mid-file corruption (a sealed segment with a bad crc)."""
        out: List[bytes] = []
        with self._lock:
            segs = list(self._segs)
        for path, size in segs:
            if size == 0:
                continue
            with open(path, "rb") as f:
                data = f.read(size)
            payloads, verified, total = framing.scan(data, origin=path)
            if verified != total:
                # committed bytes must verify — a short tail here means
                # the file lost data after we recorded the size
                raise base.StorageError(
                    f"corrupt partlog segment {path}: committed bytes "
                    f"fail crc verification at offset {verified}"
                )
            out.extend(payloads)
        return out

    def close(self) -> None:
        with self._lock:
            self._close_fh()
