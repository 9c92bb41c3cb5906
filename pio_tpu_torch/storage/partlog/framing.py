"""PEL2 record framing for the partitioned log — pure Python.

Same wire layout as the native event-log backend
(``pio_tpu_torch/native/event_log.cpp`` / ``eventlog._encode_record``):
``<u32 len><payload><u32 crc32(payload)>``, little-endian. The crc is
what lets a reader tell "plausible-length garbage at the tail" (a torn
write — the wound a crash mid-append leaves) from committed data.

Classification contract, shared with the native repair pass:

- a bad or incomplete region that extends to END OF FILE is a torn
  tail — expected after a crash; :func:`repair` truncates it (loudly);
- a bad crc FOLLOWED BY more bytes is mid-file corruption — bits rotted
  or someone edited the log; that is never silently healed, it raises
  :class:`~pio_tpu_torch.storage.base.StorageError`.

The replication stream is a concatenation of these frames, so the same
verifier measures a follower's longest verified prefix during failover
election (``partlog/failover.py``).
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import List, Tuple

from pio_tpu_torch.storage import base

log = logging.getLogger("pio_tpu_torch.partlog")

_LEN = struct.Struct("<I")  # pio: frame=pel2-record
#: per-frame overhead: 4-byte length prefix + 4-byte crc trailer
OVERHEAD = 8


def frame(payload: bytes) -> bytes:
    """Frame one record: length prefix + payload + crc32 trailer."""
    return (
        _LEN.pack(len(payload))
        + payload
        + _LEN.pack(zlib.crc32(payload) & 0xFFFFFFFF)
    )


def scan(data: bytes, *, origin: str = "<buf>") -> Tuple[List[bytes], int, int]:
    """Walk framed records in ``data``.

    Returns ``(payloads, verified_end, total)`` where ``verified_end`` is
    the byte offset after the last intact frame; ``verified_end < total``
    means a torn tail follows. Raises :class:`StorageError` when a bad
    frame is followed by more bytes (mid-file corruption, never healed).
    """
    payloads: List[bytes] = []
    off, total = 0, len(data)
    while off < total:
        if off + 4 > total:
            break  # torn: incomplete length prefix at EOF
        (plen,) = _LEN.unpack_from(data, off)
        end = off + 4 + plen + 4
        if end > total:
            break  # torn: frame extends past EOF
        payload = data[off + 4 : off + 4 + plen]
        (crc,) = _LEN.unpack_from(data, off + 4 + plen)
        if crc != (zlib.crc32(payload) & 0xFFFFFFFF):
            if end == total:
                break  # bad region reaches EOF: torn tail
            raise base.StorageError(
                f"corrupt partitioned log: crc mismatch at byte {off} "
                f"of {origin} (bad frame is followed by "
                f"{total - end} more bytes — not a torn tail)"
            )
        payloads.append(payload)
        off = end
    return payloads, off, total


def verified_prefix(path: str) -> int:
    """Byte length of the longest verified frame prefix of ``path``
    (0 for a missing file). The failover-election measure."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return 0
    verified, _, _ = _verified(data, path)
    return verified


def _verified(data: bytes, origin: str) -> Tuple[int, int, List[bytes]]:
    payloads, verified, total = scan(data, origin=origin)
    return verified, total, payloads


def repair(path: str) -> int:
    """Truncate a torn tail off ``path``; returns bytes dropped (0 when
    intact or missing). Loud: every truncation logs a warning with the
    offsets — silent data-dropping is how replicas drift apart. Mid-file
    corruption still raises (see module docstring)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return 0
    verified, total, _ = _verified(data, path)
    dropped = total - verified
    if dropped <= 0:
        return 0
    log.warning(
        "partlog: truncating torn tail of %s: %d bytes dropped "
        "(verified prefix %d of %d)", path, dropped, verified, total,
    )
    with open(path, "r+b") as f:
        f.truncate(verified)
        f.flush()
        os.fsync(f.fileno())
    return dropped
