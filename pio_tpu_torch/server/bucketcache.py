"""Shape-bucket execution cache for the serving hot path.

The port's copy of ``pio_tpu/server/bucketcache.py`` (the port imports
nothing of ``pio_tpu``). Batches are padded up to a small, fixed set of
bucket sizes (default 1/2/4/8/16/32, ``PIO_TPU_BATCH_BUCKETS``), each
bucket is dispatched once by a warmup sweep at deploy and hot swap, and
the hot path only ever dispatches bucket-shaped batches. Oversized
batches chunk into max-bucket pieces.

On CUDA there is no per-shape compile, but a bucket's first dispatch
still pays one-off costs: the caching allocator's first blocks, cuBLAS's
first call at a shape, and the resident scorer's per-bucket output
tensor. So the accounting is the reference's, unchanged: ``warmed``,
``retraces`` (a dispatch into a bucket the current generation had not
warmed), ``evictions`` and ``generation``, "fresh" meaning the first
dispatch into a bucket in this generation. The cache holds no
executables; it owns the policy and the accounting.

Hot-swap semantics: a ``/reload`` warms the new model's buckets before
the swap is visible, then :meth:`BucketExecutionCache.install` replaces
the warmed set at once, evicting the old generation's entries.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

from pio_tpu_torch.analysis.runtime import make_lock
from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.bucketcache")

#: default bucket ladder: powers of two up to the micro-batcher's
#: practical occupancy
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def buckets_from_env(env: str = "PIO_TPU_BATCH_BUCKETS") -> Tuple[int, ...]:
    """Bucket ladder from the environment: a comma-separated list of
    positive ints (``"1,4,16"``). Malformed values fall back to the
    default with a warning — a typo'd ladder must degrade, not take the
    server down at boot."""
    raw = knobs.knob_str(env)
    if not raw.strip():
        return DEFAULT_BUCKETS
    try:
        vals = sorted({int(tok) for tok in raw.split(",") if tok.strip()})
        if not vals or any(v < 1 for v in vals):
            raise ValueError(raw)
        return tuple(vals)
    except ValueError:
        log.warning(
            "malformed %s=%r; using default buckets %s",
            env, raw, DEFAULT_BUCKETS,
        )
        return DEFAULT_BUCKETS


class BucketExecutionCache:
    """Bucket policy + warmed-generation bookkeeping for one engine.

    Thread-safe: the warmed set is read on every dispatch (hot path) and
    replaced wholesale on hot-swap; a lock guards the mutations, reads
    go through an immutable frozenset snapshot.
    """

    def __init__(self, buckets: Optional[Sequence[int]] = None):
        self.buckets: Tuple[int, ...] = (
            tuple(sorted(set(buckets))) if buckets else buckets_from_env()
        )
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"bucket sizes must be >= 1: {self.buckets}")
        self.max_bucket = self.buckets[-1]
        self._lock = make_lock("query.bucket_cache")
        #: buckets the CURRENT model generation has dispatched once
        self._warmed: frozenset = frozenset()
        self.generation = 0
        self.evictions = 0
        self.retraces = 0

    # -- policy ------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (chunk-sized inputs; n > max never
        reaches here — see :meth:`chunks`)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_bucket

    def chunks(self, n: int) -> List[int]:
        """Split a batch of ``n`` into max-bucket-sized chunk lengths."""
        out = []
        while n > self.max_bucket:
            out.append(self.max_bucket)
            n -= self.max_bucket
        if n:
            out.append(n)
        return out

    def pad(self, queries: list) -> Tuple[list, int]:
        """Pad a chunk (len <= max bucket) up to its bucket by
        replicating the last query: the padding rows are computed with
        the real ones and their results sliced off. Returns
        ``(padded, bucket)``."""
        b = self.bucket_for(len(queries))
        if len(queries) == b:
            return queries, b
        return queries + [queries[-1]] * (b - len(queries)), b

    # -- warm/evict lifecycle ---------------------------------------------
    def note_dispatch(self, bucket: int) -> bool:
        """Record a hot-path dispatch into ``bucket``. Returns True when
        the bucket was NOT warmed for the current generation — a retrace:
        the dispatch is paying the one-off costs the warmup sweep should
        have absorbed. The bucket is marked warmed so each shape retraces at
        most once per generation."""
        if bucket in self._warmed:
            return False
        with self._lock:
            if bucket in self._warmed:
                return False
            self._warmed = self._warmed | {bucket}
            self.retraces += 1
        return True

    def install(self, warmed: Sequence[int]) -> int:
        """Atomically swap in a new generation's warmed set (hot-swap
        eviction: whatever the old generation had warmed is dead; the
        new model's weights and buffers own the buckets now).
        Returns the new generation number so callers that co-version
        other per-generation state (device-resident scorers) can stamp
        it."""
        with self._lock:
            if self._warmed:
                self.evictions += len(self._warmed)
            self._warmed = frozenset(warmed)
            self.generation += 1
            return self.generation

    @property
    def warmed(self) -> frozenset:
        return self._warmed

    def to_dict(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "warmed": sorted(self._warmed),
            "generation": self.generation,
            "retraces": self.retraces,
            "evictions": self.evictions,
        }


def dispatch_bucketed(
    cache: BucketExecutionCache,
    queries: list,
    run_batch: Callable[[list], list],
    on_dispatch: Optional[Callable[[int, int, bool], None]] = None,
) -> Tuple[list, bool]:
    """Serve ``queries`` through bucket-shaped ``run_batch`` calls.

    Chunks to the max bucket, pads each chunk to its bucket, slices the
    padding rows back off, and reports ``(results, fresh)`` where
    ``fresh`` is True when ANY chunk hit a cold bucket (the caller,
    the micro-batcher's probe, discards such samples as one-off
    transients). ``on_dispatch(n, bucket, fresh)`` fires per chunk for
    metric accounting.
    """
    results: list = []
    fresh_any = False
    pos = 0
    for n in cache.chunks(len(queries)):
        chunk = queries[pos:pos + n]
        pos += n
        padded, bucket = cache.pad(chunk)
        fresh = cache.note_dispatch(bucket)
        fresh_any = fresh_any or fresh
        got = run_batch(padded)
        results.extend(got[:n])
        if on_dispatch is not None:
            on_dispatch(n, bucket, fresh)
    return results, fresh_any
