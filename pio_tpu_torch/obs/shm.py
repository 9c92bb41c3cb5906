"""Fixed-layout mmapped metrics segment for SO_REUSEPORT pool serving.

The port's copy of ``pio_tpu/obs/shm.py`` (the port imports nothing of
``pio_tpu``).

Problem: each pool worker is its own process, so a Prometheus scrape
(kernel-balanced to ONE listener) used to see one worker's shard of the
counters — silently underreporting QPS by the worker count.

Solution: the pool supervisor creates one small file of fixed layout;
every worker mmaps it and mirrors its counter/histogram-bucket cells
into its OWN per-worker stripe (single writer per stripe — no cross-
process locking needed; float64 slot writes are naturally aligned).
Reading a pool-wide total sums the slot across stripes. Works with the
``spawn`` multiprocessing context because workers reopen by path.

Layout (little-endian)::

    0   8s  magic  b"PIOMETR2"
    8   I   n_workers
    12  I   slots_per_worker
    16  16x reserved
    32  n_workers generation float64 (stripe ownership, see below)
    32+8*n_workers   n_workers stripes of slots_per_worker float64 each

Stripe generations: a respawned worker *adopts* its
predecessor's stripe (counters keep their totals), which is correct for
pool-wide sums but invisible to an external aggregator — a counter that
jumps mid-scrape could be traffic or could be adoption. The supervisor
owns the generation word: ``set_generation`` to ``1`` at first spawn,
``bump_generation`` on every respawn, and ``retire`` (negates the
value) when a worker's respawn budget is spent and its stripe is frozen
at its last totals. Workers export their stripe's generation as the
``pio_tpu_pool_stripe_generation`` gauge, so a scraper that sees the
generation move knows any counter discontinuity is adoption, not load —
and a negative generation marks a retired stripe whose (retained, still
summed) totals will never move again.

Torn reads are possible in theory (a reader may catch a stripe between
two writes of one histogram observe) — acceptable for monitoring: every
individual slot is written atomically, so counters are never garbage,
and bucket counts lag each other by at most one in-flight observation.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import List

MAGIC = b"PIOMETR2"
HEADER_BYTES = 32
#: default stripe width — the query server's pool-bound families
#: (request/error counters + stage histogram cells + latency histogram
#: + the shape-bucket dispatch/retrace + batch-lane counters) need
#: ~150 slots; 384 leaves headroom for growth
DEFAULT_SLOTS = 384


class PoolMetricsSegment:
    """One mmapped metrics file; create in the supervisor, open in
    every worker (and in the supervisor for debugging)."""

    def __init__(self, path: str, n_workers: int, slots_per_worker: int,
                 _file=None, _map=None):
        self.path = path
        self.n_workers = n_workers
        self.slots_per_worker = slots_per_worker
        self._f = _file
        self._m = _map

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, path: str, n_workers: int,
               slots_per_worker: int = DEFAULT_SLOTS) -> "PoolMetricsSegment":
        if n_workers < 1 or slots_per_worker < 1:
            raise ValueError("n_workers and slots_per_worker must be >= 1")
        size = cls._size(n_workers, slots_per_worker)
        with open(path, "wb") as f:
            f.write(MAGIC)
            # pio: frame=metrics-header
            f.write(struct.pack("<II", n_workers, slots_per_worker))
            f.write(b"\0" * (size - 16))
        return cls.open(path)

    @classmethod
    def open(cls, path: str) -> "PoolMetricsSegment":
        f = open(path, "r+b")
        try:
            head = f.read(HEADER_BYTES)
            if len(head) < HEADER_BYTES or head[:8] != MAGIC:
                raise ValueError(f"{path}: not a pool metrics segment")
            # pio: frame=metrics-header
            n_workers, slots = struct.unpack_from("<II", head, 8)
            m = mmap.mmap(f.fileno(), cls._size(n_workers, slots))
        except BaseException:
            f.close()
            raise
        return cls(path, n_workers, slots, _file=f, _map=m)

    @staticmethod
    def _size(n_workers: int, slots_per_worker: int) -> int:
        return HEADER_BYTES + n_workers * 8 + n_workers * slots_per_worker * 8

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

    # -- stripe generations ------------------------------------------------
    def _gen_off(self, worker_idx: int) -> int:
        if not (0 <= worker_idx < self.n_workers):
            raise IndexError(f"worker {worker_idx} of {self.n_workers}")
        return HEADER_BYTES + worker_idx * 8

    def generation(self, worker_idx: int) -> int:
        """0 = never owned; N>0 = owned, adopted N-1 times; -N = stripe
        retired at generation N (frozen totals, still summed)."""
        # pio: frame=metrics-stripe
        return int(struct.unpack_from(
            "<d", self._m, self._gen_off(worker_idx)
        )[0])

    def set_generation(self, worker_idx: int, gen: int) -> None:
        # pio: frame=metrics-stripe
        struct.pack_into(
            "<d", self._m, self._gen_off(worker_idx), float(gen)
        )

    def bump_generation(self, worker_idx: int) -> int:
        """Supervisor-side: the stripe is about to be adopted by a
        replacement process. Returns the new generation."""
        gen = abs(self.generation(worker_idx)) + 1
        self.set_generation(worker_idx, gen)
        return gen

    def retire_stripe(self, worker_idx: int) -> int:
        """Supervisor-side: the worker is permanently retired; negate
        the generation so scrapers know the stripe's totals are frozen
        (retained in sums — retirement must not shrink pool counters)."""
        gen = -abs(self.generation(worker_idx))
        self.set_generation(worker_idx, gen)
        return gen

    def generations(self) -> List[int]:
        return [self.generation(w) for w in range(self.n_workers)]

    # -- slots -------------------------------------------------------------
    def _off(self, worker_idx: int, slot: int) -> int:
        if not (0 <= worker_idx < self.n_workers):
            raise IndexError(f"worker {worker_idx} of {self.n_workers}")
        if not (0 <= slot < self.slots_per_worker):
            raise IndexError(f"slot {slot} of {self.slots_per_worker}")
        return (HEADER_BYTES + self.n_workers * 8
                + (worker_idx * self.slots_per_worker + slot) * 8)

    def set(self, worker_idx: int, slot: int, v: float) -> None:
        struct.pack_into("<d", self._m, self._off(worker_idx, slot), v)  # pio: frame=metrics-stripe

    def read(self, worker_idx: int, slot: int) -> float:
        # pio: frame=metrics-stripe
        return struct.unpack_from("<d", self._m, self._off(worker_idx, slot))[0]

    def sum_slot(self, slot: int) -> float:
        """Pool-wide total: the slot summed over every worker stripe."""
        return sum(self.read(w, slot) for w in range(self.n_workers))

    def read_all(self, slot: int) -> List[float]:
        return [self.read(w, slot) for w in range(self.n_workers)]
