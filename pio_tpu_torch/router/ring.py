"""Entity-affine replica ring: partition slots + rendezvous hashing.

The port's copy of ``pio_tpu/router/ring.py`` (the port imports nothing of
``pio_tpu``).

Two placement functions, composed:

- **Partition affinity** mirrors the partlog event path: partlog appends
  an event for entity ``e`` to partition ``crc32(e) % N``
  (the reference's ``pio_tpu/storage/partlog/partitioned.py`` ``partition_of``).  When the
  ring is configured with ``partitions == len(members)``, serving
  member ``sorted(members)[slot]`` owns the same keyspace as partlog
  partition ``slot`` — a user's events and their serving replica
  co-locate, so follower reads and model lookups for one entity hit one
  host.
- **Rendezvous (HRW) ranking** orders the *other* replicas for a key,
  and takes over entirely when the member set does not match the
  partition count (scale-out, degraded fleet, partitions unset).  HRW
  gives the churn property the router needs: removing a member remaps
  only the keys that member owned, adding one back steals only its own
  keyspace — no mass reshuffle on failover.

The composition keeps both properties: while every configured member is
routable the primary is the partition slot owner (co-location); when a
member dies only its slot's keys fall through to their HRW order over
the survivors, every other key keeps its primary.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["Ring", "hrw_score", "slot_of"]


def slot_of(entity_id: str, partitions: int) -> int:
    """Partition slot for an entity id — byte-for-byte the partlog
    mapping (``crc32(utf8) % N``), so slot ``p`` here and partition
    ``p`` there name the same keyspace."""
    return zlib.crc32(entity_id.encode("utf-8")) % partitions


def hrw_score(member: str, key: str) -> int:
    """Stable rendezvous weight of ``member`` for ``key``.

    blake2b over ``member NUL key`` so the score survives process
    restarts and differing PYTHONHASHSEEDs (hash() would not); 8 bytes
    keeps collisions negligible while staying a cheap int compare.
    """
    h = hashlib.blake2b(digest_size=8)
    h.update(member.encode("utf-8"))
    h.update(b"\x00")
    h.update(key.encode("utf-8"))
    return int.from_bytes(h.digest(), "big")


class Ring:
    """Replica ranking over a configured member set.

    ``members`` is the *configured* fleet (sorted internally — slot
    assignment must agree across router restarts); per-call ``routable``
    narrows to the members currently able to take traffic.
    """

    def __init__(
        self,
        members: Iterable[str],
        partitions: Optional[int] = None,
    ):
        self._all: Sequence[str] = tuple(sorted(set(members)))
        if partitions is not None and partitions <= 0:
            raise ValueError(f"partitions must be positive, got {partitions}")
        self._partitions = partitions

    @property
    def members(self) -> Sequence[str]:
        return self._all

    @property
    def partitions(self) -> Optional[int]:
        return self._partitions

    def slot_owner(self, entity_id: str) -> Optional[str]:
        """The partition-affine owner, regardless of liveness — None
        when affinity is off (partitions unset or fleet size differs,
        where slots and partitions would name different keyspaces)."""
        if self._partitions is None or len(self._all) != self._partitions:
            return None
        return self._all[slot_of(entity_id, self._partitions)]

    def rank(
        self,
        key: str,
        routable: Optional[Iterable[str]] = None,
    ) -> List[str]:
        """Replica order for ``key``: try ``[0]`` first, retry down the
        list.  Restricted to ``routable`` members when given."""
        if routable is None:
            live = list(self._all)
        else:
            allowed = set(routable)
            live = [m for m in self._all if m in allowed]
        if not live:
            return []
        order = sorted(
            live, key=lambda m: (hrw_score(m, key), m), reverse=True
        )
        owner = self.slot_owner(key)
        if owner is not None and owner in order and order[0] != owner:
            order.remove(owner)
            order.insert(0, owner)
        return order

    def keyspace(
        self,
        keys: Iterable[str],
        routable: Optional[Iterable[str]] = None,
    ) -> Dict[str, str]:
        """key -> primary member, for a sample of keys (tests, and the
        ``/router.json`` remap preview)."""
        out: Dict[str, str] = {}
        for k in keys:
            order = self.rank(k, routable)
            if order:
                out[k] = order[0]
        return out
