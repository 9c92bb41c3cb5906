"""Graceful degradation: a size-bounded LRU of recent query→response

The port's copy of ``pio_tpu/qos/degrade.py`` (the port imports nothing of
``pio_tpu``).
pairs. When the breaker is open or admission shedding kicks in, a query
the server answered recently gets that stale answer back — explicitly
marked ``X-Pio-Degraded: stale-cache`` — instead of a hard 429/503. A
slightly old recommendation beats an error page; the marker keeps the
client honest about what it received.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Optional

#: response header marking a degraded (stale) answer
DEGRADED_HEADER = "X-Pio-Degraded"
DEGRADED_VALUE = "stale-cache"


def cache_key(query: Any) -> str:
    """Canonical key for a parsed query body (sorted-key JSON, so
    ``{"user": "u1", "num": 3}`` and ``{"num": 3, "user": "u1"}`` hit
    the same entry)."""
    try:
        return json.dumps(query, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return repr(query)


class StaleCache:
    """Thread-safe LRU: ``capacity`` most-recently-touched entries."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._d: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    # pio: endpoint=/qos.json
    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._d),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
            }
