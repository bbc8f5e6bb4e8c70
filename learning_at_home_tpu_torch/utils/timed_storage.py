"""Expiring key-value storage — the failure-detection primitive.

The port's copy of ``learning_at_home_tpu/utils/timed_storage.py``.
In the reference, DHT values carry expiration timestamps and expired values
are simply ignored on read; since servers periodically re-declare their
experts, *record expiry IS the failure detector*.  This
module provides that primitive: a dict whose entries vanish at their
expiration time, used by both the DHT node's local store and its cache.
"""

from __future__ import annotations

import heapq
import time
from typing import Generic, Hashable, Iterator, Optional, TypeVar

KeyType = TypeVar("KeyType", bound=Hashable)
ValueType = TypeVar("ValueType")

DHTExpiration = float


# Clock seam: every consumer does ``from ... import get_dht_time``, so
# patching get_dht_time itself would miss them.  The function stays put
# and a simulated clock swaps the source underneath.
_time_source = time.time


def get_dht_time() -> DHTExpiration:
    """Wall-clock used for all expirations.

    The swarm assumes loosely NTP-synchronized hosts, same as the reference;
    tests that need determinism monkeypatch ``_time_source``.
    """
    return _time_source()


class TimedStorage(Generic[KeyType, ValueType]):
    """Dict with per-entry expiration; newer expirations win on re-store."""

    def __init__(self, maxsize: Optional[int] = None):
        self._data: dict[KeyType, tuple[ValueType, DHTExpiration]] = {}
        self._heap: list[tuple[DHTExpiration, KeyType]] = []
        self.maxsize = maxsize

    def store(self, key: KeyType, value: ValueType, expiration: DHTExpiration) -> bool:
        """Store unless an entry with a later expiration already exists."""
        if expiration <= get_dht_time():
            return False
        current = self._data.get(key)
        if current is not None and current[1] >= expiration:
            return False
        self._data[key] = (value, expiration)
        heapq.heappush(self._heap, (expiration, key))
        self._evict()
        return key in self._data  # False if eviction dropped the new entry

    def get(self, key: KeyType) -> Optional[tuple[ValueType, DHTExpiration]]:
        """Return (value, expiration) if present and fresh, else None."""
        entry = self._data.get(key)
        if entry is None or entry[1] <= get_dht_time():
            return None
        return entry

    def remove_outdated(self) -> None:
        now = get_dht_time()
        while self._heap and self._heap[0][0] <= now:
            expiration, key = heapq.heappop(self._heap)
            entry = self._data.get(key)
            if entry is not None and entry[1] <= now:
                del self._data[key]

    def _evict(self) -> None:
        if self.maxsize is None:
            return
        self.remove_outdated()
        while len(self._data) > self.maxsize and self._heap:
            expiration, key = heapq.heappop(self._heap)
            entry = self._data.get(key)
            if entry is not None and entry[1] == expiration:
                del self._data[key]

    def items(self) -> Iterator[tuple[KeyType, ValueType, DHTExpiration]]:
        now = get_dht_time()
        return ((k, v, e) for k, (v, e) in self._data.items() if e > now)

    def __contains__(self, key: KeyType) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        self.remove_outdated()
        return len(self._data)

    def top(self) -> Optional[tuple[KeyType, ValueType, DHTExpiration]]:
        """Entry with the soonest expiration (fresh entries only)."""
        self.remove_outdated()
        while self._heap:
            expiration, key = self._heap[0]
            entry = self._data.get(key)
            if entry is not None and entry[1] == expiration:
                return key, entry[0], expiration
            heapq.heappop(self._heap)
        return None
