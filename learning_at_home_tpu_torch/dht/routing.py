"""Kademlia identifier arithmetic and the k-bucket routing table.

The port's copy of ``learning_at_home_tpu/dht/routing.py`` (sha1 ids,
bit for bit the JAX package's).  Contract from the reference's
``hivemind/dht/routing.py``: 160-bit node IDs, XOR metric,
k-buckets covering power-of-two distance ranges, LRU-ish bucket
maintenance.  Pure data structures — no IO — so they are unit-testable
exactly like the reference's routing tests.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Iterable, Optional

Endpoint = tuple[str, int]

ID_BITS = 160

# Clock seam: bucket freshness (last_updated / last_heard) reads time
# through here so a simulated clock can virtualize it.
_monotonic = time.monotonic

# Entropy seam: ID generation and bucket-refresh targets draw bytes
# through here so the macro-sim can substitute a seeded source — the
# refresh target choice steers which peers a lookup visits, so OS
# entropy here would make whole-swarm runs non-reproducible.
_urandom = os.urandom


class DHTID(int):
    """160-bit Kademlia identifier with XOR distance."""

    MIN, MAX = 0, 2**ID_BITS - 1

    @classmethod
    def generate(cls) -> "DHTID":
        return cls(int.from_bytes(_urandom(ID_BITS // 8), "big"))

    @classmethod
    def from_key(cls, key: bytes | str) -> "DHTID":
        if isinstance(key, str):
            key = key.encode()
        return cls(int.from_bytes(hashlib.sha1(key).digest(), "big"))

    def xor_distance(self, other: int) -> int:
        return int(self) ^ int(other)

    def to_bytes(self) -> bytes:  # type: ignore[override]
        return int(self).to_bytes(ID_BITS // 8, "big")

    @classmethod
    def from_bytes(cls, data: bytes) -> "DHTID":  # type: ignore[override]
        return cls(int.from_bytes(data, "big"))


class KBucket:
    """Up to k peers whose IDs fall in [lower, upper); LRU order (oldest
    first).  New peers beyond capacity go to a replacement list and promote
    when a main-slot peer is evicted as unresponsive."""

    def __init__(self, lower: int, upper: int, k: int):
        self.lower, self.upper, self.k = lower, upper, k
        self.peers: dict[DHTID, Endpoint] = {}  # insertion-ordered = LRU
        self.replacement: dict[DHTID, Endpoint] = {}
        self.last_updated = _monotonic()

    def covers(self, node_id: int) -> bool:
        return self.lower <= node_id < self.upper

    def add_or_update(self, node_id: DHTID, endpoint: Endpoint) -> bool:
        """True if stored in the main slots, False if parked as replacement."""
        self.last_updated = _monotonic()  # live traffic = bucket not idle
        if node_id in self.peers:
            del self.peers[node_id]  # refresh LRU position
            self.peers[node_id] = endpoint
            return True
        if len(self.peers) < self.k:
            self.peers[node_id] = endpoint
            return True
        self.replacement.pop(node_id, None)
        self.replacement[node_id] = endpoint
        if len(self.replacement) > self.k:
            del self.replacement[next(iter(self.replacement))]
        return False

    def remove(self, node_id: DHTID) -> None:
        was_main = self.peers.pop(node_id, None) is not None
        self.replacement.pop(node_id, None)  # a dead node must not be promoted
        if was_main and self.replacement:
            rid = next(iter(self.replacement))
            self.peers[rid] = self.replacement.pop(rid)

    @property
    def oldest(self) -> Optional[tuple[DHTID, Endpoint]]:
        return next(iter(self.peers.items()), None) if self.peers else None

    def split(self) -> tuple["KBucket", "KBucket"]:
        mid = (self.lower + self.upper) // 2
        left, right = KBucket(self.lower, mid, self.k), KBucket(mid, self.upper, self.k)
        left.last_updated = right.last_updated = self.last_updated
        for nid, ep in self.peers.items():
            (left if left.covers(nid) else right).peers[nid] = ep
        for nid, ep in self.replacement.items():
            (left if left.covers(nid) else right).replacement[nid] = ep
        return left, right


def random_id_in_range(lower: int, upper: int) -> DHTID:
    """Uniform DHTID in [lower, upper) — bucket-refresh lookup targets."""
    span = upper - lower
    r = int.from_bytes(_urandom((span.bit_length() + 7) // 8), "big") % span
    return DHTID(lower + r)


class RoutingTable:
    """The classic Kademlia table: buckets split only on the own-ID side."""

    def __init__(self, node_id: DHTID, bucket_size: int = 20):
        self.node_id = node_id
        self.bucket_size = bucket_size
        self.buckets = [KBucket(0, 2**ID_BITS, bucket_size)]
        # invoked with the node_id whenever a node is removed from the
        # table by ANY path — lets the owner drop per-node bookkeeping
        # (e.g. DHTNode's lookup strikes) that would otherwise leak
        self.on_remove: Optional[Callable[[DHTID], None]] = None
        # piggybacked liveness: monotonic stamp of the last time we HEARD
        # from each peer (inbound request or reply to our RPC).  Table
        # maintenance reads this to skip probing peers whose regular
        # traffic already proved them alive — the explicit ping is the
        # fallback for quiet peers, not the common case.
        self.last_heard: dict[DHTID, float] = {}

    def _bucket_index(self, node_id: int) -> int:
        for i, b in enumerate(self.buckets):
            if b.covers(node_id):
                return i
        raise AssertionError("buckets must cover the whole ID space")

    def add_or_update_node(self, node_id: DHTID, endpoint: Endpoint) -> None:
        if node_id == self.node_id:
            return
        self.last_heard[node_id] = _monotonic()
        if len(self.last_heard) > 65536:
            # stamps can reference peers parked-then-dropped from
            # replacement lists (remove_node never fires for those); the
            # cost of over-pruning is one redundant maintenance ping
            for k in list(self.last_heard)[: len(self.last_heard) // 2]:
                del self.last_heard[k]
        idx = self._bucket_index(node_id)
        bucket = self.buckets[idx]
        if bucket.add_or_update(node_id, endpoint):
            return
        # bucket full: split if it contains our own ID (Kademlia rule)
        if bucket.covers(self.node_id):
            self.buckets[idx : idx + 1] = list(bucket.split())
            self.add_or_update_node(node_id, endpoint)

    def remove_node(self, node_id: DHTID) -> None:
        self.buckets[self._bucket_index(node_id)].remove(node_id)
        self.last_heard.pop(node_id, None)
        if self.on_remove is not None:
            self.on_remove(node_id)

    def get_endpoint(self, node_id: DHTID) -> Optional[Endpoint]:
        return self.buckets[self._bucket_index(node_id)].peers.get(node_id)

    def nearest_neighbors(
        self, target: int, k: int, exclude: Iterable[int] = ()
    ) -> list[tuple[DHTID, Endpoint]]:
        exclude = set(exclude)
        everyone = [
            (nid, ep)
            for b in self.buckets
            for nid, ep in b.peers.items()
            if int(nid) not in exclude
        ]
        everyone.sort(key=lambda item: int(item[0]) ^ int(target))
        return everyone[:k]

    def __len__(self) -> int:
        return sum(len(b.peers) for b in self.buckets)
