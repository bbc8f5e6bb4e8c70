"""DHTNode: iterative Kademlia lookups over the TCP protocol layer.

The port's copy of ``learning_at_home_tpu/dht/node.py``.  Contract from
the reference's ``hivemind/dht/node.py``: α-parallel iterative ``find_node`` /
``find_value`` walking k-buckets toward the target; ``store`` writes
(value, expiration) onto the k closest nodes; reads ignore expired values —
expiry plus periodic re-declare IS the failure detector.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
import time
from typing import Any, Iterable, Optional, Sequence

from collections import deque

from learning_at_home_tpu_torch.dht.protocol import (
    DEFAULT_RPC_TIMEOUT,
    DHTProtocol,
    DHTRecordStorage,
    PLAIN_SUBKEY,
)
from learning_at_home_tpu_torch.dht.routing import DHTID, Endpoint, RoutingTable
from learning_at_home_tpu_torch.utils.metrics import registry as _metrics
from learning_at_home_tpu_torch.utils.timed_storage import DHTExpiration, get_dht_time

logger = logging.getLogger(__name__)

# Clock seam: maintenance pacing, lookup timing and lookup-strike
# bookkeeping all read time through here so a simulated clock can virtualize
# them.
_monotonic = time.monotonic

_LOOKUP_SECONDS = _metrics.histogram(
    "lah_dht_lookup_seconds", "iterative lookup wall-clock",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)
_PINGS_SKIPPED = _metrics.counter(
    "lah_dht_maintenance_pings_skipped_total",
    "maintenance probes elided because regular traffic already proved "
    "the peer alive (piggybacked liveness)",
)


class DHTNode:
    """One Kademlia peer (asyncio; lives on whichever loop created it)."""

    def __init__(
        self,
        node_id: Optional[DHTID] = None,
        bucket_size: int = 20,
        alpha: int = 6,
        rpc_timeout: float = DEFAULT_RPC_TIMEOUT,
        max_records: Optional[int] = 65536,
    ):
        # α = 6 (not the textbook 3) + the adaptive per-peer timeout
        # (protocol.py): a wave is as slow as its slowest member, so a
        # dead peer used to serialize the whole lookup for rpc_timeout —
        # wider waves keep live progress flowing around it
        self.node_id = node_id if node_id is not None else DHTID.generate()
        self.alpha = alpha
        self.bucket_size = bucket_size
        self.routing_table = RoutingTable(self.node_id, bucket_size)
        self.storage = DHTRecordStorage(max_records)
        self.protocol = DHTProtocol(
            self.node_id, self.routing_table, self.storage, rpc_timeout
        )
        self._maintenance_task: Optional[asyncio.Task] = None
        # First-timeout strikes for lookup peers (two-strike eviction).
        # Each entry is ``(lookup_id, strike_time)``: eviction requires a
        # second timeout from a DIFFERENT lookup whose RPC was issued
        # AFTER the strike was recorded — two in-flight RPCs failing on
        # one GC pause are one logical event, not two strikes.  Entries
        # clear on any success, on eviction, and whenever the node leaves
        # the routing table by any path (no leak for peers that time out
        # once and are never re-queried).
        self._lookup_strikes: dict[DHTID, tuple[int, float]] = {}
        self._lookup_counter = itertools.count()
        self.routing_table.on_remove = self._on_table_remove
        # recent lookup wall-clocks (the facade's lah_dht_lookup_p99 feed)
        self.lookup_times: deque[float] = deque(maxlen=512)
        self.maintenance_pings_skipped = 0

    @classmethod
    async def create(
        cls,
        host: str = "127.0.0.1",
        port: int = 0,
        initial_peers: Sequence[Endpoint] = (),
        maintenance_period: Optional[float] = 60.0,
        **kwargs,
    ) -> "DHTNode":
        node = cls(**kwargs)
        await node.protocol.listen(host, port)
        if initial_peers:
            await node.bootstrap(initial_peers)
        if maintenance_period:
            node.start_maintenance(maintenance_period)
        return node

    @property
    def endpoint(self) -> Endpoint:
        return ("127.0.0.1", self.protocol.listen_port)

    async def bootstrap(self, initial_peers: Iterable[Endpoint]) -> None:
        from learning_at_home_tpu_torch.dht.routing import random_id_in_range

        pings = await asyncio.gather(
            *(self.protocol.call_ping(ep) for ep in initial_peers)
        )
        if not any(p is not None for p in pings):
            logger.warning("bootstrap: no initial peer responded")
            return
        # populate buckets around our own ID
        await self.find_nearest_nodes(self.node_id)
        # Kademlia join, second half (paper §2.3): refresh every OTHER
        # bucket range too.  A self-lookup alone teaches a joiner only its
        # own neighborhood; at swarm sizes where that neighborhood is a
        # small fraction of the network, iterative lookups issued from
        # such sparse tables converge to local clusters instead of the
        # true k-closest set (measured: 128 nodes, star bootstrap —
        # store() placed records on XOR-ranks 34-74 and hit rate fell to
        # 0.973; with join refreshes it is 1.0 again).  The refreshes also
        # ADVERTISE this node into distant regions, since every contacted
        # peer learns its caller.
        # Two passes over a RE-SNAPSHOTTED bucket list, own bucket
        # included: when the self-lookup taught ≤ k peers the table has
        # not split yet, so the only bucket IS the own bucket — skipping
        # it (an earlier "optimization") silently skipped the entire
        # refresh phase on such joins, and the first refresh round can
        # split buckets whose new ranges also deserve a lookup.
        refreshed: set[tuple] = set()
        for _ in range(2):
            todo = [
                b for b in list(self.routing_table.buckets)
                if (b.lower, b.upper) not in refreshed
            ]
            if not todo:
                break
            refreshed.update((b.lower, b.upper) for b in todo)
            await asyncio.gather(
                *(
                    self.find_nearest_nodes(
                        random_id_in_range(b.lower, b.upper)
                    )
                    for b in todo
                )
            )

    async def shutdown(self) -> None:
        if self._maintenance_task is not None:
            self._maintenance_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._maintenance_task
            self._maintenance_task = None
        await self.protocol.shutdown()

    # ---------------- table maintenance (refresh + stale eviction) ----------------

    def start_maintenance(self, period: float = 60.0) -> None:
        """Classic Kademlia hygiene: periodically (a) ping each bucket's
        oldest peer and evict it if unresponsive twice (promoting a
        replacement), (b) refresh buckets idle for a full period with a
        lookup for a random ID in their range."""
        if self._maintenance_task is not None:
            self._maintenance_task.cancel()
        self._maintenance_task = asyncio.get_running_loop().create_task(
            self._maintain_forever(period), name="dht-maintenance"
        )

    async def _maintain_forever(self, period: float) -> None:
        from learning_at_home_tpu_torch.dht.routing import random_id_in_range

        while True:
            await asyncio.sleep(period)
            try:
                for bucket in list(self.routing_table.buckets):
                    oldest = bucket.oldest
                    if oldest is not None:
                        nid, endpoint = oldest
                        heard = self.routing_table.last_heard.get(nid)
                        if (
                            heard is not None
                            and _monotonic() - heard <= period
                        ):
                            # piggybacked liveness: a reply or
                            # inbound request within the last period IS a
                            # ping — under regular heartbeat/lookup
                            # traffic, explicit probes mostly disappear
                            self.maintenance_pings_skipped += 1
                            _PINGS_SKIPPED.inc()
                        # two strikes: a single timed-out ping (GC pause,
                        # transient congestion) must not shrink the table
                        elif (
                            await self.protocol.call_ping(endpoint) is None
                            and await self.protocol.call_ping(endpoint) is None
                        ):
                            self.routing_table.remove_node(nid)
                    if bucket.peers and _monotonic() - bucket.last_updated > period:
                        await self.find_nearest_nodes(
                            random_id_in_range(bucket.lower, bucket.upper)
                        )
                        bucket.last_updated = _monotonic()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("DHT maintenance pass failed")

    # ---------------- iterative lookup core ----------------

    def _on_table_remove(self, node_id: DHTID) -> None:
        """RoutingTable removal hook: a departed node's strike entry must
        not outlive its table membership."""
        self._lookup_strikes.pop(node_id, None)

    def _record_lookup_timeout(
        self, nid: DHTID, lookup_id: int, wave_started: float
    ) -> None:
        """Two-strike eviction with single-event protection: evict only
        when a PRIOR strike exists from a different lookup AND was
        recorded before this wave's RPCs went out (so the peer had a
        fresh chance between the two failures — concurrent lookups
        sharing one GC pause cannot double-strike)."""
        entry = self._lookup_strikes.get(nid)
        if (
            entry is not None
            and entry[0] != lookup_id
            and entry[1] < wave_started
        ):
            # eviction clears the strike via the on_remove hook
            self.routing_table.remove_node(nid)
            self._lookup_strikes.pop(nid, None)  # nid may not be in table
        elif entry is None:
            self._lookup_strikes[nid] = (lookup_id, _monotonic())
            # strikes can reference peers never admitted to the table
            # (shortlist members learned mid-lookup) — the table hook
            # can't clear those, so bound the dict under churn.  Entries
            # are insert-only, so dict order IS strike-time order: drop
            # the oldest half without sorting (this runs on the loop)
            if len(self._lookup_strikes) > 65536:
                for k in list(
                    itertools.islice(
                        iter(self._lookup_strikes),
                        len(self._lookup_strikes) // 2,
                    )
                ):
                    del self._lookup_strikes[k]

    async def _iterative_lookup(
        self, target: DHTID, find_value: bool
    ) -> tuple[dict[str, tuple[Any, DHTExpiration]], list[tuple[DHTID, Endpoint]]]:
        lookup_id = next(self._lookup_counter)
        lookup_t0 = _monotonic()
        key_bytes = target.to_bytes()
        # seed with 2k neighbors, not k: a k-sized seed drawn from a
        # sparse table can lie entirely inside one local cluster, and the
        # lookup then terminates on that cluster's consensus without ever
        # hearing about the true k-closest region (the 128-node
        # benchmark's residual-miss mode; doubling the seed width costs
        # no extra RPCs unless those nodes are actually among the
        # closest-known frontier)
        shortlist: dict[DHTID, Endpoint] = dict(
            self.routing_table.nearest_neighbors(target, 2 * self.bucket_size)
        )
        queried: set[DHTID] = set()
        responded: dict[DHTID, Endpoint] = {}
        records: dict[str, tuple[Any, DHTExpiration]] = {}

        def merge_records(new: dict[str, tuple[Any, DHTExpiration]]) -> None:
            for sk, (v, e) in new.items():
                if sk not in records or records[sk][1] < e:
                    records[sk] = (v, e)

        while True:
            candidates = sorted(
                (nid for nid in shortlist if nid not in queried),
                key=lambda nid: int(nid) ^ int(target),
            )[: self.alpha]
            if not candidates:
                break
            queried.update(candidates)
            wave_started = _monotonic()
            calls = [
                self.protocol.call_find_value(shortlist[nid], key_bytes)
                if find_value
                else self.protocol.call_find_node(shortlist[nid], key_bytes)
                for nid in candidates
            ]
            replies = await asyncio.gather(*calls)
            for nid, reply in zip(candidates, replies):
                if reply is None:
                    # two-strike eviction, same invariant as maintenance:
                    # a single timed-out RPC (GC pause, 1-core stall) must
                    # not evict a live peer — under load that re-thins
                    # exactly the tables responder-learning densifies
                    self._record_lookup_timeout(nid, lookup_id, wave_started)
                    continue
                self._lookup_strikes.pop(nid, None)
                responded[nid] = shortlist[nid]
                # textbook Kademlia: every node we HEAR FROM refreshes our
                # table.  Without this, a node only ever learns from
                # inbound requests (protocol.py add-caller), so a joiner's
                # own lookups teach it nothing — measured: a late joiner's
                # table held exactly 1 peer (the bootstrap node) at 32
                # nodes, the root cause of the thin tables behind the
                # 128-node hit-rate regression
                self.routing_table.add_or_update_node(nid, shortlist[nid])
                if find_value:
                    value_records, peers = reply
                    merge_records(value_records)
                else:
                    peers = reply
                for peer_id, peer_ep in peers:
                    if peer_id != self.node_id:
                        shortlist.setdefault(peer_id, peer_ep)
            # termination: the k closest known are all queried
            closest = sorted(shortlist, key=lambda nid: int(nid) ^ int(target))[
                : self.bucket_size
            ]
            if all(nid in queried for nid in closest):
                break

        elapsed = _monotonic() - lookup_t0
        self.lookup_times.append(elapsed)
        _LOOKUP_SECONDS.observe(elapsed)
        nearest = sorted(responded.items(), key=lambda kv: int(kv[0]) ^ int(target))
        return records, nearest[: self.bucket_size]

    async def find_nearest_nodes(
        self, target: DHTID
    ) -> list[tuple[DHTID, Endpoint]]:
        _, nearest = await self._iterative_lookup(target, find_value=False)
        return nearest

    # ---------------- public store / get ----------------

    async def store(
        self,
        key: str | bytes,
        value: Any,
        expiration: DHTExpiration,
        subkey: str = PLAIN_SUBKEY,
    ) -> bool:
        """Write (subkey → value, expiration) onto the k closest nodes."""
        result = await self.store_batch(key, [(subkey, value, expiration)])
        return result[subkey]

    async def store_batch(
        self, key: str | bytes, entries: Sequence[tuple[str, Any, DHTExpiration]]
    ) -> dict[str, bool]:
        """Write many subkeys of ONE key with a single iterative lookup and
        one batched store RPC per neighbor (the heartbeat hot path: all
        experts under a shared prefix key go out in one call)."""
        acks = await self.store_many([(key, sk, v, e) for sk, v, e in entries])
        ok: dict[str, bool] = {}
        for (sk, _, _), a in zip(entries, acks):
            ok[sk] = ok.get(sk, False) or a
        return ok

    async def store_many(
        self,
        entries: Sequence[tuple[str | bytes, str, Any, DHTExpiration]],
    ) -> list[bool]:
        """Write a bundle of (key, subkey, value, expiration) records —
        keys may DIFFER — with one iterative lookup per distinct key and
        then ONE store RPC per destination peer carrying every item that
        peer should hold (the server heartbeat's expert +
        telemetry + load + wanted records coalesce into a handful of
        per-peer bundles instead of a per-key store storm).  Returns one
        ack per entry, positionally."""
        from learning_at_home_tpu_torch.dht.protocol import MAX_STORE_ITEMS

        if not entries:
            return []
        wire_keys: list[bytes] = []
        targets: dict[bytes, DHTID] = {}
        by_key: dict[bytes, list[int]] = {}
        for i, (key, _sk, _v, _e) in enumerate(entries):
            target = DHTID.from_key(key)
            kb = target.to_bytes()
            wire_keys.append(kb)
            targets.setdefault(kb, target)
            by_key.setdefault(kb, []).append(i)

        key_order = list(by_key)
        nearest_per_key = await asyncio.gather(
            *(self.find_nearest_nodes(targets[kb]) for kb in key_order)
        )
        ok = [False] * len(entries)
        per_peer: dict[Endpoint, list[int]] = {}
        for kb, nearest in zip(key_order, nearest_per_key):
            idxs = by_key[kb]
            for _, ep in nearest:
                per_peer.setdefault(ep, []).extend(idxs)
            # replicate locally when we are within the k closest of this
            # key (or the swarm is tiny)
            target = targets[kb]
            if len(nearest) < self.bucket_size or any(
                int(self.node_id) ^ int(target) < int(nid) ^ int(target)
                for nid, _ in nearest
            ):
                for i in idxs:
                    _, sk, v, e = entries[i]
                    if self.storage.store(kb, sk, v, e):
                        ok[i] = True

        async def store_to(ep: Endpoint, idxs: list[int]) -> None:
            # serving nodes cap items per store RPC; chunk client-side so
            # a >1024-record bundle is never silently truncated
            for c in range(0, len(idxs), MAX_STORE_ITEMS):
                chunk = idxs[c : c + MAX_STORE_ITEMS]
                items = [
                    (wire_keys[i], entries[i][1], entries[i][2], entries[i][3])
                    for i in chunk
                ]
                acks = await self.protocol.call_store_items(ep, items)
                if acks is not None:
                    for i, a in zip(chunk, acks):
                        if a:
                            ok[i] = True

        await asyncio.gather(
            *(store_to(ep, idxs) for ep, idxs in per_peer.items())
        )
        return ok

    async def get(
        self, key: str | bytes
    ) -> dict[str, tuple[Any, DHTExpiration]]:
        """Merged fresh records for key (freshest expiration wins per subkey)."""
        target = DHTID.from_key(key)
        records, _ = await self._iterative_lookup(target, find_value=True)
        now = get_dht_time()
        for sk, (v, e) in self.storage.get(target.to_bytes()).items():
            if e > now and (sk not in records or records[sk][1] < e):
                records[sk] = (v, e)
        return records
