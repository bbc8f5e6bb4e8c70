"""DHT facade: expert declaration, discovery, and beam-search queries.

The port's copy of ``learning_at_home_tpu/dht/__init__.py`` (no
framework inside; its records are the JAX package's, so nodes of both
packages form one DHT).  Contract from the reference's
``hivemind/dht/__init__.py``: a DHT handle owning a Kademlia node in its
own execution domain, exposing ``declare_experts`` /
``get_experts`` / ``first_k_active``.  The reference isolates the node in a
separate *process* bridged by mp.Pipe; here the node lives on a dedicated
asyncio thread (BackgroundLoop) — the async API is callable from ANY loop
or thread, and sync wrappers serve scripts.

Expert-record layout (powers enumeration, prefix beam search AND dynamic
replication).  Subkeys are REPLICA-AWARE: two servers declaring
the same uid land on distinct subkeys instead of clobbering each other,
and readers aggregate per-uid endpoint SETS:

- full record:   key = uid ("ffn.4.17"),  subkey = "@host:port"
                 → [host, port]
- prefix record: key = each uid prefix ("ffn", "ffn.4"),
                 subkey = "uid@host:port" → [host, port]

Legacy records (subkey "" for full records, bare-uid subkeys for prefix
records) are still read as single-replica entries, so mixed-build swarms
resolve correctly.  ``get_alive_experts`` values are a bare endpoint for
single-hoster uids (the historical form every consumer understands) and
a tuple of endpoints once a uid has replicas — clients normalize with
``client.routing.as_replica_set``.

All records share one expiration; servers re-declare every
``update_period`` (heartbeat), so expiry = failure detection.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import weakref
from typing import Any, Optional, Sequence

from learning_at_home_tpu_torch.dht.node import DHTNode
from learning_at_home_tpu_torch.dht.routing import DHTID, Endpoint
from learning_at_home_tpu_torch.dht.protocol import PLAIN_SUBKEY
from learning_at_home_tpu_torch.utils.asyncio_utils import BackgroundLoop
from learning_at_home_tpu_torch.utils.metrics import registry as _metrics
from learning_at_home_tpu_torch.utils.timed_storage import get_dht_time
from learning_at_home_tpu_torch.client.routing import UID_DELIMITER, split_uid

logger = logging.getLogger(__name__)

__all__ = ["DHT", "DHTNode", "DHTID"]

_CACHE_HITS = _metrics.counter(
    "lah_dht_cache_hits_total", "routing-record cache hits"
)
_CACHE_MISSES = _metrics.counter(
    "lah_dht_cache_misses_total", "routing-record cache misses"
)


class _RecordCache:
    """Per-key cache of iterative-lookup results.

    Loop-confined to the DHT's BackgroundLoop — every reader reaches it
    through :meth:`DHT._bridge`, so no lock is needed.  Three freshness
    rules compose:

    - a cached entry is served for at most ``ttl`` seconds (the window a
      repeated ``get_alive_experts``/load-feed/telemetry read stops
      costing a full lookup);
    - each RECORD additionally honors its own expiration — an expired
      subkey never comes out of the cache even mid-window, so DHT expiry
      (the swarm's failure detector) is never blunted by caching;
    - an EMPTY result is cached too (negative caching): a miss storm on
      a dead prefix costs one lookup per window, not one per read.

    Entries invalidate when this node observes a store for the key — its
    own writes (read-your-writes) and inbound store RPCs landing in the
    local replica (protocol ``on_store_observed``)."""

    def __init__(self, ttl: float = 1.0, maxsize: int = 4096):
        self.ttl = ttl
        self.maxsize = maxsize
        self._entries: dict[bytes, tuple[float, dict]] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    @staticmethod
    def _norm(key: str | bytes) -> bytes:
        """Cache keys use the DHT's WIRE form — the 20-byte DHTID digest
        — because protocol ``on_store_observed`` only ever sees wire keys;
        normalizing facade reads (plaintext keys) to the same form is what
        lets an inbound store invalidate the matching cached read.  A
        20-byte ``bytes`` key is assumed to already be a digest."""
        if isinstance(key, (bytes, bytearray)) and len(key) == 20:
            return bytes(key)
        return DHTID.from_key(key).to_bytes()

    def get(self, key: str | bytes) -> Optional[dict]:
        kb = self._norm(key)
        entry = self._entries.get(kb)
        if entry is None:
            self.misses += 1
            return None
        stamp, records = entry
        if time.monotonic() - stamp > self.ttl:
            del self._entries[kb]
            self.misses += 1
            return None
        now = get_dht_time()
        fresh = {sk: (v, e) for sk, (v, e) in records.items() if e > now}
        if records and not fresh:
            # every cached record expired mid-window: drop the entry so
            # the next read re-resolves instead of serving an empty view
            # for the rest of the window
            del self._entries[kb]
            self.misses += 1
            return None
        self.hits += 1
        return fresh

    def put(self, key: str | bytes, records: dict) -> None:
        if self.ttl <= 0:
            return
        kb = self._norm(key)
        if kb not in self._entries and len(self._entries) >= self.maxsize:
            # evict the oldest-inserted entry: O(1) and good enough for a
            # cache whose entries live ~one TTL window anyway
            del self._entries[next(iter(self._entries))]
        self._entries[kb] = (time.monotonic(), dict(records))

    def invalidate(self, key: str | bytes) -> None:
        if self._entries.pop(self._norm(key), None) is not None:
            self.invalidations += 1


def uid_prefixes(uid: str) -> list[str]:
    """All proper prefixes of a grid uid: 'ffn.4.17' → ['ffn', 'ffn.4']."""
    prefix, coords = split_uid(uid)
    out = [prefix]
    for c in coords[:-1]:
        prefix = f"{prefix}{UID_DELIMITER}{c}"
        out.append(prefix)
    return out


class DHT:
    """Synchronous-friendly handle to a Kademlia node on its own loop thread.

    Implements the client's ExpertSource protocol (get_alive_experts /
    first_k_active), so it can be passed directly to
    RemoteMixtureOfExperts(source=dht) and to Server(dht=dht).
    """

    def __init__(
        self,
        initial_peers: Sequence[Endpoint] = (),
        host: str = "127.0.0.1",
        port: int = 0,
        cache_ttl: Optional[float] = None,
        **node_kwargs,
    ):
        if cache_ttl is None:
            cache_ttl = float(os.environ.get("LAH_DHT_CACHE_TTL", "1.0"))
        self.record_cache = _RecordCache(ttl=cache_ttl)
        self._loop = BackgroundLoop(name="lah-dht")
        try:
            self.node: DHTNode = self._loop.run(
                DHTNode.create(
                    host=host, port=port, initial_peers=initial_peers, **node_kwargs
                ),
                timeout=30,
            )
        except BaseException:
            self._loop.shutdown()  # don't leak the loop thread on failed init
            raise
        # inbound stores landing in our local replica invalidate cached
        # reads of that key (both callbacks run on the lah-dht loop)
        self.node.protocol.on_store_observed = self.record_cache.invalidate
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Scrape-time collector for this handle's DHT series (weakref —
        pruned automatically once the DHT is garbage-collected)."""
        ref = weakref.ref(self)

        def _collect() -> Optional[dict]:
            dht = ref()
            if dht is None:
                return None
            out = {
                "lah_dht_record_cache_entries": float(
                    len(dht.record_cache._entries)
                ),
                "lah_dht_record_cache_invalidations_total": float(
                    dht.record_cache.invalidations
                ),
            }
            times = sorted(dht.node.lookup_times)
            if times:
                idx = min(len(times) - 1, int(0.99 * len(times)))
                out["lah_dht_lookup_p99_ms"] = 1000.0 * times[idx]
            return out

        _metrics.register_collector(f"dht-{id(self)}", _collect)

    @property
    def endpoint(self) -> Endpoint:
        return self.node.endpoint

    def shutdown(self) -> None:
        try:
            self._loop.run(self.node.shutdown(), timeout=5)
        except Exception as e:
            # best-effort: the loop is being torn down either way, but a
            # failed node shutdown should be visible at debug level (R6)
            logger.debug("DHT node shutdown failed: %s: %s",
                         type(e).__name__, e)
        self._loop.shutdown()

    # ---- loop bridging: async API usable from any thread/loop ----

    async def _bridge(self, coro):
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop.loop:
            return await coro
        return await asyncio.wrap_future(self._loop.submit(coro))

    # ---- expert API (async, loop-agnostic) ----

    async def declare_experts(
        self,
        uids: Sequence[str],
        endpoint: Endpoint,
        expiration: float = 60.0,
        extra_records: Sequence[tuple] = (),
    ) -> int:
        """``extra_records`` — ``(key, value, expiration_delta, subkey)``
        tuples (the generic :meth:`store` signature) — ride the SAME
        per-peer store bundles as the expert records, so a server
        heartbeat's telemetry/load/wanted ads cost zero extra RPCs."""
        return await self._bridge(
            self._declare(uids, endpoint, expiration, extra_records)
        )

    async def _declare(self, uids, endpoint, expiration, extra_records=()) -> int:
        """Returns how many of ``uids`` had their full record stored.

        All records — full uid records, prefix records, and any
        ``extra_records`` — go through ONE :meth:`DHTNode.store_many`
        call: one iterative lookup per distinct key, then one multi-key
        store RPC per destination peer.  For a 256-expert
        server the heartbeat is a handful of per-peer bundles, not a
        per-key store storm.

        Subkeys carry the declaring endpoint (replica-aware scheme, see
        module docstring): N servers hosting one uid coexist as N subkey
        records under the same keys, each expiring on its own heartbeat —
        a dead replica vanishes without taking the uid down."""
        now = get_dht_time()
        expires_at = now + expiration
        value = [endpoint[0], int(endpoint[1])]
        ep_key = f"{endpoint[0]}:{int(endpoint[1])}"
        entries: list[tuple] = [
            (uid, f"@{ep_key}", value, expires_at) for uid in uids
        ]
        n_uids = len(entries)
        for uid in uids:
            for prefix in uid_prefixes(uid):
                entries.append((prefix, f"{uid}@{ep_key}", value, expires_at))
        for key, xvalue, delta, subkey in extra_records:
            entries.append((key, subkey, xvalue, now + float(delta)))
        acks = await self.node.store_many(entries)
        for key, _sk, _v, _e in entries:
            self.record_cache.invalidate(key)
        return sum(acks[:n_uids])

    async def get_experts(
        self, uids: Sequence[str]
    ) -> dict[str, Optional[Endpoint]]:
        return await self._bridge(self._get_experts(uids))

    async def store(
        self,
        key,
        value,
        expiration_delta: float,
        subkey: str = PLAIN_SUBKEY,
    ) -> bool:
        """Generic async store, callable from any loop — the telemetry
        heartbeat (``telemetry.<prefix>`` records, utils/telemetry.py)
        and other non-expert key families publish through this."""
        return await self._bridge(
            self._store(key, value, expiration_delta, subkey)
        )

    async def _store(self, key, value, expiration_delta, subkey) -> bool:
        ok = await self.node.store(
            key, value, get_dht_time() + expiration_delta, subkey
        )
        self.record_cache.invalidate(key)  # read-your-writes
        return ok

    async def store_many(
        self, records: Sequence[tuple[Any, Any, float, str]]
    ) -> list[bool]:
        """Bundle store: ``(key, value, expiration_delta, subkey)`` per
        record, keys may differ — one store RPC per destination peer for
        the whole bundle (:meth:`DHTNode.store_many`).  Returns one ack
        per record, positionally."""
        return await self._bridge(self._store_many(records))

    async def _store_many(self, records) -> list[bool]:
        now = get_dht_time()
        entries = [
            (key, subkey, value, now + float(delta))
            for key, value, delta, subkey in records
        ]
        acks = await self.node.store_many(entries)
        for key, _sk, _v, _e in entries:
            self.record_cache.invalidate(key)
        return acks

    async def get(self, key, bypass_cache: bool = False) -> dict:
        """Generic async get (fresh subkey records), loop-agnostic.
        Served from the routing-record cache within its TTL window unless
        ``bypass_cache`` forces a real iterative lookup."""
        return await self._bridge(self._cached_get(key, bypass_cache))

    async def _cached_get(self, key, bypass_cache: bool = False) -> dict:
        """All facade reads funnel here (runs on the lah-dht loop — the
        cache is loop-confined).  A bypass read still refreshes the
        cache, so a forced re-resolution benefits the next reader."""
        if not bypass_cache and self.record_cache.ttl > 0:
            cached = self.record_cache.get(key)
            if cached is not None:
                _CACHE_HITS.inc()
                return cached
            _CACHE_MISSES.inc()
        records = await self.node.get(key)
        self.record_cache.put(key, records)
        return records

    @staticmethod
    def _parse_endpoint(value) -> Optional[Endpoint]:
        """Peer-supplied record value → (host, port), or None if malformed."""
        try:
            host, port = value[0], int(value[1])
            if not isinstance(host, str):
                return None
            return (host, port)
        except (TypeError, ValueError, IndexError, KeyError):
            return None

    async def _get_experts(self, uids) -> dict[str, Optional[Endpoint]]:
        """Single-endpoint resolution (RemoteExpert's contract): for a
        replicated uid the first replica in deterministic (sorted-subkey)
        order is returned — callers that want the full set use
        ``get_alive_experts`` on the uid's prefix."""
        records = await asyncio.gather(*(self._cached_get(uid) for uid in uids))
        out: dict[str, Optional[Endpoint]] = {}
        for uid, rec in zip(uids, records):
            out[uid] = None
            for subkey in sorted(rec, key=str):
                if subkey == PLAIN_SUBKEY or (
                    isinstance(subkey, str) and subkey.startswith("@")
                ):
                    endpoint = self._parse_endpoint(rec[subkey][0])
                    if endpoint is not None:
                        out[uid] = endpoint
                        break
        return out

    # ---- ExpertSource protocol (used by RemoteMixtureOfExperts) ----

    async def get_alive_experts(
        self, prefix: str, bypass_cache: bool = False
    ) -> dict[str, Endpoint]:
        return await self._bridge(self._get_alive(prefix, bypass_cache))

    async def get_alive_experts_fresh(self, prefix: str) -> dict[str, Endpoint]:
        """Cache-bypassing alive read: a full iterative lookup NOW.  The
        authoritative path for consumers that must observe a kill the
        moment its record expires (CachedAliveSet force-refresh, the
        sole-endpoint dispatch retry) — the record cache must not add a
        staleness window on top of the record TTL there."""
        return await self._bridge(self._get_alive(prefix, bypass_cache=True))

    async def _get_alive(self, prefix: str, bypass_cache: bool = False) -> dict:
        """uid → endpoint (single hoster) or tuple-of-endpoints (replica
        set, sorted for determinism).  Subkey forms, newest first:

        - ``"uid@host:port"`` — replica-aware prefix entry;
        - ``"@host:port"`` / ``""`` — the queried key IS a full expert
          uid (deepest prefix level of 1-D grids, where beam search
          queries ``ffn.7`` directly);
        - bare uid — legacy prefix entry from an old build.
        """
        records = await self._cached_get(prefix, bypass_cache)
        eps: dict[str, list] = {}
        for subkey, (v, _) in records.items():
            endpoint = self._parse_endpoint(v)
            if endpoint is None:  # skip malformed peer-supplied values
                continue
            if subkey == PLAIN_SUBKEY:
                uid = prefix
            elif not isinstance(subkey, str):
                continue
            elif subkey.startswith("@"):
                uid = prefix
            elif "@" in subkey:
                uid = subkey.rsplit("@", 1)[0]
            else:
                uid = subkey  # legacy bare-uid entry
            bucket = eps.setdefault(uid, [])
            if endpoint not in bucket:
                bucket.append(endpoint)
        return {
            uid: (lst[0] if len(lst) == 1 else tuple(sorted(lst)))
            for uid, lst in eps.items()
        }

    async def first_k_active(
        self, prefixes: Sequence[str], k: int
    ) -> dict[str, bool]:
        """Which prefixes have ≥1 alive expert — the beam-search primitive.

        Queries run in parallel; the result preserves the caller's order
        (callers pass prefixes sorted by descending gate score)."""
        return await self._bridge(self._first_k_active(prefixes, k))

    async def _first_k_active(self, prefixes, k) -> dict[str, bool]:
        records = await asyncio.gather(*(self._cached_get(p) for p in prefixes))
        return {
            p: any(sk != PLAIN_SUBKEY for sk in rec)
            for p, rec in zip(prefixes, records)
        }

    # ---- sync conveniences for scripts/tests ----

    def declare_experts_sync(self, uids, endpoint, expiration: float = 60.0) -> int:
        return self._loop.run(self._declare(uids, endpoint, expiration), timeout=60)

    def get_experts_sync(self, uids) -> dict[str, Optional[Endpoint]]:
        return self._loop.run(self._get_experts(uids), timeout=60)

    def store_sync(self, key, value, expiration_delta: float, subkey: str = PLAIN_SUBKEY) -> bool:
        return self._loop.run(
            self._store(key, value, expiration_delta, subkey), timeout=60
        )

    def get_sync(self, key, bypass_cache: bool = False) -> dict:
        return self._loop.run(self._cached_get(key, bypass_cache), timeout=60)
