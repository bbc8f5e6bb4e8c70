"""Kademlia wire protocol: ping / store / find_node / find_value over TCP.

The port's copy of ``learning_at_home_tpu/dht/protocol.py``: its frames
are the JAX package's byte for byte.  Contract from the reference's
``hivemind/dht/protocol.py``.  Deliberate deviation from
classic UDP Kademlia: RPCs ride the same framed-msgpack TCP transport as
the tensor protocol (utils/serialization.py + utils/connection.py).  That
removes UDP's ~64 KB value ceiling (prefix records for a 4096-expert grid
exceed it), reuses the pooled-connection client, and keeps exactly one wire
stack in the framework.

Every request carries the sender's (node_id, listen_port) so each RPC
doubles as a routing-table liveness signal, as in classic Kademlia.

Values are dict-records: ``key -> {subkey: (value, expiration)}``.  Plain
single values use the reserved subkey ``""``.  Sub-keyed records are what
lets N servers declare experts under one shared prefix key without
read-modify-write races.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Optional

from learning_at_home_tpu_torch.dht.routing import DHTID, Endpoint, RoutingTable
from learning_at_home_tpu_torch.utils.connection import PoolRegistry
from learning_at_home_tpu_torch.utils.metrics import registry as _metrics
from learning_at_home_tpu_torch.utils.serialization import (
    WireTensors,
    pack_frames,
    pack_message,
    peek_header,
    recv_frame,
    send_frame,
    send_frame_parts,
    unpack_message,
)
from learning_at_home_tpu_torch.utils.timed_storage import (
    DHTExpiration,
    TimedStorage,
    get_dht_time,
)

logger = logging.getLogger(__name__)

PLAIN_SUBKEY = ""
MAX_STORE_ITEMS = 1024  # per store RPC; a 256-expert heartbeat uses ~257
MAX_KEY_BYTES = 512  # uids/prefixes are short; reject absurd keys

# Adaptive RPC timeout: per-peer timeout = MULT × that peer's
# RTT EMA (the pool already tracks it), clamped to [FLOOR, rpc_timeout].
# ``rpc_timeout`` is thus the CEILING a never-measured or flaky peer can
# cost, not the price every dead-peer probe pays — a fixed 3 s timeout
# would let dead DHT peers stall dispatch-path alive refreshes for
# seconds.
# Timeouts fold into the RTT EMA (utils/connection.py latency signals),
# so a peer that outgrows its budget raises its own budget next call.
DEFAULT_RPC_TIMEOUT = 0.8
ADAPTIVE_TIMEOUT_FLOOR = 0.05
ADAPTIVE_TIMEOUT_MULT = 4.0

# client-side DHT traffic series
_RPCS_TOTAL = _metrics.counter(
    "lah_dht_rpcs_total", "DHT client RPCs issued, by type"
)
_BATCHED_KEYS = _metrics.histogram(
    "lah_dht_batched_keys_per_store",
    "distinct keys coalesced into one outgoing store RPC",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)


class DHTRecordStorage:
    """Per-key dict of subkey → (value, expiration); outer TTL = max inner.

    Both tiers are bounded: the swarm is a trust boundary (same as the wire
    layer's 1 GiB frame cap), so an unauthenticated peer pushing store RPCs
    must hit eviction, not exhaust memory."""

    def __init__(
        self, maxsize: Optional[int] = 65536, max_subkeys: int = 65536
    ):
        self._records: TimedStorage[bytes, TimedStorage] = TimedStorage(maxsize)
        self.max_subkeys = max_subkeys

    def store(
        self, key: bytes, subkey: str, value: Any, expiration: DHTExpiration
    ) -> bool:
        entry = self._records.get(key)
        inner = entry[0] if entry is not None else TimedStorage(self.max_subkeys)
        ok = inner.store(subkey, value, expiration)
        if ok:
            outer_exp = max(e for _, _, e in inner.items())
            self._records.store(key, inner, outer_exp)
            # the outer tier is bounded too: if storing this key evicted it
            # straight away, the caller must NOT be told it was replicated
            ok = self._records.get(key) is not None
        return ok

    def get(self, key: bytes) -> dict[str, tuple[Any, DHTExpiration]]:
        entry = self._records.get(key)
        if entry is None:
            return {}
        return {sk: (v, e) for sk, v, e in entry[0].items()}

    def __len__(self) -> int:
        return len(self._records)


class DHTProtocol:
    """Serves and issues the four Kademlia RPCs for one node."""

    def __init__(
        self,
        node_id: DHTID,
        routing_table: RoutingTable,
        storage: DHTRecordStorage,
        rpc_timeout: float = DEFAULT_RPC_TIMEOUT,
    ):
        self.node_id = node_id
        self.routing_table = routing_table
        self.storage = storage
        self.rpc_timeout = rpc_timeout  # adaptive-timeout CEILING
        self.listen_port: Optional[int] = None  # set by DHTNode after bind
        # v2-negotiated: the serve loop answers ``hello``
        # and echoes request ids, so one socket per peer carries many
        # in-flight calls (lookup waves, batched stores).  Peers from
        # builds whose DHT handlers predate ``hello`` are NOT reachable
        # from this client.
        self._pools = PoolRegistry(
            max_connections_per_endpoint=2, negotiate_v2=True
        )
        # plain-int traffic counters (per-protocol; the process-wide
        # ``lah_dht_*`` series aggregate via utils/metrics).  Tests and
        # the swarm simulator read these directly for A/B assertions.
        self.rpcs_sent: dict[str, int] = {}
        self.rpcs_served: dict[str, int] = {}
        # called with each stored key (bytes) when an INBOUND store RPC
        # lands in our storage — the facade's record cache invalidates on
        # it so a cached read never outlives an observed overwrite
        self.on_store_observed: Optional[Any] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._handler_tasks: set[asyncio.Task] = set()

    # ---------------- server side ----------------

    async def listen(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.listen_port = self._server.sockets[0].getsockname()[1]
        return self.listen_port

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
        # handlers serve persistent connections in an endless recv loop, so
        # py3.12's wait_closed() would block forever — cancel them instead
        for task in list(self._handler_tasks):
            task.cancel()
        self._pools.close()

    async def _handle(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._handler_tasks.add(task)
        task.add_done_callback(self._handler_tasks.discard)
        peer_host = writer.get_extra_info("peername")[0]
        try:
            while True:
                try:
                    payload = await recv_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                # peer-supplied bytes end at this line: a frame that does
                # not parse, or whose meta breaks _serve (missing
                # from/port, wrong types), gets an error REPLY on the
                # same connection — closing would punish a pipelining
                # peer's later well-formed requests for one bad frame
                try:
                    msg_type, rid = peek_header(payload)
                    _, _, meta = unpack_message(payload)
                    if not isinstance(meta, dict):
                        raise ValueError(
                            f"meta must be a map, got {type(meta).__name__}"
                        )
                except Exception as e:
                    # lah-lint: ignore[R1] tiny error frame
                    await send_frame_parts(
                        writer,
                        pack_frames(
                            "r", WireTensors.prepare(),
                            {"error": f"malformed request: {e}"},
                        ),
                    )
                    continue
                if msg_type == "hello":
                    # v2 negotiation (utils/connection.py): the DHT
                    # speaks mux (rid-tagged replies over one socket)
                    # but not codec — control frames carry no tensors
                    offered = meta.get("features")
                    feats = [
                        f for f in (offered if isinstance(offered, list) else [])
                        if f == "mux"
                    ]
                    # lah-lint: ignore[R1] tiny once-per-connection frame
                    hello_ok = pack_message("hello_ok", meta={"features": feats})
                    await send_frame(writer, hello_ok)
                    continue
                try:
                    reply = self._serve(msg_type, meta, peer_host)
                except Exception as e:
                    reply = {
                        "error": f"bad {msg_type!r} request: "
                                 f"{type(e).__name__}: {e}"
                    }
                # Serving is serial per connection (requests are small
                # sync dict ops), but replies echo the request id so a
                # mux client may pipeline freely.
                # lah-lint: ignore[R1] DHT control plane: replies are
                # small msgpack maps (routing records), never tensor bytes
                await send_frame_parts(
                    writer,
                    pack_frames("r", WireTensors.prepare(), reply, rid=rid),
                )
        except Exception:
            logger.exception("DHT handler error from %s", peer_host)
        finally:
            writer.close()

    def _serve(self, msg_type: str, meta: dict, peer_host: str) -> dict:
        # every request refreshes the sender in our routing table
        sender_id = DHTID.from_bytes(meta["from"])
        sender_port = int(meta["port"])
        self.routing_table.add_or_update_node(sender_id, (peer_host, sender_port))
        self.rpcs_served[msg_type] = self.rpcs_served.get(msg_type, 0) + 1

        if msg_type == "ping":
            return {"node_id": self.node_id.to_bytes()}
        if msg_type == "store":
            # peer-supplied batch: bound item count and key/subkey sizes so
            # one malicious frame can't stuff unbounded state.  Items may
            # mix DIFFERENT keys (one store RPC per destination
            # peer per heartbeat carries a whole record bundle).
            ok: dict = {}
            ok_list: list[bool] = []
            for key, subkey, value, expiration in meta["items"][:MAX_STORE_ITEMS]:
                # type-check BEFORE bytes(): bytes(10**12) would try to
                # allocate a terabyte of zeros from one malicious frame
                if not isinstance(key, (bytes, bytearray, str)) \
                        or not isinstance(subkey, str) \
                        or len(key) > MAX_KEY_BYTES \
                        or len(subkey) > MAX_KEY_BYTES:
                    ok[str(subkey)[:64]] = False
                    ok_list.append(False)
                    continue
                key = key.encode() if isinstance(key, str) else bytes(key)
                good = self.storage.store(key, subkey, value, float(expiration))
                ok[subkey] = good
                ok_list.append(good)
                if good and self.on_store_observed is not None:
                    self.on_store_observed(key)
            # ``ok`` (subkey-keyed) predates multi-key bundles, where two
            # items sharing a subkey under different keys would collide —
            # ``ok_list`` acks per ITEM, positionally
            return {"ok": ok, "ok_list": ok_list}
        if msg_type == "find_node":
            return {"peers": self._nearest(meta["key"])}
        if msg_type == "find_value":
            records = self.storage.get(bytes(meta["key"]))
            return {
                "value": [[sk, v, e] for sk, (v, e) in records.items()],
                "peers": self._nearest(meta["key"]),
            }
        return {"error": f"unknown DHT rpc {msg_type!r}"}

    def _nearest(self, key: bytes) -> list:
        target = DHTID.from_bytes(bytes(key))
        return [
            [nid.to_bytes(), list(ep)]
            for nid, ep in self.routing_table.nearest_neighbors(
                target, self.routing_table.bucket_size
            )
        ]

    # ---------------- client side ----------------

    def timeout_for(self, endpoint: Endpoint) -> float:
        """Per-peer adaptive timeout: MULT × the pool's RTT EMA, clamped
        to [ADAPTIVE_TIMEOUT_FLOOR, rpc_timeout].  A peer never contacted
        (or never successfully) pays the ceiling — which is also the hard
        bound a dead peer can stall any single wave."""
        pool = self._pools.peek(endpoint)
        if pool is not None and pool.rtt_ema is not None:
            return min(
                max(ADAPTIVE_TIMEOUT_MULT * pool.rtt_ema,
                    ADAPTIVE_TIMEOUT_FLOOR),
                self.rpc_timeout,
            )
        return self.rpc_timeout

    async def _call(self, endpoint: Endpoint, msg_type: str, meta: dict) -> Optional[dict]:
        meta = {**meta, "from": self.node_id.to_bytes(), "port": self.listen_port}
        self.rpcs_sent[msg_type] = self.rpcs_sent.get(msg_type, 0) + 1
        _RPCS_TOTAL.inc(type=msg_type)
        try:
            return await self._transport(endpoint, msg_type, meta)
        except Exception as e:
            logger.debug("DHT rpc %s to %s failed: %s", msg_type, endpoint, e)
            return None

    async def _transport(
        self, endpoint: Endpoint, msg_type: str, meta: dict
    ) -> Optional[dict]:
        """One request/reply exchange on the wire.  The ONLY seam a
        swarm simulator overrides — every
        envelope/accounting/timeout decision above it stays the real
        code under simulation."""
        _, reply = await self._pools.get(endpoint).rpc(
            msg_type, (), meta, timeout=self.timeout_for(endpoint)
        )
        return reply

    async def call_ping(self, endpoint: Endpoint) -> Optional[DHTID]:
        reply = await self._call(endpoint, "ping", {})
        if reply is None:
            return None
        peer_id = DHTID.from_bytes(reply["node_id"])
        self.routing_table.add_or_update_node(peer_id, endpoint)
        return peer_id

    async def call_store(
        self,
        endpoint: Endpoint,
        items: list[tuple[bytes, str, Any, DHTExpiration]],
    ) -> Optional[dict]:
        _BATCHED_KEYS.observe(len({it[0] for it in items}))
        reply = await self._call(
            endpoint, "store", {"items": [list(it) for it in items]}
        )
        return None if reply is None else reply.get("ok")

    async def call_store_items(
        self,
        endpoint: Endpoint,
        items: list[tuple[bytes, str, Any, DHTExpiration]],
    ) -> Optional[list[bool]]:
        """Multi-key bundle store with positional per-item acks (the
        coalesced-heartbeat path; same wire RPC as :meth:`call_store`)."""
        _BATCHED_KEYS.observe(len({it[0] for it in items}))
        reply = await self._call(
            endpoint, "store", {"items": [list(it) for it in items]}
        )
        if reply is None:
            return None
        acks = reply.get("ok_list")
        if isinstance(acks, list) and len(acks) == len(items):
            return [bool(a) for a in acks]
        # peer predates ok_list: fall back to the subkey-keyed map (exact
        # only when subkeys are unique within the bundle)
        ok = reply.get("ok") or {}
        return [bool(ok.get(sk, False)) for _, sk, _, _ in items]

    @staticmethod
    def _parse_peers(reply: dict) -> list[tuple[DHTID, Endpoint]]:
        return [
            (DHTID.from_bytes(nid), (ep[0], int(ep[1])))
            for nid, ep in reply.get("peers", [])
        ]

    async def call_find_node(
        self, endpoint: Endpoint, key: bytes
    ) -> Optional[list[tuple[DHTID, Endpoint]]]:
        reply = await self._call(endpoint, "find_node", {"key": key})
        return None if reply is None else self._parse_peers(reply)

    async def call_find_value(
        self, endpoint: Endpoint, key: bytes
    ) -> Optional[tuple[dict, list[tuple[DHTID, Endpoint]]]]:
        reply = await self._call(endpoint, "find_value", {"key": key})
        if reply is None:
            return None
        fresh_after = get_dht_time()
        records = {
            sk: (v, float(e))
            for sk, v, e in reply.get("value", [])
            if float(e) > fresh_after
        }
        return records, self._parse_peers(reply)
