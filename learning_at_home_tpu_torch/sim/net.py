"""In-process DHT delivery fabric: the port's copy of
``learning_at_home_tpu/sim/net.py``.

Real sockets cap a single box at a few hundred nodes (fd limits, kernel
accept queues, per-connection buffers) and drown the measurement in
transport noise.  Here every node runs the REAL ``DHTNode`` /
``DHTProtocol`` code — routing tables, iterative lookups, adaptive
timeouts, batched stores — and only the one-request/one-reply exchange
(``DHTProtocol._transport``) is swapped for an in-process delivery shim,
so the control-plane numbers this reports are the protocol's, not the
kernel's.  Dead peers behave like dead sockets: the caller waits its own
adaptive timeout and gets nothing.

The fabric serves the macro-sim too: per-link latency via
``latency_fn(src_port, dst_port)`` (the macro-sim plugs its seeded
RTT model in; ``dht_swarm_sim`` keeps the constant default), and RTT
measurement through a pluggable clock so the EMAs read VIRTUAL elapsed
time under :class:`~learning_at_home_tpu_torch.sim.clock.VirtualClockEventLoop`.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

from learning_at_home_tpu_torch.dht.node import DHTNode
from learning_at_home_tpu_torch.dht.protocol import (
    ADAPTIVE_TIMEOUT_FLOOR,
    ADAPTIVE_TIMEOUT_MULT,
    DHTProtocol,
)
from learning_at_home_tpu_torch.dht.routing import Endpoint

SIM_HOST = "127.0.0.1"


class SimNetwork:
    """Endpoint → protocol registry plus the delivery fabric.

    Delivery to a registered peer invokes its REAL ``_serve`` directly
    (requests/replies are plain msgpack-able dicts on both sides of the
    real wire, so passing them by reference preserves semantics).
    Delivery to an unregistered endpoint — a killed node — costs the
    caller its own adaptive timeout, exactly like a dead socket."""

    def __init__(
        self,
        latency: float = 0.0,
        *,
        latency_fn: Optional[Callable[[int, int], float]] = None,
    ):
        self.latency = latency
        self.latency_fn = latency_fn
        self._by_port: dict[int, DHTProtocol] = {}
        self._next_port = 1
        self.rpcs: dict[str, int] = {}

    def register(self, proto: DHTProtocol) -> int:
        port = self._next_port
        self._next_port += 1
        self._by_port[port] = proto
        return port

    def unregister(self, proto: DHTProtocol) -> None:
        if proto.listen_port is not None:
            self._by_port.pop(proto.listen_port, None)

    def link_latency_s(self, src_port: Optional[int], dst_port: int) -> float:
        """Total request+reply delivery delay for one RPC.  ``latency_fn``
        (when set) models the round trip for the (src, dst) pair; the
        constant fallback preserves dht_swarm_sim's historical meaning
        of ``--latency`` (one sleep per delivery)."""
        if self.latency_fn is not None and src_port is not None:
            return self.latency_fn(src_port, dst_port)
        return self.latency

    async def deliver(
        self, src: "SimDHTProtocol", endpoint: Endpoint, msg_type: str,
        meta: dict,
    ) -> Optional[dict]:
        self.rpcs[msg_type] = self.rpcs.get(msg_type, 0) + 1
        dest = self._by_port.get(int(endpoint[1]))
        if dest is None:
            # dead peer: the caller's OWN adaptive budget bounds the wait
            await asyncio.sleep(src.timeout_for(endpoint))
            return None
        delay = self.link_latency_s(src.listen_port, int(endpoint[1]))
        if delay > 0:
            await asyncio.sleep(delay)
        return dest._serve(msg_type, meta, SIM_HOST)


class SimDHTProtocol(DHTProtocol):
    """The real protocol with the socket layer replaced.

    Overrides exactly the transport seam (``_transport``) plus
    listen/shutdown; envelope building, RPC accounting, reply parsing
    and the adaptive-timeout CONTRACT are the production code.  The RTT
    EMA normally lives in the connection pool, so the sim keeps its own
    per-endpoint EMA with the same fold rule (timeouts count)."""

    def __init__(self, network: SimNetwork, *args, clock=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.network = network
        self.rtt_ema: dict[Endpoint, float] = {}
        # the RTT stopwatch: wall by default (dht_swarm_sim measures real
        # event-loop latency), the shared VirtualClock under the macro-sim
        self._now = clock.monotonic if clock is not None else time.monotonic

    async def listen(self, host: str, port: int) -> int:
        self.listen_port = self.network.register(self)
        return self.listen_port

    async def shutdown(self) -> None:
        self.network.unregister(self)
        self._pools.close()  # never opened a socket; releases bookkeeping

    def timeout_for(self, endpoint: Endpoint) -> float:
        ema = self.rtt_ema.get(endpoint)
        if ema is not None:
            return min(
                max(ADAPTIVE_TIMEOUT_MULT * ema, ADAPTIVE_TIMEOUT_FLOOR),
                self.rpc_timeout,
            )
        return self.rpc_timeout

    async def _transport(
        self, endpoint: Endpoint, msg_type: str, meta: dict
    ) -> Optional[dict]:
        t0 = self._now()
        reply = await self.network.deliver(self, endpoint, msg_type, meta)
        elapsed = self._now() - t0
        ema = self.rtt_ema.get(endpoint)
        # timeouts fold too (the pool's latency-signal rule): a peer that
        # outgrows its budget raises its own budget next call
        self.rtt_ema[endpoint] = (
            elapsed if ema is None else 0.8 * ema + 0.2 * elapsed
        )
        if reply is None:
            raise asyncio.TimeoutError(f"sim peer {endpoint} unreachable")
        return reply


async def spawn_node(
    network: SimNetwork,
    initial_peers=(),
    rpc_timeout: float = 0.8,
    clock=None,
    **node_kwargs,
) -> DHTNode:
    node = DHTNode(rpc_timeout=rpc_timeout, **node_kwargs)
    node.protocol = SimDHTProtocol(
        network, node.node_id, node.routing_table, node.storage, rpc_timeout,
        clock=clock,
    )
    await node.protocol.listen(SIM_HOST, 0)
    if initial_peers:
        await node.bootstrap(initial_peers)
    return node
