"""Client-side connection pooling for the framed tensor RPC protocol.

Parity role: the reference's ``hivemind/utils/connection.py`` TCP helpers
(SURVEY.md §2; unverifiable refs, mount empty).  Here the helpers are a
small per-endpoint pool of persistent asyncio connections with two data
paths:

- **protocol v1** (the original contract): one RPC in flight per
  connection; extra concurrency opens extra sockets up to
  ``max_connections``; idle sockets are reused.
- **protocol v2** (negotiated per connection): request-id-tagged frames
  multiplex many in-flight RPCs over ONE socket — the fan-out's k calls
  to a peer share a connection instead of burning k sockets, and replies
  may interleave in any order.  Negotiation is a single ``hello``
  exchange on first contact; servers that don't speak it (old builds,
  the native C++ pump) answer with an ``error`` frame and the pool falls
  back to v1 transparently, reusing the probe socket.

Serialization is the CALLER's job on the hot path: ``rpc_prepared`` takes
a :class:`WireTensors` built off-loop (host thread) and the loop only
writes ready buffers via vectored ``writelines`` — the client-side mirror
of the server's no-work-on-the-loop rule (PR 1).
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
from typing import Optional, Sequence

from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.asyncio_utils import asyncio_timeout
from learning_at_home_tpu_torch.utils.profiling import timeline
from learning_at_home_tpu_torch.utils.serialization import (
    WireTensors,
    decode_wire_tensors,
    frame_nbytes,
    pack_frames,
    peek_header,
    recv_frame,
    send_frame_parts,
    unpack_message,
)

logger = logging.getLogger(__name__)

Endpoint = tuple[str, int]

# Features this client offers in its ``hello``; a server echoes the subset
# it speaks.  "mux" = request-id-tagged frames, many RPCs per socket;
# "codec" = the peer understands the dict wire form (quantized 8-bit
# codecs with per-tensor headers) — quantized payloads are only ever
# offered to pools whose hello echoed it (v1 peers, old builds and the
# DHT's own handlers transparently stay on the raw/bf16 wire).
CLIENT_FEATURES = ("mux", "codec")

# Exchanges moving at least this many bytes update the pool's bandwidth
# EMA: smaller exchanges are latency- and compute-dominated and would
# report the handshake (or a warmup compile), not the pipe.
BW_MIN_SAMPLE_BYTES = 256 << 10

# Cancellation message the quorum fan-out attaches when it cancels a
# straggler AFTER the grace period (``task.cancel(msg=...)``).  An
# explicit marker replaces the old 0.05 s elapsed-time floor: straggler
# cancels fold their elapsed wait into the RTT EMA however short the
# configured grace period, and teardown/shutdown cancels (no marker) are
# never mistaken for slowness evidence however loaded the box is
# (ADVICE.md round 5, item 3).
QUORUM_STRAGGLER_CANCEL = "lah-quorum-straggler-cancel"

_force_v1 = False


def force_protocol_v1(flag: bool) -> None:
    """Process-wide v1 pin (the legacy half of the dispatch A/B, and an
    escape hatch for wire debugging).  ``LAH_PROTO=v1`` does the same
    from the environment."""
    global _force_v1
    _force_v1 = bool(flag)


def _v2_enabled() -> bool:
    return not _force_v1 and os.environ.get("LAH_PROTO", "").lower() != "v1"


class RemoteCallError(RuntimeError):
    """The remote peer replied with an error frame."""


class _MuxConnection:
    """One v2 socket carrying many in-flight RPCs.

    A single reader task matches reply frames to pending futures by
    request id; writes from concurrent RPCs serialize on ``wlock`` (one
    vectored writelines per frame, never interleaved mid-frame).  All
    state is touched only from the owning event loop."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader, self.writer = reader, writer
        self.pending: dict[int, asyncio.Future] = {}
        self.wlock = asyncio.Lock()
        self.closed = False
        self._next_rid = 1
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop(), name="lah-mux-reader"
        )

    def next_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    async def _read_loop(self) -> None:
        try:
            while True:
                payload = await recv_frame(self.reader)
                try:
                    _, rid = peek_header(payload)
                except Exception as e:
                    raise ConnectionError(f"malformed mux reply header: {e}")
                fut = self.pending.pop(rid, None) if rid is not None else None
                if fut is not None and not fut.done():
                    fut.set_result(payload)
                # unmatched rid: the request timed out / was cancelled and
                # already gave up its pending slot — drop the late reply
        except asyncio.CancelledError:
            self._fail(ConnectionError("mux connection closed"))
            raise
        except Exception as e:
            self._fail(ConnectionError(f"mux connection lost: {e!r}"))

    def _fail(self, exc: Exception) -> None:
        self.closed = True
        self.writer.close()
        pending, self.pending = self.pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    def close(self) -> None:
        self.closed = True
        self._reader_task.cancel()
        self.writer.close()


class ConnectionPool:
    """Reusable connections to one endpoint; safe for concurrent rpc()."""

    def __init__(
        self,
        endpoint: Endpoint,
        max_connections: int = 8,
        max_inflight: int = 64,
        negotiate_v2: bool = True,
        require_v2: bool = False,
    ):
        self.endpoint = endpoint
        # v1 pin for protocols with their own message schema (the DHT's
        # handlers don't speak ``hello``; probing them would break the
        # connection instead of getting a clean error reply)
        self._negotiate_v2 = negotiate_v2
        # v2 REQUIREMENT for protocols whose semantics depend on
        # out-of-order replies (the averaging subsystem HOLDS avg_part
        # replies until a partition reduces — on v1's one-RPC-per-socket
        # discipline held replies starve the connection pool).  Such
        # pools ignore the process-wide legacy/A-B v1 pin
        # (``force_protocol_v1`` / LAH_CLIENT_PIPELINE=0), which exists
        # to A/B the DISPATCH path, not to break averaging.
        self._require_v2 = require_v2
        self.max_inflight = max_inflight
        self._free: asyncio.Queue = asyncio.Queue()
        self._sem = asyncio.Semaphore(max_connections)
        # v2 state: protocol is negotiated ONCE per pool (None = never
        # contacted); the mux connection reconnects lazily after faults
        self._proto: Optional[int] = None
        self._mux: Optional[_MuxConnection] = None
        self._nego_lock: Optional[asyncio.Lock] = None
        self._mux_sem = asyncio.Semaphore(max_inflight)
        # hot-path telemetry (always on — plain int adds): multiplexed
        # in-flight depth high-water mark and bytes handed to the wire
        self.inflight = 0
        self.inflight_max = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        # EMA of successful whole-exchange times (seconds), excluding the
        # local semaphore wait: covers network RTT AND the peer's queueing
        # + compute, so it doubles as a load signal.  Consumed by the
        # MoE's latency-aware expert selection (client/moe.py
        # ``latency_weight``); None until the first success.
        self.rtt_ema: Optional[float] = None
        # EMA of observed bytes/sec over large exchanges (request+reply
        # bytes / whole-exchange time — an UNDERestimate, since the
        # denominator includes the peer's queueing and compute, which
        # only makes the adaptive codec selector escalate sooner on
        # loaded pools).  None until a ≥BW_MIN_SAMPLE_BYTES exchange.
        self.bw_ema: Optional[float] = None
        # features the peer's hello_ok echoed; () until v2 negotiation
        # succeeds (v1 pools never advertise any)
        self.features: tuple = ()

    # ---- shared plumbing ----

    async def _acquire(self):
        while not self._free.empty():
            reader, writer = self._free.get_nowait()
            if not writer.is_closing():
                return reader, writer
            writer.close()
        host, port = self.endpoint
        return await asyncio.open_connection(host, port)

    def _update_rtt(self, dt: float) -> None:
        self.rtt_ema = (
            dt if self.rtt_ema is None else 0.8 * self.rtt_ema + 0.2 * dt
        )

    def supports(self, feature: str) -> bool:
        """True once the peer's hello_ok advertised ``feature`` — the
        per-pool pin the codec selection consults before offering any
        quantized payload."""
        return feature in self.features

    async def ensure_negotiated(self, timeout: Optional[float] = None) -> None:
        """Force the hello exchange NOW if this pool has never contacted
        its peer, so :meth:`supports` answers definitively before the
        caller commits to a wire encoding (the averaging chunk sender's
        hook; idempotent, serialized on the negotiation lock)."""
        if self._proto is None and self._negotiate_v2 and (
            self._require_v2 or _v2_enabled()
        ):
            await self._negotiate(timeout)

    @staticmethod
    def _is_latency_signal(e: BaseException) -> bool:
        """Failures whose elapsed time IS slowness evidence: timeouts and
        quorum straggler cancels (explicitly marked by the fan-out) fold
        into the EMA, or peers slower than the timeout would never be
        penalized at all.  Fast failures (refused connection, reset) say
        nothing about latency and must NOT reward a broken peer with a
        small EMA; teardown/shutdown cancellations carry no marker and
        are unrelated to the peer."""
        return isinstance(e, TimeoutError) or (
            isinstance(e, asyncio.CancelledError)
            and bool(e.args)
            and e.args[0] == QUORUM_STRAGGLER_CANCEL
        )

    def _finish(self, payload: bytes, dt: float, sent_bytes: int = 0):
        self.bytes_received += len(payload)
        reply_type, reply_tensors, reply_meta = unpack_message(payload)
        if reply_type == "error":
            # error replies are typically the FASTEST exchanges (no expert
            # compute); counting them would steer latency-aware selection
            # toward broken peers — do not update the EMA
            raise RemoteCallError(
                f"{self.endpoint}: {reply_meta.get('message', 'unknown error')}"
            )
        self._update_rtt(dt)
        moved = sent_bytes + len(payload)
        if moved >= BW_MIN_SAMPLE_BYTES and dt > 0:
            bw = moved / dt
            self.bw_ema = (
                bw if self.bw_ema is None else 0.8 * self.bw_ema + 0.2 * bw
            )
        rwire = reply_meta.get("wire") if isinstance(reply_meta, dict) else None
        if isinstance(rwire, dict):
            # quantized reply: validate headers HERE (a malformed reply is
            # a failed exchange), but wrap as LazyDecode — the dequantize
            # runs on the consumer's host thread, not this event loop
            try:
                reply_tensors = decode_wire_tensors(
                    reply_tensors, rwire, lazy=True
                )
            except ValueError as e:
                raise RemoteCallError(
                    f"{self.endpoint}: malformed wire codec reply: {e}"
                )
        return reply_tensors, reply_meta

    # ---- public entry points ----

    async def rpc(
        self,
        msg_type: str,
        tensors: Sequence = (),
        meta: Optional[dict] = None,
        timeout: Optional[float] = None,
    ):
        """One request/response exchange; returns (tensors, meta).

        Serializes ``tensors`` at the await point (i.e. ON the loop when
        called from it) — fine for control-plane calls; the dispatch hot
        path prepares off-loop and uses :meth:`rpc_prepared`.

        ``timeout`` bounds the WHOLE exchange including connection
        establishment — a black-holed endpoint (dropped SYNs) must not
        stall the caller for the OS connect timeout."""
        # documented control-plane exception (see docstring): hot-path
        # callers use rpc_prepared with payloads built off-loop; rpc()
        # serializes small control frames only
        return await self.rpc_prepared(
            msg_type,
            WireTensors.prepare(tensors),  # lah-lint: ignore[R1]
            meta, timeout,
        )

    async def rpc_prepared(
        self,
        msg_type: str,
        wire: WireTensors,
        meta: Optional[dict] = None,
        timeout: Optional[float] = None,
    ):
        """One exchange from a pre-serialized payload (built off-loop).

        Routes to the multiplexed v2 path when the endpoint negotiated
        it, the one-RPC-per-socket v1 path otherwise (or when v1 is
        forced).

        A ``{"trace": id}`` entry in ``meta`` (distributed tracing,
        docs/OBSERVABILITY.md) stamps this exchange's ``rpc.<msg_type>``
        span with the request's trace id — the client-side anchor the
        server's stack/dispatch/materialize spans nest inside."""
        with timeline.span(
            f"rpc.{msg_type}", trace=(meta or {}).get("trace")
        ):
            if (self._require_v2 or _v2_enabled()) and self._negotiate_v2:
                if self._proto is None:
                    await self._negotiate(timeout)
                if self._proto == 2:
                    try:
                        return await self._rpc_mux(msg_type, wire, meta, timeout)
                    except _ProtocolDowngraded:
                        pass  # peer restarted as v1 mid-stream: fall through
            return await self._rpc_v1(msg_type, wire, meta, timeout)

    # ---- protocol v1: one RPC per socket ----

    async def _rpc_v1(self, msg_type, wire, meta, timeout):
        loop = asyncio.get_running_loop()
        async with self._sem:
            writer = None
            t0 = loop.time()
            try:
                async with asyncio_timeout(timeout):
                    reader, writer = await self._acquire()
                    parts = pack_frames(msg_type, wire, meta)
                    sent = frame_nbytes(parts)
                    self.bytes_sent += sent
                    await send_frame_parts(writer, parts)
                    payload = await recv_frame(reader)
            except BaseException as e:
                if writer is not None:
                    writer.close()  # connection state unknown → do not reuse
                if self._is_latency_signal(e):
                    self._update_rtt(loop.time() - t0)
                raise
            dt = loop.time() - t0
            self._free.put_nowait((reader, writer))
        return self._finish(payload, dt, sent)

    # ---- protocol v2: negotiation + multiplexed exchanges ----

    def _lazy_nego_lock(self) -> asyncio.Lock:
        if self._nego_lock is None:
            self._nego_lock = asyncio.Lock()
        return self._nego_lock

    async def _negotiate(self, timeout) -> None:
        """One ``hello`` exchange decides the pool's protocol.  A v2
        server echoes the features it speaks (the socket becomes the mux
        connection); anything else — an ``error`` reply from an old
        server or the native pump — pins v1, and the probe socket is
        reused for v1 traffic (its handler already served the error and
        is waiting for the next frame)."""
        async with self._lazy_nego_lock():
            if self._proto is not None:
                return
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            writer = None
            try:
                async with asyncio_timeout(timeout):
                    reader, writer = await asyncio.open_connection(*self.endpoint)
                    await send_frame_parts(
                        writer,
                        pack_frames(
                            "hello", WireTensors.prepare(),
                            {"features": list(CLIENT_FEATURES)},
                        ),
                    )
                    payload = await recv_frame(reader)
            except BaseException as e:
                if writer is not None:
                    writer.close()
                # a peer too slow to even answer hello is slowness
                # evidence like any timed-out exchange — fold it, or
                # black-holed endpoints would never be penalized
                if self._is_latency_signal(e):
                    self._update_rtt(loop.time() - t0)
                raise  # endpoint unreachable/slow: protocol stays unknown
            try:
                rtype, _, rmeta = unpack_message(payload)
            except Exception:
                writer.close()
                raise
            if rtype == "hello_ok" and "mux" in (rmeta.get("features") or []):
                self._proto = 2
                self.features = tuple(
                    f for f in CLIENT_FEATURES
                    if f in (rmeta.get("features") or [])
                )
                self._mux = _MuxConnection(reader, writer)
            elif self._require_v2:
                # a require_v2 pool must NEVER silently run v1 (held
                # replies would starve the socket pool); leave the
                # protocol unknown so a later retry — e.g. the right
                # peer reclaiming a recycled port — can renegotiate
                writer.close()
                raise RemoteCallError(
                    f"{self.endpoint}: peer does not speak protocol v2, "
                    "which this pool requires"
                )
            else:
                self._proto = 1
                self._free.put_nowait((reader, writer))

    async def _ensure_mux(self) -> _MuxConnection:
        mux = self._mux
        if mux is not None and not mux.closed:
            return mux
        async with self._lazy_nego_lock():
            if self._mux is not None and not self._mux.closed:
                return self._mux
            writer = None
            try:
                reader, writer = await asyncio.open_connection(*self.endpoint)
                await send_frame_parts(
                    writer,
                    pack_frames(
                        "hello", WireTensors.prepare(),
                        {"features": list(CLIENT_FEATURES)},
                    ),
                )
                payload = await recv_frame(reader)
                rtype, _, rmeta = unpack_message(payload)
            except BaseException:
                # a flapping peer must not leak one FD per reconnect
                # attempt (_rpc_mux's cleanup only sees mux=None here)
                if writer is not None:
                    writer.close()
                raise
            if rtype != "hello_ok" or "mux" not in (rmeta.get("features") or []):
                if self._require_v2:
                    # never demote a require_v2 pool (see _negotiate);
                    # fail the exchange loudly instead
                    writer.close()
                    self._proto = None
                    raise RemoteCallError(
                        f"{self.endpoint}: peer stopped speaking protocol "
                        "v2, which this pool requires"
                    )
                # the peer restarted as an older build: demote the pool
                self._proto = 1
                self.features = ()
                self._free.put_nowait((reader, writer))
                raise _ProtocolDowngraded()
            self.features = tuple(
                f for f in CLIENT_FEATURES
                if f in (rmeta.get("features") or [])
            )
            self._mux = _MuxConnection(reader, writer)
            return self._mux

    async def _rpc_mux(self, msg_type, wire, meta, timeout):
        loop = asyncio.get_running_loop()
        async with self._mux_sem:
            t0 = loop.time()
            self.inflight += 1
            if self.inflight > self.inflight_max:
                self.inflight_max = self.inflight
            mux = rid = None
            try:
                async with asyncio_timeout(timeout):
                    mux = await self._ensure_mux()
                    rid = mux.next_rid()
                    fut = loop.create_future()
                    mux.pending[rid] = fut
                    parts = pack_frames(msg_type, wire, meta, rid=rid)
                    sent = frame_nbytes(parts)
                    self.bytes_sent += sent
                    async with mux.wlock:
                        await send_frame_parts(mux.writer, parts)
                    payload = await fut
            except _ProtocolDowngraded:
                raise
            except BaseException as e:
                if mux is not None and rid is not None:
                    mux.pending.pop(rid, None)
                if isinstance(e, (ConnectionError, OSError)) and mux is not None:
                    # a broken mux socket fails every rider; drop it so the
                    # next request reconnects (and re-hellos)
                    mux.close()
                    if self._mux is mux:
                        self._mux = None
                if self._is_latency_signal(e):
                    self._update_rtt(loop.time() - t0)
                raise
            finally:
                self.inflight -= 1
            return self._finish(payload, loop.time() - t0, sent)

    def close(self) -> None:
        while not self._free.empty():
            _, writer = self._free.get_nowait()
            writer.close()
        if self._mux is not None:
            self._mux.close()
            self._mux = None


class _ProtocolDowngraded(Exception):
    """Internal: the peer no longer speaks v2; retry the exchange on v1."""


class PoolRegistry:
    """endpoint → ConnectionPool map shared by all client stubs on a loop.

    ``get`` may be called from the event loop AND from host threads (the
    blocking client paths resolve their pool before entering the loop),
    so creation is guarded by a lock — without it two racing first-contact
    ``get``\\s could register two pools for one endpoint, with RTT-EMA
    updates landing on the orphan (the race ``peek``'s docstring used to
    merely document)."""

    def __init__(
        self,
        max_connections_per_endpoint: int = 8,
        negotiate_v2: bool = True,
        require_v2: bool = False,
        max_inflight: int = 64,
    ):
        self._pools: dict[Endpoint, ConnectionPool] = {}
        self._lock = sanitizer.lock("connection.pool_registry")
        self.max_connections = max_connections_per_endpoint
        self.negotiate_v2 = negotiate_v2
        self.require_v2 = require_v2
        self.max_inflight = max_inflight

    def get(self, endpoint: Endpoint) -> ConnectionPool:
        endpoint = (endpoint[0], int(endpoint[1]))
        pool = self._pools.get(endpoint)
        if pool is None:
            with self._lock:
                pool = self._pools.get(endpoint)
                if pool is None:
                    pool = ConnectionPool(
                        endpoint, self.max_connections,
                        max_inflight=self.max_inflight,
                        negotiate_v2=self.negotiate_v2,
                        require_v2=self.require_v2,
                    )
                    self._pools[endpoint] = pool
        return pool

    def peek(self, endpoint: Endpoint) -> Optional[ConnectionPool]:
        """Non-creating lookup: read-only consumers (latency bias) must
        not instantiate pools for peers that were never contacted."""
        return self._pools.get((endpoint[0], int(endpoint[1])))

    def pools(self) -> list[ConnectionPool]:
        """Snapshot of live pools (telemetry readers)."""
        with self._lock:
            return list(self._pools.values())

    def close(self) -> None:
        with self._lock:
            pools = list(self._pools.values())
            self._pools.clear()
        for pool in pools:
            pool.close()
