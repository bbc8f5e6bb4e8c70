"""Server-side RPC dispatch: forward / backward / info over framed TCP.

The port's copy of the JAX package's ``server/connection_handler.py``:
the same wire, ops and validation; ``replica``, ``handoff``, ``migrate``
and ``drain`` answer with an ``error`` frame (``LATER_OPS``).

Contract from the reference's ``hivemind/server/connection_handler.py``
(SURVEY.md §2; unverifiable refs, mount empty): accept connections, parse
message type, deserialize tensors, submit to the right expert's pool, await
the future, reply.  Reference runs one-or-more *processes*; here it is pure
asyncio on the server's event loop — each connection is a coroutine, and
the expensive work (XLA execution) happens on the Runtime thread anyway.

Wire protocol (see utils/serialization.py for framing):

- ``forward``:  meta {uid}, tensors [*inputs]            → ``result`` [*outputs]
- ``backward``: meta {uid, n_inputs}, tensors [*inputs, *grad_outputs]
                                                          → ``result`` [*input_grads]
- ``info``:     meta {uid}                                → ``result`` meta=info
- ``multi``:    meta {op: forward|backward,
                      parts: [{uid, n_tensors}...]},
                tensors = concatenation in parts order     → ``result``
                meta {parts: [{uid, ok, n_tensors, message?}...]},
                tensors = concatenation of successful parts' outputs.
                ONE request serves every expert a client picked on this
                server — the swarm fan-out pays per-request overhead per
                PEER, not per expert (failure granularity is per-peer
                anyway: co-hosted experts die together).
- ``hello``:    meta {features: [...]}                    → ``hello_ok``
                meta {features: intersection} and the connection becomes
                protocol v2: requests carry a header ``rid`` which the
                reply echoes, many requests may be in flight, replies
                arrive in COMPLETION order (docs/PROTOCOL.md).
- errors                                                  → ``error`` meta {message}

Wire compression: a request whose meta carries ``{"wire": "bfloat16"}``
(or ``"float16"``) declares that its floating tensors were downcast to
that dtype for transport.  The handler upcasts them to float32 BEFORE the
task pool (so batches stay one-dtype and each bucket compiles once) and
downcasts the reply's floating tensors back to the wire dtype.  Halves
activation/grad bytes on the DCN tier — the 2048-row swarm dispatches are
payload-bound (BASELINE.md round-2: 300 ms p50).
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

import numpy as np

from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.profiling import timeline
from learning_at_home_tpu_torch.utils.serialization import (
    WIRE_CODECS,
    WIRE_DTYPES,
    WireTensors,
    decode_wire_tensors,
    encode_wire_tensors,
    frame_nbytes,
    is_float_dtype,
    pack_frames,
    peek_header,
    recv_frame,
    send_frame_parts,
    unpack_message,
    wire_cast,
    wire_codec_name,
)

if TYPE_CHECKING:
    from learning_at_home_tpu_torch.server.server import Server

logger = logging.getLogger(__name__)

# Features the asyncio transport speaks; a client ``hello`` gets back the
# intersection with what it offered.  The native C++ pump does NOT
# negotiate (its dispatcher replies through handler._dispatch, where
# ``hello`` lands in the unknown-message error path), so clients fall
# back to protocol v1 against it — by design, not by accident.
# ``codec``: the request may carry the DICT wire form (quantized 8-bit
# codecs with per-tensor headers — serialization.py, docs/PROTOCOL.md);
# clients never offer quantized payloads to peers that did not echo it.
SERVER_FEATURES = ("mux", "codec")

# Control-plane ops of the JAX package's handler that the port does not
# serve yet (graceful drain, live migration, replicas): each is answered
# with an ``error`` frame naming what is missing.
LATER_OPS = {
    "replica": "expert replicas (add_replica, ReplicaSync) are not ported",
    "handoff": "live expert migration (server/lifecycle.py) is not ported",
    "migrate": "live expert migration (server/lifecycle.py) is not ported",
    "drain": "graceful drain (server/lifecycle.py) is not ported",
}

# Reply payloads at least this large (decoded bytes) quantize in the
# default executor, not on the serving loop — the server-side mirror of
# the client's encode-on-the-host-thread contract.  Small replies encode
# inline: a thread hop costs more than the quantize itself.
ENCODE_OFFLOOP_BYTES = 1 << 18


def upcast_from_wire(tensors, wire: str | None) -> list:
    """Wire-compressed floating tensors → float32 compute dtype.

    A declared wire dtype is a CONTRACT: every floating payload must
    actually carry it.  Keying the upcast on each tensor's observed dtype
    would silently launder a client-side encoding bug (e.g. wire=bfloat16
    declared, float64 sent) into a normal-looking float32 batch; reject
    the mismatch so the client gets an error reply instead (round-4
    advisor)."""
    if not wire:
        return list(tensors)
    expected = np.dtype(wire)
    out = []
    for t in tensors:
        arr = np.asarray(t)
        if is_float_dtype(arr.dtype):
            if arr.dtype != expected:
                raise ValueError(
                    f"request declares wire={wire} but carries a "
                    f"{arr.dtype} floating tensor — client-side encoding "
                    "bug; refusing to upcast"
                )
            out.append(arr.astype(np.float32))
        else:
            out.append(t)
    return out


def downcast_to_wire(tensors, wire: str | None) -> list:
    """Reply's floating tensors → the requester's wire dtype."""
    return wire_cast(tensors, wire or None)


def decode_request_wire(tensors, wire) -> list:
    """Request payload → compute tensors, both wire meta forms.

    Legacy string form: the strict eager upcast above.  Dict (codec)
    form: per-tensor validation with QUANTIZED tensors wrapped as
    :class:`~learning_at_home_tpu_torch.utils.serialization.LazyDecode` — the
    dequantize runs on the Runtime thread, directly into the batch's
    staging buffer, never on this serving loop."""
    if isinstance(wire, dict):
        return decode_wire_tensors(tensors, wire, lazy=True)
    return upcast_from_wire(tensors, wire)


async def encode_reply_wire(tensors, wire) -> tuple[list, dict | None]:
    """Reply tensors → the requester's wire encoding.  Returns
    ``(wire_tensors, reply_wire_meta)``; the meta is None for the legacy
    forms (the downcast dtype is visible in the tensor specs).  Quantized
    encodes of large replies run in the default executor so the serving
    loop never spends milliseconds quantizing a 4 MB batch reply."""
    if not isinstance(wire, dict):
        return downcast_to_wire(tensors, wire), None
    codec = wire.get("c")
    nbytes = sum(np.asarray(t).nbytes for t in tensors)
    if nbytes >= ENCODE_OFFLOOP_BYTES:
        return await asyncio.to_thread(encode_wire_tensors, tensors, codec)
    # deliberate on-loop encode: below ENCODE_OFFLOOP_BYTES the thread
    # hop costs more than the quantize itself — scoped sanitizer pass,
    # so any OTHER on-loop encode still trips the check
    with sanitizer.allowed("EncodedBatch.encode"):
        # lah-lint: ignore[R1] size-gated: this branch only runs below
        # ENCODE_OFFLOOP_BYTES, where a thread hop costs more than the
        # quantize; large replies took the to_thread branch above
        return encode_wire_tensors(tensors, codec)


class ConnectionHandler:
    """Dispatches one TCP connection's requests to expert task pools."""

    def __init__(self, server: "Server"):
        self.server = server

    async def handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        muxed = False  # becomes True after a ``hello`` negotiates v2
        wlock = asyncio.Lock()  # one frame at a time on the socket
        inflight: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    payload = await recv_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                try:
                    msg_type, rid = peek_header(payload)
                except Exception:
                    msg_type, rid = None, None  # _dispatch makes the error reply
                if msg_type == "hello":
                    # protocol v2 feature negotiation: echo the feature
                    # subset we speak; the connection is multiplexed from
                    # here on (request-id-tagged frames, replies in
                    # completion order)
                    # hello meta is peer-supplied: a non-map meta or a
                    # non-list offer negotiates the empty feature set
                    # instead of tearing down the connection
                    try:
                        _, _, hmeta = unpack_message(payload)
                        offered = hmeta.get("features")
                    except Exception:
                        offered = None
                    if not isinstance(offered, list):
                        offered = []
                    common = [f for f in SERVER_FEATURES if f in offered]
                    muxed = "mux" in common
                    await self._send(
                        writer, wlock,
                        pack_frames(
                            "hello_ok", WireTensors.prepare(),
                            {"features": common}, rid=rid,
                        ),
                    )
                    continue
                if muxed and rid is not None:
                    # serve concurrently; each reply carries its request id
                    # so the client can match out-of-order completions
                    task = asyncio.get_running_loop().create_task(
                        self._serve_muxed(payload, rid, writer, wlock)
                    )
                    inflight.add(task)
                    task.add_done_callback(inflight.discard)
                    continue
                reply = await self._dispatch(payload, rid)
                if self.server.chaos is not None:
                    if not await self.server.chaos.before_reply(
                        len(payload) + frame_nbytes(reply) - 4
                    ):
                        continue  # injected drop: client sees a timeout
                await self._send(writer, wlock, reply)
        except Exception:
            logger.exception("connection handler failed for peer %s", peer)
        finally:
            for task in inflight:
                task.cancel()
            writer.close()

    @staticmethod
    async def _send(writer, wlock: asyncio.Lock, parts: list) -> None:
        async with wlock:
            await send_frame_parts(writer, parts)

    @staticmethod
    def _count_wire_bytes(wire, nbytes: int, direction: str) -> None:
        """``lah_server_wire_bytes_total{codec=,direction=}``: data-plane
        bytes by negotiated wire codec — the observable the byte-reduction
        acceptance gates on.  One labeled counter inc per request/reply
        (never per row); label cardinality is bounded by construction
        (|WIRE_CODECS| x 2)."""
        from learning_at_home_tpu_torch.utils.metrics import registry

        registry.counter(
            "lah_server_wire_bytes_total",
            "request/reply payload bytes by wire codec",
        ).inc(nbytes, codec=wire_codec_name(wire), direction=direction)

    async def _serve_muxed(
        self, payload: bytes, rid: int, writer, wlock: asyncio.Lock
    ) -> None:
        try:
            reply = await self._dispatch(payload, rid)
            if self.server.chaos is not None:
                if not await self.server.chaos.before_reply(
                    len(payload) + frame_nbytes(reply) - 4
                ):
                    return  # injected drop: client sees a timeout
            await self._send(writer, wlock, reply)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("muxed request %d failed", rid)

    # ---- per-op execution (validation + pool submit), shared by the
    #      single-expert and multi-expert paths; raises on any failure ----

    async def _run_forward(
        self, uid: str, tensors, wire=None,
        trace: str | None = None,
    ) -> tuple[list, dict | None]:
        backend = self.server.experts.get(uid)
        if backend is None:
            raise ValueError(f"unknown expert uid: {uid!r}")
        if len(tensors) != backend.n_inputs:
            # reject HERE: a wrong-arity task reaching the pool would
            # poison the whole formed batch (innocent co-batched
            # requests fail with it)
            raise ValueError(
                f"expert {uid} takes {backend.n_inputs} inputs, "
                f"got {len(tensors)}"
            )
        tensors = decode_request_wire(tensors, wire)
        result = await self.server.forward_pools[uid].submit_task(
            *tensors, trace=trace
        )
        return await encode_reply_wire(result, wire)

    async def _run_backward(
        self, uid: str, tensors, declared_n_inputs, wire=None,
        trace: str | None = None,
    ) -> tuple[list, dict | None]:
        backend = self.server.experts.get(uid)
        if backend is None:
            raise ValueError(f"unknown expert uid: {uid!r}")
        n_inputs = (
            int(declared_n_inputs)
            if declared_n_inputs is not None
            else backend.n_inputs
        )
        if n_inputs != backend.n_inputs:
            raise ValueError(
                f"expert {uid} takes {backend.n_inputs} inputs, "
                f"request declared {n_inputs}"
            )
        # mirror the forward guard: a backward request carries the
        # inputs PLUS the grad_outputs; wrong arity in EITHER
        # direction must be rejected before it can poison a formed
        # batch (exact check once n_outputs is known, i.e. after
        # warmup or the first forward)
        expected = (
            backend.n_inputs + backend.n_outputs
            if backend.n_outputs is not None
            else None
        )
        if (expected is not None and len(tensors) != expected) or (
            len(tensors) <= backend.n_inputs
        ):
            raise ValueError(
                f"backward for {uid} needs "
                f"{expected or f'>{backend.n_inputs}'} tensors "
                f"(inputs + grad_outputs), got {len(tensors)}"
            )
        tensors = decode_request_wire(tensors, wire)
        result = await self.server.backward_pools[uid].submit_task(
            *tensors, trace=trace
        )
        return await encode_reply_wire(result, wire)

    async def _run_multi(self, tensors, meta, rid=None, trace=None) -> list:
        """Fan a merged request out to the local expert pools concurrently;
        per-part failures are reported per part, not as a whole-request
        error.  All meta is peer-supplied — validate structurally."""
        op = meta.get("op")
        parts = meta.get("parts")
        wire = meta.get("wire")
        if op not in ("forward", "backward") or not isinstance(parts, list):
            raise ValueError("multi needs op forward|backward and parts list")
        # dict (codec) wire form: headers align 1:1 with the request's
        # tensor concat — slice them per part exactly like the tensors
        wire_headers = None
        if isinstance(wire, dict):
            wire_headers = wire.get("h")
            if not isinstance(wire_headers, list) or len(wire_headers) != len(
                tensors
            ):
                raise ValueError(
                    "multi wire codec headers do not align with the "
                    "request's tensors"
                )
        slices = []
        off = 0
        for part in parts:
            if not isinstance(part, dict):
                raise ValueError("multi part must be a dict")
            n = part.get("n_tensors")
            if not isinstance(n, int) or n < 0 or off + n > len(tensors):
                raise ValueError("multi part tensor counts are inconsistent")
            part_wire = wire
            if wire_headers is not None:
                part_wire = {"c": wire.get("c"),
                             "h": wire_headers[off : off + n]}
            slices.append((part, tensors[off : off + n], part_wire))
            off += n
        if off != len(tensors):
            raise ValueError(
                f"multi parts cover {off} tensors, request has {len(tensors)}"
            )

        async def run_part(part, part_tensors, part_wire):
            uid = part.get("uid")
            if op == "forward":
                return await self._run_forward(
                    uid, part_tensors, part_wire, trace
                )
            return await self._run_backward(
                uid, part_tensors, part.get("n_inputs"), part_wire, trace
            )

        settled = await asyncio.gather(
            *(run_part(p, t, w) for p, t, w in slices), return_exceptions=True
        )
        reply_parts, reply_tensors, reply_headers = [], [], []
        for (part, _t, _w), result in zip(slices, settled):
            uid = part.get("uid")
            if isinstance(result, BaseException):
                logger.warning(
                    "multi %s part failed for expert %s: %s", op, uid, result
                )
                reply_parts.append(
                    {"uid": uid, "ok": False,
                     "message": f"{type(result).__name__}: {result}"}
                )
            else:
                part_tensors, part_wire = result
                reply_parts.append(
                    {"uid": uid, "ok": True, "n_tensors": len(part_tensors)}
                )
                reply_tensors.extend(part_tensors)
                if isinstance(part_wire, dict):
                    reply_headers.extend(part_wire["h"])
        reply_meta = {"parts": reply_parts}
        if isinstance(wire, dict) and len(reply_headers) == len(reply_tensors) \
                and reply_tensors:
            # per-part encodes concatenate like the tensors themselves:
            # one header entry per reply tensor, in parts order.  (A dict
            # request whose codec is a plain downcast produces no headers
            # — the reply then travels like the legacy form.)
            reply_meta["wire"] = {"c": wire.get("c"), "h": reply_headers}
        if trace is not None:
            reply_meta["trace"] = trace  # echo: the reply joins the trace
        # reply prepare is an O(#tensors) spec walk over zero-copy
        # memoryviews — the O(bytes) work (encode/downcast) already ran
        # off-loop or in the executor above
        return pack_frames(
            "result",
            WireTensors.prepare(reply_tensors),  # lah-lint: ignore[R1]
            reply_meta, rid=rid,
        )

    def _server_stats(self, include_spans: bool = False) -> dict:
        """Server-WIDE counters in one round trip (the ``info`` op is
        per-expert): ops dashboards and swarm telemetry poll this instead
        of fanning out one RPC per hosted expert.

        ``include_spans`` (request meta ``{"spans": true}``) adds the
        Timeline span summaries.  Opt-in on purpose: summarizing a full
        span deque on a PROFILED server is O(100k) work that would
        otherwise run on this serving loop every time a monitor polls —
        the dedicated-loop ``/metrics.json`` endpoint is the stall-free
        default surface for span data."""
        srv = self.server
        experts = {}
        total_updates = 0
        for uid, backend in srv.experts.items():
            experts[uid] = backend.update_count
            total_updates += backend.update_count
        pools = {}
        for kind, pool_map in (
            ("forward", srv.forward_pools), ("backward", srv.backward_pools)
        ):
            rows = padded = batches = cold = hits = 0
            stack_ms = 0.0
            buckets: dict[int, int] = {}
            for p in pool_map.values():
                rows += p.total_rows
                padded += p.padded_rows
                batches += p.batches_formed
                stack_ms += p.stack_time * 1e3
                bs = p.bucket_stats()
                cold += bs["cold_compiles"]
                hits += bs["cache_hits"]
                for bucket, n in bs["batches_per_bucket"].items():
                    buckets[bucket] = buckets.get(bucket, 0) + n
            pools[kind] = {
                "rows": rows, "padded_rows": padded,
                "batches_formed": batches,
                "padding_waste": padded / (rows + padded) if rows + padded else 0.0,
                "stack_time_ms": round(stack_ms, 2),
                # string keys: the msgpack wire rejects int map keys
                "batches_per_bucket": {
                    str(b): n for b, n in sorted(buckets.items())
                },
                "bucket_cold_compiles": cold,
                "bucket_cache_hits": hits,
            }
        from learning_at_home_tpu_torch.utils.metrics import registry
        from learning_at_home_tpu_torch.utils.telemetry import (
            link_snapshot as _link_snapshot,
        )

        stats = {
            "n_experts": len(srv.experts),
            "update_count_total": total_updates,
            "update_count": experts,
            # replication observability (ISSUE 8): which hosted uids are
            # replicas, and which experts are currently hot (queue-depth
            # EMA over the threshold — the replicas.wanted signal)
            "replicas": sorted(srv.replica_uids),
            "hot_experts": srv.hot_experts(),
            # elastic lifecycle (ISSUE 9): drain state, uptime, restarts
            # and migration counters — one poll tells an operator whether
            # this peer is SERVING, mid-drain, or freshly rejoined
            "lifecycle": srv.lifecycle_info(),
            "pools": pools,
            # hot-path pipeline counters: queue depth, stacking/materialize
            # time, overlap fraction, staging-buffer reuse (ISSUE 1)
            "runtime": srv.runtime.stats(),
            # ALWAYS-ON headline registry (ISSUE 4): the ~10 production
            # counters are never empty just because LAH_PROFILE is off —
            # this is the same snapshot the /metrics.json endpoint serves
            "metrics": registry.snapshot(),
            # placement measurement + actuation (ISSUE 16): this
            # server's measured per-destination link EMAs and its
            # outbound-migration state — the rebalancer's stats-RPC view
            "links": _link_snapshot(),
            "placement": srv.placement_info(),
        }
        if include_spans:
            stats["spans"] = timeline.summary()
        if srv.chaos is not None:
            stats["chaos"] = {
                "delays": srv.chaos.injected_delays,
                "stragglers": srv.chaos.injected_stragglers,
                "drops": srv.chaos.injected_drops,
            }
        return stats

    async def _dispatch(self, payload: bytes, rid=None) -> list:
        """Serve one request; returns the reply as vectored frame parts
        (``pack_frames`` output — header buffer + raw tensor blobs), so
        the reply payload is never joined into one bytestring on this
        loop.  ``rid`` (protocol v2) is echoed into the reply header.

        A ``{"trace": id}`` meta entry (distributed tracing) is
        peer-supplied: it is structurally validated, stamped onto this
        request's server-side spans and the downstream pool/runtime
        spans, and ECHOED into the reply meta so the client can join the
        round trip.  Absent trace → exactly the old behavior."""
        trace = None

        def reply(msg_type: str, tensors=(), meta=None) -> list:
            if trace is not None:
                meta = {**(meta or {}), "trace": trace}
            return pack_frames(
                msg_type, WireTensors.prepare(tensors), meta, rid=rid
            )

        def wire_reply(result: tuple) -> list:
            """``result`` is an ``encode_reply_wire`` pair: tensors plus
            the reply's wire meta (dict codec form only — the legacy
            downcast needs no meta, its dtype is in the tensor specs)."""
            tensors, rwire = result
            meta = {"wire": rwire} if isinstance(rwire, dict) else None
            return reply("result", tensors, meta)

        try:
            msg_type, tensors, meta = unpack_message(payload)
            if not isinstance(meta, dict):
                raise ValueError(
                    f"meta must be a map, got {type(meta).__name__}"
                )
        except Exception as e:
            return reply("error", meta={"message": f"malformed request: {e}"})
        uid = meta.get("uid")
        wire = meta.get("wire")
        trace = meta.get("trace")
        if not (isinstance(trace, str) and 0 < len(trace) <= 64):
            trace = None  # malformed/absent: never trust peer-supplied meta
        if isinstance(wire, str) and wire not in WIRE_DTYPES:
            return reply(
                "error",
                meta={"message": f"unsupported wire dtype {wire!r}; "
                      f"supported: {WIRE_DTYPES}"},
            )
        if isinstance(wire, dict) and wire.get("c") not in WIRE_CODECS:
            return reply(
                "error",
                meta={"message": f"unsupported wire codec {wire.get('c')!r}; "
                      f"supported: {WIRE_CODECS}"},
            )
        if wire is not None and not isinstance(wire, (str, dict)):
            return reply(
                "error",
                meta={"message": "malformed wire meta: expected a dtype "
                      "string or a codec map"},
            )
        data_plane = msg_type in ("forward", "backward", "multi")
        if data_plane:
            self._count_wire_bytes(wire, len(payload), "rx")
        try:
            with timeline.span(f"server.request.{msg_type}", trace=trace):
                if msg_type == "forward":
                    out = wire_reply(
                        await self._run_forward(uid, tensors, wire, trace)
                    )
                    self._count_wire_bytes(wire, frame_nbytes(out), "tx")
                    return out
                elif msg_type == "backward":
                    out = wire_reply(
                        await self._run_backward(
                            uid, tensors, meta.get("n_inputs"), wire, trace
                        )
                    )
                    self._count_wire_bytes(wire, frame_nbytes(out), "tx")
                    return out
                elif msg_type == "multi":
                    out = await self._run_multi(tensors, meta, rid, trace)
                    self._count_wire_bytes(wire, frame_nbytes(out), "tx")
                    return out
                elif msg_type == "info":
                    backend = self.server.experts.get(uid)
                    if backend is None:
                        raise ValueError(f"unknown expert uid: {uid!r}")
                    return reply("result", meta=backend.get_info())
                elif msg_type in LATER_OPS:
                    # the lifecycle and replication control plane is not
                    # in the port yet: never answer it with a success
                    return reply(
                        "error",
                        meta={"message": f"{msg_type!r} is not supported "
                              f"by this server: {LATER_OPS[msg_type]}"},
                    )
                elif msg_type == "stats":
                    return reply(
                        "result",
                        meta=self._server_stats(
                            include_spans=bool(meta.get("spans"))
                        ),
                    )
                else:
                    return reply(
                        "error",
                        meta={"message": f"unknown message type {msg_type!r}"},
                    )
        except Exception as e:
            logger.exception("request %s failed (expert %s)", msg_type, uid)
            return reply("error", meta={"message": f"{type(e).__name__}: {e}"})
