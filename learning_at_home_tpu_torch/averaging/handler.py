"""The ``averaging`` RPC family: a peer handler hosted INSIDE trainers.

Same framed wire format and connection discipline as the expert server's
``server/connection_handler.py`` — including ``hello`` feature
negotiation, so averaging traffic rides protocol v2 (rid-tagged frames,
many in-flight RPCs per socket, replies in completion order).  That
matters here more than anywhere: an ``avg_part`` reply is HELD until the
whole partition has reduced, so out-of-order replies are the normal
case, not the exception.

Requests (docs/PROTOCOL.md "Averaging RPC family"):

- ``avg_join``:  meta {peer, ep: [host, port], w} →
                 ``result`` meta {status: "ok", gid, epoch,
                 members: [[pid, host, port, w], ...]}
                 | {status: "wait", epoch}  (round in flight — next epoch)
                 | {status: "retry"}        (no gather open here)
- ``avg_part``:  meta {gid, part, sender, w, off, part_len, total_len},
                 tensors [float32 chunk] → ``result`` tensors
                 [averaged chunk for the same [off, off+n) range].
                 The reply is held until the partition reduces (or the
                 accumulator times out and degrades to the survivors).
                 The chunk may travel QUANTIZED (ISSUE 5): meta
                 ``{"wire": ...}`` in either wire form declares the
                 encoding; the accumulator decodes to f32 before the
                 sorted-peer reduction.  Replies are ALWAYS raw f32 — the
                 owner distributes one set of exact result bytes, which
                 is what keeps every member bitwise-equal per reduced
                 partition (a quantized reply would either break that or
                 require group-wide codec consensus; the contribute
                 direction is where N-1 senders stream concurrently, so
                 that is where quantization pays).
- ``avg_stats``: {} → ``result`` meta = averager.stats()
- errors → ``error`` meta {message}

Chaos: an attached :class:`~learning_at_home_tpu_torch.server.chaos.ChaosInjector`
can drop or delay ``avg_part`` replies (``before_averaging_reply``) —
exercising exactly the sender-side timeout path a WAN peer would.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

import numpy as np

from learning_at_home_tpu_torch.utils import sanitizer
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

if TYPE_CHECKING:
    from learning_at_home_tpu_torch.averaging.averager import DecentralizedAverager
    from learning_at_home_tpu_torch.server.chaos import ChaosInjector

logger = logging.getLogger(__name__)

# Mirrors the expert server: ``mux`` (required — held replies) plus
# ``codec`` (senders may quantize their partition chunks).
AVERAGING_FEATURES = ("mux", "codec")


class AveragingPeerHandler:
    """Dispatches one peer connection's averaging requests."""

    def __init__(
        self,
        averager: "DecentralizedAverager",
        chaos: Optional["ChaosInjector"] = None,
    ):
        self.averager = averager
        self.chaos = chaos
        self.bytes_received = 0
        self.quantized_chunks = 0  # avg_part requests that arrived 8-bit

    async def handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        muxed = False
        wlock = asyncio.Lock()
        inflight: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    payload = await recv_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                self.bytes_received += len(payload)
                try:
                    msg_type, rid = peek_header(payload)
                except Exception:
                    msg_type, rid = None, None
                if msg_type == "hello":
                    # peer-supplied hello: non-map meta / non-list offer
                    # negotiates the empty set, never a torn connection
                    try:
                        _, _, hmeta = unpack_message(payload)
                        offered = hmeta.get("features")
                    except Exception:
                        offered = None
                    if not isinstance(offered, list):
                        offered = []
                    common = [f for f in AVERAGING_FEATURES if f in offered]
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
                    # held avg_part/avg_join replies REQUIRE concurrent
                    # serving: a partition's reply resolves only when
                    # every member's part arrived, possibly on this very
                    # connection's later frames
                    task = asyncio.get_running_loop().create_task(
                        self._serve_muxed(payload, rid, writer, wlock)
                    )
                    inflight.add(task)
                    task.add_done_callback(inflight.discard)
                    continue
                msg_type2, reply = await self._dispatch(payload, rid)
                if not await self._chaos_gate(msg_type2, payload, reply):
                    continue
                await self._send(writer, wlock, reply)
        except Exception:
            logger.exception("averaging handler failed for peer %s", peer)
        finally:
            for task in inflight:
                task.cancel()
            writer.close()

    @staticmethod
    async def _send(writer, wlock: asyncio.Lock, parts: list) -> None:
        async with wlock:
            await send_frame_parts(writer, parts)

    async def _chaos_gate(self, msg_type, payload, reply) -> bool:
        """Apply chaos to data-plane (``avg_part``) replies only — the
        matchmaking control plane stays reliable so chaos experiments
        measure reduction fault tolerance, not rendezvous flake."""
        if self.chaos is None or msg_type != "avg_part":
            return True
        return await self.chaos.before_averaging_reply(
            len(payload) + frame_nbytes(reply) - 4
        )

    async def _serve_muxed(
        self, payload: bytes, rid: int, writer, wlock: asyncio.Lock
    ) -> None:
        try:
            msg_type, reply = await self._dispatch(payload, rid)
            if not await self._chaos_gate(msg_type, payload, reply):
                return  # injected drop: the sender sees a timeout
            await self._send(writer, wlock, reply)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("muxed averaging request %d failed", rid)

    async def _dispatch(self, payload: bytes, rid=None) -> tuple[str, list]:
        """Serve one request; returns (msg_type, vectored reply parts)."""

        def reply(msg_type: str, tensors=(), meta=None) -> list:
            return pack_frames(
                msg_type, WireTensors.prepare(tensors), meta, rid=rid
            )

        try:
            msg_type, tensors, meta = unpack_message(payload)
        except Exception as e:
            return "", reply("error", meta={"message": f"malformed request: {e}"})
        try:
            if msg_type == "avg_join":
                return msg_type, reply(
                    "result", meta=await self.averager._on_join(meta)
                )
            elif msg_type == "avg_part":
                wire = meta.get("wire")
                if wire is not None:
                    # decode BEFORE accumulation: the reduction is f32,
                    # only the wire was quantized.  Chunks are small
                    # (≤ chunk_elems), so the eager decode here costs
                    # microseconds; validation raises → error reply.
                    # Scoped sanitizer pass for exactly that bounded
                    # decode — any unbounded on-loop decode still trips.
                    with sanitizer.allowed("LazyDecode.decode"):
                        tensors = decode_wire_tensors(
                            tensors, wire, lazy=False
                        )
                    if isinstance(wire, dict):
                        self.quantized_chunks += 1
                chunk = await self.averager._on_part(meta, tensors)
                return msg_type, reply("result", [chunk])
            elif msg_type == "avg_stats":
                return msg_type, reply("result", meta=self.averager.stats())
            else:
                return msg_type, reply(
                    "error",
                    meta={"message": f"unknown message type {msg_type!r}"},
                )
        except Exception as e:
            logger.warning("averaging request %s failed: %s", msg_type, e)
            return msg_type, reply(
                "error", meta={"message": f"{type(e).__name__}: {e}"}
            )


def as_f32_chunk(tensors) -> np.ndarray:
    """Validate an ``avg_part`` payload: exactly one float32 vector."""
    if len(tensors) != 1:
        raise ValueError(f"avg_part carries {len(tensors)} tensors, wants 1")
    arr = np.asarray(tensors[0])
    if arr.dtype != np.float32 or arr.ndim != 1:
        raise ValueError(
            f"avg_part chunk must be a float32 vector, got "
            f"{arr.dtype}{list(arr.shape)}"
        )
    return arr
