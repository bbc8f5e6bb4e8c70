"""Framed binary wire format for tensors and control messages.

The reference serializes tensors with pickle over raw TCP
(``hivemind/utils/serializer.py`` + ``connection.py`` — SURVEY.md §2;
unverifiable file refs, mount empty).  We deliberately do NOT use pickle:

- pickle is unsafe across trust boundaries (a decentralized swarm is one),
- pickle round-trips through torch-specific reducers,
- and it copies through Python objects on the hot path.

TPU-native wire format instead:

    frame    := uint32_le(len(payload)) payload
    payload  := uint32_le(len(header)) header raw_tensor_bytes*
    header   := msgpack({"t": msg_type, "m": meta,
                         "ts": [[dtype_str, shape, nbytes], ...]})

Tensor bytes are raw little-endian C-order buffers — zero-copy out of a
host numpy array and zero-copy into ``np.frombuffer`` on receipt, so a
received batch goes to the card in one copy.  ``bfloat16`` is carried
natively via ml_dtypes' numpy registration (torch tensors cross as uint16
views: ``convert.py``).  This is the JAX package's wire, byte for byte.  DHT metadata uses plain msgpack
(``MSGPackSerializer`` parity).

The header's ``m`` (meta) map is the extension point for cross-cutting
request attributes: ``wire`` (transport compression), ``rid`` (protocol
v2 multiplexing — a top-level header key, echoed in replies), and
``trace`` (distributed tracing, ISSUE 4: a ≤64-char id the server stamps
onto its profiling spans and echoes in the reply meta; see
docs/OBSERVABILITY.md).  Meta travels inside the msgpack header on BOTH
v1 and rid-tagged v2 frames, so trace propagation needs no framing
change and absent keys cost zero bytes.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Sequence

import msgpack
import numpy as np

import ml_dtypes  # noqa: F401  (registers bfloat16 & friends with numpy)

from learning_at_home_tpu_torch.utils import sanitizer

_U32 = struct.Struct("<I")

# Hard cap on a single frame (1 GiB) — protects against length-prefix
# corruption / malicious peers allocating unbounded buffers.
MAX_FRAME_BYTES = 1 << 30

# Wire-compression dtypes a request may declare via meta {"wire": ...}:
# floating payloads travel downcast (half the bytes of f32); compute on
# both ends stays float32.  Transport-level contract, shared by clients
# (downcast before pack) and the server (upcast after unpack, downcast
# the reply) — see docs/PROTOCOL.md.
WIRE_DTYPES = ("bfloat16", "float16")

# Wire codecs (ISSUE 5).  The legacy string form above stays the v1
# contract; peers that negotiated the ``codec`` hello feature may instead
# send the DICT wire form ``{"c": codec, "h": [per-tensor header, ...]}``:
#
# - ``none``     raw dtypes, no wire meta — byte-identical to today.
# - ``bf16``/``f16``  the existing downcast, folded into the codec
#                abstraction (on the wire it IS the legacy string form).
# - ``u8``       per-tensor uniform 8-bit: q = round((x - lo) / sc) in
#                uint8, header {"lo", "sc"} (f32 min and (max-min)/255).
# - ``blockq8``  blockwise mean-std 8-bit (the hivemind lineage's
#                gradient-safe quantizer): blocks of BLOCKQ8_BLOCK
#                elements *within each trailing-axis vector* (blocks
#                never cross the last-axis boundary, so any gather over
#                leading axes — the pack-once row slice — keeps block
#                alignment); per block f32 mean/std, values quantized to
#                int8 over ±BLOCKQ8_CLIP standard deviations.
#
# 4x fewer bytes than f32 for the quantized pair; compute on both ends
# stays float32 (encode off the hot loop, decode lands in the server's
# staging buffers — see LazyDecode).  docs/PROTOCOL.md "Wire codecs".
WIRE_CODECS = ("none", "bf16", "f16", "u8", "blockq8")
QUANTIZED_CODECS = ("u8", "blockq8")
BLOCKQ8_BLOCK = 1024
BLOCKQ8_CLIP = 6.0  # quantization range in per-block standard deviations

# codec name <-> legacy wire dtype string
_CODEC_TO_DTYPE = {"bf16": "bfloat16", "f16": "float16"}
_DTYPE_TO_CODEC = {v: k for k, v in _CODEC_TO_DTYPE.items()}

# approximate wire-bytes multiplier vs raw f32 per codec — consumed by
# the routing cost model's estimated-transfer term (client/routing.py);
# the 8-bit codecs carry small per-block headers, hence 0.27 not 0.25
CODEC_WIRE_RATIO = {
    "none": 1.0, "bf16": 0.5, "f16": 0.5, "u8": 0.26, "blockq8": 0.27,
}


def is_float_dtype(dt) -> bool:
    """True for ANY floating dtype including ml_dtypes extension types.
    ``np.issubdtype(np.dtype('bfloat16'), np.floating)`` is False (the
    extension dtype's kind is 'V'), so numpy's own check silently skips
    exactly the dtypes wire compression exists for: an extension dtype
    counts as floating when ``ml_dtypes.finfo`` describes it (bfloat16,
    the float8 family), the same set ``jnp.issubdtype(dt, jnp.floating)``
    accepts."""
    dt = np.dtype(dt)
    if dt.kind == "f":
        return True
    if dt.kind != "V":
        return False
    try:
        ml_dtypes.finfo(dt)
    except (TypeError, ValueError):
        return False
    return True


def wire_cast(tensors, wire_dtype: str | None) -> list:
    """Downcast floating tensors to the wire dtype (no-op when None)."""
    if wire_dtype is None:
        return list(tensors)
    return [
        np.asarray(t).astype(wire_dtype)
        if is_float_dtype(np.asarray(t).dtype) else t
        for t in tensors
    ]


def validate_wire_dtype(wire_dtype: str | None) -> None:
    if wire_dtype is not None and wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {WIRE_DTYPES} or None, "
            f"got {wire_dtype!r}"
        )


class MSGPackSerializer:
    """msgpack for small control-plane values (DHT records, RPC metadata)."""

    @staticmethod
    def dumps(obj: Any) -> bytes:
        return msgpack.packb(obj, use_bin_type=True)

    @staticmethod
    def loads(buf: bytes) -> Any:
        return msgpack.unpackb(buf, raw=False, strict_map_key=False)


def _tensor_to_wire(arr) -> tuple[list, memoryview]:
    np_arr = np.asarray(arr)
    if not np_arr.flags["C_CONTIGUOUS"]:
        # NB: ascontiguousarray would promote 0-d to 1-d, but 0-d arrays are
        # always contiguous so they never take this branch.
        np_arr = np.ascontiguousarray(np_arr)
    data = np_arr.reshape(-1).view(np.uint8).data  # memoryview: no copy here
    return [np_arr.dtype.name, list(np_arr.shape), np_arr.nbytes], data


class WireTensors:
    """A tensor payload pre-serialized into wire specs + zero-copy blobs.

    The expensive parts of packing — dtype downcasts done by the caller,
    contiguity copies, and the spec walk — happen where ``prepare`` is
    called (a host thread on the client hot path), NOT where the frame is
    written (the event loop).  The blobs are memoryviews over their source
    arrays (kept alive by the views), so one prepared payload can be
    shared by any number of frames: the pack-once fan-out packs a uid's
    rows a single time and reuses the buffers for the merged ``multi``
    call AND any disaggregated per-expert retry."""

    __slots__ = ("specs", "blobs", "nbytes")

    def __init__(self, specs: list, blobs: list):
        self.specs = specs
        self.blobs = blobs
        self.nbytes = sum(b.nbytes for b in blobs)

    @classmethod
    def prepare(cls, tensors: Sequence[Any] = ()) -> "WireTensors":
        specs, blobs = [], []
        for t in tensors:
            spec, blob = _tensor_to_wire(t)
            specs.append(spec)
            blobs.append(blob)
        return cls(specs, blobs)

    @classmethod
    def concat(cls, parts: Sequence["WireTensors"]) -> "WireTensors":
        """Concatenate prepared payloads WITHOUT copying tensor bytes —
        the merged per-peer request is a list concat of spec/blob refs."""
        specs: list = []
        blobs: list = []
        for p in parts:
            specs.extend(p.specs)
            blobs.extend(p.blobs)
        return cls(specs, blobs)


# the device thread must never serialize wire frames: frame packing on
# lah-runtime would stall the double-buffered stack/dispatch pipeline
# behind network work (the loops and host threads are the packers)
@sanitizer.runs_on("not:lah-runtime", site="pack_frames")
def pack_frames(
    msg_type: str,
    wire: WireTensors,
    meta: dict | None = None,
    rid: int | None = None,
) -> list:
    """Serialize a message into a COMPLETE frame as a list of buffers
    (outer length prefix + header, then the tensor blobs), ready for a
    vectored ``writer.writelines`` — the joined-payload copy of
    ``pack_message`` + ``send_frame`` never materializes.

    ``rid`` tags the frame with a request id (protocol v2 multiplexing);
    v1 frames omit it, and byte-for-byte the v1 output of this path is
    identical to ``send_frame(w, pack_message(...))``."""
    header_map: dict = {"t": msg_type, "m": meta or {}, "ts": wire.specs}
    if rid is not None:
        header_map["rid"] = int(rid)
    header = msgpack.packb(header_map, use_bin_type=True)
    payload_len = 4 + len(header) + wire.nbytes
    if payload_len > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame of {payload_len} bytes exceeds MAX_FRAME_BYTES; "
            "chunk large tensors across messages"
        )
    prefix = _U32.pack(payload_len) + _U32.pack(len(header)) + header
    return [prefix, *wire.blobs]


def frame_payload(parts: list) -> bytes:
    """Join frame parts and strip the outer length prefix — the payload
    bytes a non-vectored transport (native pump) expects.  Only the small
    header part is sliced; the tensor blobs are joined exactly once."""
    head = bytes(parts[0])[4:]  # parts[0] is prefix+header (small)
    return b"".join([head, *(bytes(p) for p in parts[1:])])


def frame_nbytes(parts: list) -> int:
    """Total frame size of a ``pack_frames`` result, prefix included."""
    return sum(len(p) if isinstance(p, bytes) else p.nbytes for p in parts)


def peek_header(payload: bytes) -> tuple[str, int | None]:
    """Cheaply read (msg_type, rid) from a payload without touching the
    tensor bytes — the mux reader matches replies to in-flight requests
    with this.  Raises on malformed headers (callers treat that as a
    broken frame)."""
    (hlen,) = _U32.unpack_from(payload, 0)
    header = msgpack.unpackb(payload[4 : 4 + hlen], raw=False)
    rid = header.get("rid")
    return header["t"], int(rid) if rid is not None else None


def pack_message(
    msg_type: str, tensors: Sequence[Any] = (), meta: dict | None = None
) -> bytes:
    """Serialize a message (control header + flat list of tensors) to bytes."""
    specs, blobs = [], []
    for t in tensors:
        spec, blob = _tensor_to_wire(t)
        specs.append(spec)
        blobs.append(blob)
    header = msgpack.packb(
        {"t": msg_type, "m": meta or {}, "ts": specs}, use_bin_type=True
    )
    return b"".join([_U32.pack(len(header)), header, *blobs])


def unpack_message(payload: bytes) -> tuple[str, list[np.ndarray], dict]:
    """Inverse of :func:`pack_message`; tensors are zero-copy views."""
    (hlen,) = _U32.unpack_from(payload, 0)
    header = msgpack.unpackb(payload[4 : 4 + hlen], raw=False)
    tensors = []
    offset = 4 + hlen
    for dtype_name, shape, nbytes in header["ts"]:
        dt = np.dtype(dtype_name)
        if nbytes < 0 or any(d < 0 for d in shape):
            raise ValueError(
                f"malformed tensor spec: negative dims in {dtype_name}{shape}"
                f"/{nbytes}"
            )
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if nbytes != count * dt.itemsize:
            raise ValueError(
                f"malformed tensor spec: {dtype_name}{shape} declares {nbytes} "
                f"bytes, expected {count * dt.itemsize}"
            )
        if offset + nbytes > len(payload):
            raise ValueError("malformed payload: tensor data exceeds frame")
        arr = np.frombuffer(payload, dtype=dt, count=count, offset=offset)
        tensors.append(arr.reshape(shape))
        offset += nbytes
    return header["t"], tensors, header["m"]


async def send_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    """Write one length-prefixed frame (fails fast on oversized payloads)."""
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME_BYTES; "
            "chunk large tensors across messages"
        )
    writer.write(_U32.pack(len(payload)))
    writer.write(payload)
    await writer.drain()


async def send_frame_parts(writer: asyncio.StreamWriter, parts: list) -> None:
    """Vectored counterpart of :func:`send_frame`: write a ``pack_frames``
    result without joining it.  uvloop turns this into ``writev``; the
    stdlib transport joins once internally — either way the explicit
    client/server-side ``b"".join`` copy of every payload is gone."""
    if frame_nbytes(parts) - 4 > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame of {frame_nbytes(parts) - 4} bytes exceeds "
            "MAX_FRAME_BYTES; chunk large tensors across messages"
        )
    writer.writelines(parts)
    await writer.drain()


async def recv_frame(reader: asyncio.StreamReader) -> bytes:
    """Read one length-prefixed frame; raises on EOF or oversized frame."""
    (length,) = _U32.unpack(await reader.readexactly(4))
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {length} bytes exceeds MAX_FRAME_BYTES")
    return await reader.readexactly(length)


# --------------------------------------------------------------------------
# wire codecs (ISSUE 5): 8-bit tensor compression for the hot wires
# --------------------------------------------------------------------------
#
# Wire meta forms a request/reply may carry under ``{"wire": ...}``:
#
# - absent            raw dtypes (codec "none") — byte-identical to the
#                     pre-codec wire;
# - ``"bfloat16"`` / ``"float16"``   the legacy string contract (codec
#                     "bf16"/"f16"): every floating tensor travels
#                     downcast, the receiver upcasts to f32 — understood
#                     by ALL peers including v1 and old builds;
# - ``{"c": codec, "h": [entry, ...]}``   the codec DICT form, offered
#                     only to peers that negotiated the ``codec`` hello
#                     feature.  ``c`` is the request's primary codec (the
#                     one replies are encoded with); ``h`` has exactly
#                     one entry per tensor: ``None`` (raw as-is) or a
#                     per-tensor header dict ``{"c": ...}`` —
#                     ``{"c": "bf16"|"f16"}`` (downcast, upcast on
#                     receipt), ``{"c": "u8", "lo", "sc"}`` or
#                     ``{"c": "blockq8", "m", "s", "bs"}``.  Per-tensor
#                     declarations let one request mix codecs (backward
#                     resends the forward's already-encoded inputs next
#                     to blockq8 gradients).
#
# All header fields are peer-supplied: every decode entry point validates
# dtypes, header shapes and byte lengths and raises ValueError on any
# inconsistency (the server turns that into an ``error`` reply).


def validate_wire_codec(codec: str | None) -> None:
    if codec is not None and codec not in WIRE_CODECS:
        raise ValueError(
            f"wire codec must be one of {WIRE_CODECS} or None, got {codec!r}"
        )


def wire_codec_name(wire) -> str:
    """Canonical codec name of a wire meta value (metrics labels)."""
    if not wire:
        return "none"
    if isinstance(wire, str):
        return _DTYPE_TO_CODEC.get(wire, wire)
    if isinstance(wire, dict):
        return str(wire.get("c", "?"))
    return "?"


def _blockq8_geometry(shape: tuple, bs: int) -> tuple[int, int, int]:
    """(n_vectors, trailing_len, blocks_per_vector) for a tensor shape.
    Blocks subdivide each trailing-axis vector and never cross it, so
    gathers over leading axes (pack-once row slicing) keep alignment."""
    if len(shape) == 0:
        return 1, 1, 1
    last = int(shape[-1])
    nvec = 1
    for d in shape[:-1]:
        nvec *= int(d)
    nblocks = -(-last // bs) if last else 0
    return nvec, last, nblocks


def _block_counts(last: int, bs: int) -> np.ndarray:
    starts = np.arange(0, last, bs, dtype=np.int64)
    return np.diff(np.append(starts, last))


def _encode_u8(a32: np.ndarray):
    """Per-tensor uniform 8-bit: q = round((x - lo) / sc), uint8.
    Returns None for tensors whose range is not finitely representable
    (NaN/inf values) — the caller sends those raw, preserving exact
    non-finite propagation."""
    if a32.size == 0:
        return np.zeros(a32.shape, np.uint8), 0.0, 1.0
    lo = float(np.min(a32))
    hi = float(np.max(a32))
    if not (np.isfinite(lo) and np.isfinite(hi)):
        return None
    sc = (hi - lo) / 255.0
    if not np.isfinite(sc) or sc <= 0.0:
        sc = 1.0  # constant tensor: decode yields lo
    q = np.clip(np.rint((a32 - lo) * (1.0 / sc)), 0, 255).astype(np.uint8)
    return q, lo, sc


def _encode_blockq8(a32: np.ndarray, bs: int = BLOCKQ8_BLOCK):
    """Blockwise mean-std 8-bit: per block of ``bs`` elements within each
    trailing-axis vector, store f32 mean/std and quantize the normalized
    values to int8 over ±BLOCKQ8_CLIP standard deviations.  Returns
    ``(q_int8, mean, std)`` with mean/std shaped ``(*shape[:-1], nblocks)``
    — sliceable by any leading-axis gather, exactly like the payload —
    or None when the block stats are not finite (NaN/inf values, or
    magnitudes whose square overflows f32): those tensors travel raw."""
    nvec, last, nb = _blockq8_geometry(a32.shape, bs)
    lead_shape = a32.shape[:-1] if a32.ndim else ()
    if a32.size == 0 or nb == 0:
        empty = np.zeros(lead_shape + (nb,), np.float32)
        return np.zeros(a32.shape, np.int8), empty, empty.copy()
    flat = np.ascontiguousarray(a32).reshape(nvec, last)
    starts = np.arange(0, last, bs, dtype=np.int64)
    counts = _block_counts(last, bs).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        sums = np.add.reduceat(flat, starts, axis=1)
        sumsq = np.add.reduceat(flat * flat, starts, axis=1)
        mean = (sums / counts).astype(np.float32)
        var = np.maximum(sumsq / counts - mean * mean, 0.0)
        std = np.sqrt(var).astype(np.float32)
    if not (np.isfinite(mean).all() and np.isfinite(std).all()):
        return None
    # constant blocks quantize to 0 and decode to the mean exactly
    std = np.where(std > 0.0, std, np.float32(1.0)).astype(np.float32)
    rep = counts.astype(np.int64)
    scale = std * np.float32(BLOCKQ8_CLIP / 127.0)
    qf = (flat - np.repeat(mean, rep, axis=1)) / np.repeat(scale, rep, axis=1)
    q = np.clip(np.rint(qf), -127, 127).astype(np.int8)
    return (
        q.reshape(a32.shape),
        mean.reshape(lead_shape + (nb,)),
        std.reshape(lead_shape + (nb,)),
    )


def _validate_quant_entry(arr: np.ndarray, header: dict) -> None:
    """Structural validation of one quantized tensor + its peer-supplied
    header; raises ValueError on any inconsistency."""
    codec = header.get("c")
    if codec == "u8":
        if arr.dtype != np.uint8:
            raise ValueError(f"u8 payload must be uint8, got {arr.dtype}")
        for field in ("lo", "sc"):
            v = header.get(field)
            if not isinstance(v, (int, float)) or not np.isfinite(v):
                raise ValueError(f"u8 header {field!r} must be a finite float")
    elif codec == "blockq8":
        if arr.dtype != np.int8:
            raise ValueError(f"blockq8 payload must be int8, got {arr.dtype}")
        bs = header.get("bs")
        if not isinstance(bs, int) or not 0 < bs <= (1 << 20):
            raise ValueError(f"blockq8 header bs={bs!r} out of range")
        nvec, _last, nb = _blockq8_geometry(arr.shape, bs)
        m, s = header.get("m"), header.get("s")
        want = nvec * nb * 4
        if not isinstance(m, (bytes, bytearray)) or len(m) != want:
            raise ValueError(
                f"blockq8 header means carry {len(m) if isinstance(m, (bytes, bytearray)) else '?'} "
                f"bytes, expected {want}"
            )
        if not isinstance(s, (bytes, bytearray)) or len(s) != want:
            raise ValueError(
                f"blockq8 header stds carry {len(s) if isinstance(s, (bytes, bytearray)) else '?'} "
                f"bytes, expected {want}"
            )
        # finiteness, like the u8 branch: the encoder never produces
        # non-finite stats (it falls back to raw), so any here are
        # hostile/corrupt — reject rather than write inf into a staging
        # buffer on the Runtime thread
        if want and not (
            np.isfinite(np.frombuffer(bytes(m), np.float32)).all()
            and np.isfinite(np.frombuffer(bytes(s), np.float32)).all()
        ):
            raise ValueError("blockq8 header mean/std must be finite")
    else:
        raise ValueError(f"unknown per-tensor codec {codec!r}")


def _decode_quant_into(out: np.ndarray, arr: np.ndarray, header: dict) -> None:
    """Dequantize ``arr`` (already validated) directly into ``out`` —
    in-place scale/shift on the destination buffer, so a server-side
    decode lands straight in the Runtime's staging buffer with no
    intermediate f32 materialization on the serving loop."""
    codec = header["c"]
    if not out.flags["C_CONTIGUOUS"]:
        tmp = np.empty(arr.shape, np.float32)
        _decode_quant_into(tmp, arr, header)
        out[...] = tmp
        return
    if codec == "u8":
        np.copyto(out, arr, casting="unsafe")
        # hostile headers may carry huge-but-finite scales: the contract
        # is garbage-in-garbage-out (inf), never a warning storm or crash
        with np.errstate(over="ignore", invalid="ignore"):
            out *= out.dtype.type(header["sc"])
            out += out.dtype.type(header["lo"])
        return
    bs = header["bs"]
    nvec, last, nb = _blockq8_geometry(arr.shape, bs)
    if arr.size == 0:
        return
    flat_o = out.reshape(nvec, last)
    flat_q = np.ascontiguousarray(arr).reshape(nvec, last)
    mean = np.frombuffer(bytes(header["m"]), np.float32).reshape(nvec, nb)
    std = np.frombuffer(bytes(header["s"]), np.float32).reshape(nvec, nb)
    rep = _block_counts(last, bs)
    np.copyto(flat_o, flat_q, casting="unsafe")
    # stats are validated finite, but huge-but-finite stds can still
    # overflow f32 at the edges — garbage-in-garbage-out, never a
    # warning storm (same contract as the u8 branch)
    with np.errstate(over="ignore", invalid="ignore"):
        flat_o *= np.repeat(
            std * np.float32(BLOCKQ8_CLIP / 127.0), rep, axis=1
        )
        flat_o += np.repeat(mean, rep, axis=1)


class LazyDecode:
    """A quantized wire tensor whose dequantize runs where it is CONSUMED
    — the Runtime thread's staging-buffer stack on the server, the
    blocked host thread on the client — never on the serving/client event
    loop.  Exposes ``shape``/``dtype``/``ndim`` so batch formation can
    validate it like a plain array, ``decode_into(out)`` for the staging
    path, and ``__array__`` so ``np.asarray(lazy, dtype)`` just works.

    The header is validated at construction (peer-supplied bytes), so a
    malformed frame fails on the loop with a clean error instead of
    poisoning a formed batch on the Runtime thread."""

    __slots__ = ("wire", "header", "shape", "ndim", "dtype")

    def __init__(self, wire_arr: np.ndarray, header: dict):
        wire_arr = np.asarray(wire_arr)
        _validate_quant_entry(wire_arr, header)
        self.wire = wire_arr
        self.header = header
        self.shape = wire_arr.shape
        self.ndim = wire_arr.ndim
        self.dtype = np.dtype(np.float32)

    @property
    def nbytes(self) -> int:
        """DECODED size (what downstream compute sees)."""
        return int(self.wire.size) * 4

    @property
    def wire_nbytes(self) -> int:
        return int(self.wire.nbytes)

    def decode_into(self, out: np.ndarray) -> None:
        if tuple(out.shape) != tuple(self.shape):
            raise ValueError(
                f"decode_into shape mismatch: out {out.shape} vs "
                f"wire {self.shape}"
            )
        # dequantize is O(bytes) work: it belongs to the Runtime thread
        # (staging path) or a blocked host thread, never an event loop
        # (the averaging handler's bounded eager decode holds an explicit
        # sanitizer.allowed() pass — see averaging/handler.py)
        sanitizer.check("host", "LazyDecode.decode")
        _decode_quant_into(out, self.wire, self.header)

    def decode(self) -> np.ndarray:
        sanitizer.check("host", "LazyDecode.decode")
        out = np.empty(self.shape, np.float32)
        _decode_quant_into(out, self.wire, self.header)
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.decode()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a

    def __len__(self) -> int:
        if not self.ndim:
            raise TypeError("len() of unsized LazyDecode")
        return int(self.shape[0])


class EncodedBatch:
    """One tensor encoded ONCE under a codec, sliceable by any gather
    over its leading axes — the pack-once fan-out's unit of work: the
    whole dispatch batch is encoded a single time on the caller's host
    thread and every expert's payload (and its per-tensor header) is a
    slice of that encoding.  blockq8 blocks never cross the trailing
    axis, so leading-axis gathers keep block alignment by construction.
    """

    __slots__ = ("codec", "wire", "_aux")

    def __init__(self, codec: str, wire: np.ndarray, aux):
        self.codec = codec
        self.wire = wire
        self._aux = aux

    @classmethod
    @sanitizer.runs_on("host", site="EncodedBatch.encode")
    def encode(cls, arr, codec: str) -> "EncodedBatch":
        validate_wire_codec(codec)
        a = np.asarray(arr)
        if codec == "none" or not is_float_dtype(a.dtype):
            return cls("none", a, None)
        if codec in ("bf16", "f16"):
            return cls(
                codec, wire_cast([a], _CODEC_TO_DTYPE[codec])[0], None
            )
        a32 = np.asarray(a, dtype=np.float32)
        if a32.ndim and not a32.flags["C_CONTIGUOUS"]:
            a32 = np.ascontiguousarray(a32)  # 0-d is always contiguous
        # non-finite values (a diverged batch, an inf grad) have no
        # finite quantization stats: the encoders return None and the
        # tensor travels RAW, so NaN/inf propagate exactly as today — a
        # quantize must never turn a legal-but-sick payload into a
        # rejected request
        if codec == "u8":
            enc = _encode_u8(a32)
            if enc is None:
                return cls("none", a, None)
            q, lo, sc = enc
            return cls(codec, q, (lo, sc))
        enc = _encode_blockq8(a32)
        if enc is None:
            return cls("none", a, None)
        q, mean, std = enc
        return cls(codec, q, (mean, std))

    def _header(self, idx) -> dict | None:
        if self.codec == "u8":
            lo, sc = self._aux
            return {"c": "u8", "lo": lo, "sc": sc}
        if self.codec == "blockq8":
            mean, std = self._aux
            if idx is not None:
                mean, std = mean[idx], std[idx]
            return {
                "c": "blockq8",
                "m": np.ascontiguousarray(mean).tobytes(),
                "s": np.ascontiguousarray(std).tobytes(),
                "bs": BLOCKQ8_BLOCK,
            }
        if self.codec in ("bf16", "f16"):
            return {"c": self.codec}
        return None

    def full(self) -> tuple[np.ndarray, dict | None]:
        return self.wire, self._header(None)

    def take(self, idx) -> tuple[np.ndarray, dict | None]:
        """Slice/gather over leading axes: payload AND header together."""
        return self.wire[idx], self._header(idx)


def encode_wire_tensors(tensors: Sequence, codec: str | None):
    """Encode a whole payload under one codec.  Returns ``(wire_tensors,
    wire_meta)`` where wire_meta is the value for meta ``{"wire": ...}``
    (None for codec "none" — byte-identical to the raw wire; the legacy
    string for bf16/f16; the dict form for quantized codecs).  Non-float
    tensors always pass through raw."""
    if codec is None or codec == "none":
        return list(tensors), None
    validate_wire_codec(codec)
    if codec in ("bf16", "f16"):
        wd = _CODEC_TO_DTYPE[codec]
        return wire_cast(tensors, wd), wd
    outs, headers = [], []
    for t in tensors:
        w, h = EncodedBatch.encode(t, codec).full()
        outs.append(w)
        headers.append(h)
    return outs, {"c": codec, "h": headers}


def decode_wire_tensors(tensors: Sequence, wire, lazy: bool = True) -> list:
    """Inverse of :func:`encode_wire_tensors` for BOTH wire meta forms.

    - legacy string: the strict all-floats-compressed contract — every
      floating tensor must carry the declared dtype, upcast to f32;
    - dict form: per-tensor entries; quantized tensors come back as
      :class:`LazyDecode` (``lazy=True``, the server staging path) or
      decoded f32 arrays (``lazy=False``).

    Everything here is peer-supplied — any inconsistency raises
    ValueError (the caller replies ``error``), never a partial parse."""
    if not wire:
        return list(tensors)
    if isinstance(wire, str):
        if wire not in WIRE_DTYPES:
            raise ValueError(
                f"unsupported wire dtype {wire!r}; supported: {WIRE_DTYPES}"
            )
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
    if not isinstance(wire, dict):
        raise ValueError(f"malformed wire meta of type {type(wire).__name__}")
    codec = wire.get("c")
    if codec not in WIRE_CODECS:
        raise ValueError(
            f"unsupported wire codec {codec!r}; supported: {WIRE_CODECS}"
        )
    headers = wire.get("h")
    if not isinstance(headers, list) or len(headers) != len(tensors):
        raise ValueError(
            f"wire codec headers cover {len(headers) if isinstance(headers, list) else '?'} "
            f"tensors, payload has {len(tensors)}"
        )
    out = []
    for t, h in zip(tensors, headers):
        if h is None:
            out.append(t)
            continue
        if not isinstance(h, dict):
            raise ValueError("per-tensor wire header must be a map or nil")
        entry_codec = h.get("c")
        if entry_codec in ("bf16", "f16"):
            arr = np.asarray(t)
            expected = np.dtype(_CODEC_TO_DTYPE[entry_codec])
            if arr.dtype != expected:
                raise ValueError(
                    f"tensor declares wire codec {entry_codec} but carries "
                    f"{arr.dtype}"
                )
            out.append(arr.astype(np.float32))
        else:
            ld = LazyDecode(np.asarray(t), h)  # validates the header
            out.append(ld if lazy else ld.decode())
    return out


def select_wire_codec(
    kind: str,
    nbytes: int,
    rtt_ema: float | None,
    bw_ema: float | None,
    base: str = "none",
    slow_rtt_s: float = 0.020,
    bf16_at_s: float = 0.100,
    q8_at_s: float = 0.300,
) -> str:
    """Adaptive per-pool escalation: none → bf16 → 8-bit, driven by the
    pool's RTT EMA (is this peer actually slow/remote?) and its measured
    bytes/sec (how long will THIS payload spend on the wire?).

    - unmeasured pools (no RTT or bandwidth sample yet) and fast pools
      (RTT below ``slow_rtt_s`` — loopback/LAN) never escalate: the
      default stays byte-identical to today's wire;
    - estimated transfer time ≤ ``bf16_at_s``: keep the configured base;
    - ≤ ``q8_at_s``: escalate to bf16 (2x fewer bytes, exact-ish);
    - beyond that: quantize — ``u8`` for forward activations, while
      backward ``kind`` requires the gradient-safe ``blockq8``.

    The thresholds are deliberately CONSERVATIVE (100 ms / 300 ms):
    the bandwidth EMA's denominator is whole-exchange time, so server
    compute (or a warmup compile) inflates the transfer estimate — on a
    loopback/LAN pool a compute-bound 100 ms exchange must not trigger
    quantization, while a genuine 100 Mbit WAN moves the 2048-row
    production dispatch in 300+ ms and clears both bars.

    An explicit override (``LAH_WIRE_CODEC`` / constructor pin) bypasses
    this function entirely — policy, not mechanism, wins."""
    if rtt_ema is None or bw_ema is None or rtt_ema < slow_rtt_s:
        return base
    est = nbytes / max(float(bw_ema), 1.0)
    if est <= bf16_at_s:
        return base
    if est <= q8_at_s:
        return base if base in ("bf16", "f16") else "bf16"
    return "u8" if kind == "forward" else "blockq8"
