"""Schema-derived hostile-input fuzzing (ISSUE 15 tentpole, part 3).

The wire IR extracted by :mod:`.schema` is not just a lint input — it is
a *generator*: every op a dispatcher handles, every field it parses, and
every type PROTOCOL.md's machine-read rows declare for that field define
the space of frames a hostile or version-skewed peer can send.  This
module turns that space into a deterministic, seeded battery of mutated
frames per handler family:

- **meta mutations** — drop each required field (the server must reject:
  error reply or clean close, never a ``result``), retype fields to the
  wrong msgpack type, oversize string/bytes/int values, hostile float
  values (NaN / inf / negative — the ISSUE-17 sampling knobs), replace
  the whole meta map with a non-map;
- **frame mutations** — truncated payloads (outer length prefix lies
  long), inner header-length lies, non-msgpack headers, tensor specs
  whose declared byte counts disagree with the payload, rid games
  (huge, negative, string-typed, colliding), oversized outer prefixes;
- **handshake mutations** — ``hello`` frames with non-list / oversized
  feature offers;
- **seeded byte flips** — random single-byte corruptions of valid
  frames.

Every case carries an expectation: ``reject`` (the server must NOT
answer with a success ``result`` — the teeth behind the seeded-bug
self-validation in ``tools/lah_fuzz.py --selfcheck``) or ``tolerate``
(any of error reply / result / clean close is fine; only a crash, a
hang, or a sanitizer violation fails).  Cases serialize to JSON so a
found crash pins into ``tests/fuzz_corpus/`` as a regression corpus
replayed by pytest (tests/test_fuzz_replay.py).

Generation is pure: same seed → byte-identical cases (``random.Random``
only, no time, no os.urandom), which is what makes corpus replay and
CI triage deterministic.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from random import Random
from typing import Iterable, Optional

import msgpack

from . import schema as _schema
from .lint import _doc_corpus, _doc_rows_for, _find_docs_dir

_U32 = struct.Struct("<I")

# Families the harness can host live instances of, in barrage order.
FAMILIES = ("expert", "gateway", "averaging", "dht")

# Counters the fuzz harness publishes (docs/OBSERVABILITY.md "Fuzzing"):
# one frame lands in exactly one outcome bucket, so the outcome counters
# sum to lah_fuzz_frames_total.
FUZZ_COUNTERS = (
    "lah_fuzz_frames_total",    # mutated frames driven at live handlers
    "lah_fuzz_rejects_total",   # outcome: error-shaped reply
    "lah_fuzz_results_total",   # outcome: success result reply
    "lah_fuzz_closes_total",    # outcome: server closed the connection
    "lah_fuzz_hangs_total",     # outcome: no reply within the deadline
    "lah_fuzz_crashes_total",   # liveness probe failed after a case
)

# (op, field) pairs whose required-field drop is deliberately answered
# with a benign result rather than an error: cancel of an absent stream
# is an idempotent no-op (``{"cancelled": False}``), not a fault.
SOFT_REJECT = {("gen_cancel", "sid")}

# Ops that mutate durable server state: ``drain`` flips the lifecycle
# with an EMPTY meta (every field is optional), ``replica`` installs an
# expert from any uid string, ``handoff`` opens transfer sessions, and
# ``migrate`` hands a hosted expert off to an arbitrary target then
# retires the source copy.  A socket barrage over these would
# drain/mutate the very instance whose liveness the run asserts, so
# they are excluded from generation and reported as skipped; their
# hostile-meta validation is covered by the in-process corpus replays
# (tests/fuzz_corpus/handoff_meta.json and the lifecycle/drain/migrate
# test batteries).
STATEFUL_OPS = ("drain", "replica", "handoff", "migrate")


@dataclasses.dataclass
class FuzzCase:
    """One mutated frame + its expectation.

    ``frame_hex`` is the COMPLETE byte sequence written to the socket,
    outer length prefix included — mutations are allowed to make the
    prefix lie, so the driver must not re-frame.  ``wait`` is False for
    cases that by construction can never be answered (the outer prefix
    declares more bytes than the case sends): the driver writes, closes,
    and classifies the outcome as ``close`` without burning a recv
    timeout per case.
    """

    family: str
    name: str
    op: str
    mutation: str
    expect: str  # "reject" | "tolerate"
    frame_hex: str
    wait: bool = True

    def frame(self) -> bytes:
        return bytes.fromhex(self.frame_hex)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "FuzzCase":
        return cls(**{
            k: obj[k] for k in (
                "family", "name", "op", "mutation", "expect", "frame_hex",
            )
        } | {"wait": bool(obj.get("wait", True))})


# ---------------------------------------------------------------------------
# frame construction — deliberately NOT serialization.pack_frames: the
# whole point is emitting frames pack_frames refuses to build
# ---------------------------------------------------------------------------


def build_frame(
    msg_type,
    meta,
    specs: Optional[list] = None,
    blobs: bytes = b"",
    rid=None,
    header_raw: Optional[bytes] = None,
    hlen_override: Optional[int] = None,
    outer_override: Optional[int] = None,
    truncate_to: Optional[int] = None,
) -> bytes:
    """Assemble ``u32(outer) u32(hlen) header blobs`` with every length
    field independently liable."""
    if header_raw is None:
        hmap = {"t": msg_type, "m": meta, "ts": specs if specs is not None else []}
        if rid is not None:
            hmap["rid"] = rid
        header_raw = msgpack.packb(hmap, use_bin_type=True)
    hlen = len(header_raw) if hlen_override is None else hlen_override
    payload = _U32.pack(hlen & 0xFFFFFFFF) + header_raw + blobs
    outer = len(payload) if outer_override is None else outer_override
    frame = _U32.pack(outer & 0xFFFFFFFF) + payload
    if truncate_to is not None:
        frame = frame[:truncate_to]
    return frame


def _tensor_blob(dtype: str, shape: list, fill: int = 1) -> tuple[list, bytes]:
    """A well-formed tensor spec + matching raw bytes (f32 ones by
    default) — the benign payload mutations start from."""
    import numpy as np

    arr = np.full(shape, fill, dtype=dtype)
    return [arr.dtype.name, list(arr.shape), arr.nbytes], arr.tobytes()


# ---------------------------------------------------------------------------
# field model: handler IR x PROTOCOL.md types
# ---------------------------------------------------------------------------

_TYPE_VALUES = {
    "str": "zz",
    "int": 3,
    "float": 1.0,
    "bytes": b"\x01\x02\x03\x04\x05\x06\x07\x08",
    "list": [],
    "dict": {},
    "bool": True,
}

# a value of a DIFFERENT msgpack type per declared type (retype probes)
_TYPE_SWAPS = {
    "str": 12345,
    "int": "not-an-int",
    "float": b"\x00",
    "bytes": 7,
    "list": "not-a-list",
    "dict": 0,
    "bool": [1, 2],
}


def field_model(paths: Iterable[str]) -> dict:
    """``{family: {op: {field: {"kind", "types"}}}}`` merged from the
    extracted handler IR (which fields, required or optional) and the
    PROTOCOL.md field rows (which types).  This is the generator's view
    of the wire contract — derived, never hand-listed, so a new op or
    field is fuzzed the moment a handler parses it."""
    py_files = list(paths)
    ir = _schema.extract(py_files)
    docs_dir = _find_docs_dir(py_files[0]) if py_files else None
    corpus = _doc_corpus(docs_dir) if docs_dir else {"fields": {}}
    model: dict = {}
    for h in ir.handlers:
        fam = model.setdefault(h.family, {})
        for op in h.ops:
            fields: dict = {}
            doc_rows = _doc_rows_for(corpus, op, h.family) or {}
            for name, use in h.accepted(op).items():
                doc = doc_rows.get(name) or {}
                types = tuple(doc.get("types") or ()) or tuple(use.types)
                # a handler may parse leniently (``.get`` + late
                # validation) while the CONTRACT still requires the
                # field — PROTOCOL.md's kind wins for the drop-probe
                # expectation, the parse-site kind for everything else
                kind = (
                    "req"
                    if use.kind == "req" or doc.get("kind") == "req"
                    else "opt"
                )
                fields[name] = {"kind": kind, "types": types or ("str",)}
            existing = fam.setdefault(op, {})
            for name, spec in fields.items():
                cur = existing.get(name)
                if cur is None:
                    existing[name] = spec
                elif spec["kind"] == "req":
                    cur["kind"] = "req"
    return model


def _baseline_meta(fields: dict, rng: Random) -> dict:
    meta = {}
    for name, spec in fields.items():
        t = spec["types"][0] if spec["types"] else "str"
        meta[name] = _TYPE_VALUES.get(t, "zz")
    return meta


# ---------------------------------------------------------------------------
# case generation
# ---------------------------------------------------------------------------


def _meta_cases(family: str, op: str, fields: dict, rng: Random):
    """Per-op meta-level mutations."""
    base = _baseline_meta(fields, rng)
    specs, blob = _tensor_blob("float32", [2, 4])
    tensors = dict(specs=[specs], blobs=blob)

    def case(name, mutation, expect, meta, **kw):
        frame = build_frame(op, meta, **kw)
        return FuzzCase(family, f"{op}/{name}", op, mutation, expect,
                        frame.hex())

    yield case("baseline", "none", "tolerate", base, **tensors)
    for fname, spec in sorted(fields.items()):
        dropped = {k: v for k, v in base.items() if k != fname}
        if spec["kind"] == "req":
            expect = ("tolerate" if (op, fname) in SOFT_REJECT else "reject")
            yield case(f"drop:{fname}", "drop_required", expect, dropped)
        else:
            yield case(f"drop:{fname}", "drop_optional", "tolerate", dropped)
        t = spec["types"][0] if spec["types"] else "str"
        retyped = dict(base)
        retyped[fname] = _TYPE_SWAPS.get(t, [None])
        yield case(f"retype:{fname}", "retype", "tolerate", retyped)
        if t in ("str", "bytes"):
            big = dict(base)
            big[fname] = ("A" * (1 << 20)) if t == "str" else b"\xff" * (1 << 20)
            yield case(f"oversize:{fname}", "oversize", "tolerate", big)
        elif t == "int":
            big = dict(base)
            big[fname] = 1 << 62
            yield case(f"oversize:{fname}", "oversize", "tolerate", big)
        elif t == "float":
            # value-level hostility for float fields (sampling knobs):
            # non-finite and out-of-range values must come back as
            # well-formed frames, never decoder state or a wedged loop
            for label, val in (("nan", float("nan")),
                               ("inf", float("inf")),
                               ("neg", -1.0)):
                hostile = dict(base)
                hostile[fname] = val
                yield case(f"hostile-{label}:{fname}", "hostile_value",
                           "tolerate", hostile)
    # whole-meta shapes
    yield case("meta-str", "meta_not_map", "tolerate", "junk")
    yield case("meta-list", "meta_not_map", "tolerate", [1, 2, 3])
    yield case("meta-nil", "meta_not_map", "tolerate", None)
    # extra unknown field next to a valid-shaped meta (version skew:
    # newer sender, older receiver — must be ignored or rejected cleanly)
    skew = dict(base)
    skew[f"xfield_{rng.randrange(1000)}"] = rng.randrange(1 << 30)
    yield case("skew-extra", "unknown_field", "tolerate", skew)


def _frame_cases(family: str, ops: list, rng: Random):
    """Framing-level mutations, spread across the family's real ops."""

    def pick_op():
        return ops[rng.randrange(len(ops))]

    def fc(name, mutation, expect, frame: bytes, wait=True):
        return FuzzCase(family, name, "*", mutation, expect, frame.hex(),
                        wait=wait)

    op = pick_op()
    # outer prefix declares more than we send: the server blocks on
    # readexactly until our close → IncompleteReadError → clean break
    whole = build_frame(op, {})
    yield fc("frame/short-read", "outer_lies_long", "tolerate",
             _U32.pack(len(whole) + 64) + whole[4:], wait=False)
    # truncated mid-header
    yield fc("frame/truncated", "truncated", "tolerate",
             build_frame(op, {"k": "v"}, truncate_to=9), wait=False)
    # outer prefix over MAX_FRAME_BYTES: recv_frame refuses
    yield fc("frame/outer-huge", "outer_oversized", "tolerate",
             _U32.pack((1 << 30) + 5) + b"\x00" * 16)
    # inner hlen exceeds the payload
    yield fc("frame/hlen-lie", "hlen_oversized", "tolerate",
             build_frame(op, {}, hlen_override=0xFFFF))
    yield fc("frame/hlen-zero", "hlen_zero", "tolerate",
             build_frame(op, {}, hlen_override=0))
    # header is not msgpack at all
    junk = bytes(rng.randrange(256) for _ in range(24))
    yield fc("frame/junk-header", "junk_header", "tolerate",
             build_frame(None, None, header_raw=junk))
    # header is msgpack but not a map / missing keys
    yield fc("frame/header-int", "junk_header", "tolerate",
             build_frame(None, None, header_raw=msgpack.packb(42)))
    yield fc("frame/header-no-t", "junk_header", "tolerate",
             build_frame(None, None,
                         header_raw=msgpack.packb({"m": {}, "ts": []})))
    # tensor-spec lies: declared nbytes disagree with payload / dtype
    yield fc("frame/spec-nbytes-lie", "tensor_spec_lie", "tolerate",
             build_frame(pick_op(), {}, specs=[["float32", [4], 999]],
                         blobs=b"\x00" * 16))
    yield fc("frame/spec-negative", "tensor_spec_lie", "tolerate",
             build_frame(pick_op(), {}, specs=[["float32", [-3], 12]],
                         blobs=b"\x00" * 12))
    yield fc("frame/spec-bad-dtype", "tensor_spec_lie", "tolerate",
             build_frame(pick_op(), {}, specs=[["no_such_dtype", [2], 8]],
                         blobs=b"\x00" * 8))
    yield fc("frame/spec-overflow-shape", "tensor_spec_lie", "tolerate",
             build_frame(pick_op(), {},
                         specs=[["float32", [1 << 40, 1 << 40], 16]],
                         blobs=b"\x00" * 16))
    # rid games (v1 connection: no hello, so rid must be inert)
    yield fc("frame/rid-huge", "rid_games", "tolerate",
             build_frame(pick_op(), {}, rid=(1 << 63) - 1))
    yield fc("frame/rid-negative", "rid_games", "tolerate",
             build_frame(pick_op(), {}, rid=-7))
    yield fc("frame/rid-str", "rid_games", "tolerate",
             build_frame(pick_op(), {}, rid="abc"))
    # unknown op: every dispatcher owes an error-shaped reply
    yield fc("frame/unknown-op", "unknown_op", "reject",
             build_frame(f"no_such_op_{rng.randrange(1000)}", {}))
    # hello boundary frames
    yield fc("hello/features-int", "hello_hostile", "tolerate",
             build_frame("hello", {"features": 7}))
    yield fc("hello/features-huge", "hello_hostile", "tolerate",
             build_frame("hello", {"features": ["f"] * 4096}))
    yield fc("hello/meta-nil", "hello_hostile", "tolerate",
             build_frame("hello", None))


def _byteflip_cases(family: str, ops: list, rng: Random, n: int):
    """Seeded single-byte corruptions of valid frames.  Flips inside the
    outer length prefix re-frame the byte stream arbitrarily, so these
    never wait on a reply — write, close, assert survival via the next
    liveness probe."""
    for i in range(n):
        op = ops[rng.randrange(len(ops))]
        specs, blob = _tensor_blob("float32", [2, 2], fill=i % 7)
        frame = bytearray(build_frame(op, {"uid": "e.0", "i": i},
                                      specs=[specs], blobs=blob))
        pos = rng.randrange(len(frame))
        frame[pos] ^= 1 << rng.randrange(8)
        yield FuzzCase(family, f"flip/{op}/{i}@{pos}", op, "byte_flip",
                       "tolerate", bytes(frame).hex(), wait=False)


def generate_cases(
    seed: int,
    paths: Iterable[str],
    families: Optional[Iterable[str]] = None,
    min_per_family: int = 220,
) -> list:
    """The full deterministic battery: same (seed, tree) → byte-identical
    cases in identical order."""
    model = field_model(paths)
    wanted = tuple(families) if families else FAMILIES
    cases: list = []
    for fam in wanted:
        ops_model = model.get(fam)
        if not ops_model:
            continue
        rng = Random((seed, fam).__repr__())
        fam_cases: list = []
        ops = sorted(o for o in ops_model if o not in STATEFUL_OPS)
        if not ops:
            continue
        for op in ops:
            fam_cases.extend(_meta_cases(fam, op, ops_model[op], rng))
        fam_cases.extend(_frame_cases(fam, ops, rng))
        deficit = max(0, min_per_family - len(fam_cases))
        fam_cases.extend(_byteflip_cases(fam, ops, rng, deficit + 16))
        cases.extend(fam_cases)
    return cases


# ---------------------------------------------------------------------------
# corpus I/O
# ---------------------------------------------------------------------------


def dump_corpus(cases: list, path: str, meta: Optional[dict] = None) -> None:
    doc = {
        "format": "lah-fuzz-corpus-v1",
        "meta": meta or {},
        "cases": [c.to_json() for c in cases],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def load_corpus(path: str) -> list:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("format") != "lah-fuzz-corpus-v1":
        raise ValueError(f"{path}: not a lah-fuzz corpus")
    return [FuzzCase.from_json(c) for c in doc["cases"]]
