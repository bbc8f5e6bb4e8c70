"""The port's framework-free copies against the JAX package's originals.

- The verbatim copies (``utils/{sanitizer,flight,asyncio_utils,
  connection,sketch,metrics}.py``, ``server/{staging,task_pool,chaos,
  connection_handler}.py``, ``client/routing.py``,
  ``averaging/{matchmaking,handler,averager}.py``, ``utils/slo.py``,
  ``gateway/{admission,scheduler}.py``) are the originals' text with the
  package name changed in imports, nothing else.
- The wire (``utils/serialization.py``, whose only change is a JAX-free
  ``is_float_dtype``): frames of every codec (``none``, ``bf16``, ``f16``,
  ``u8``, ``blockq8``) are the JAX package's bit for bit, and each side
  decodes the other's.
- ``utils/nested.py`` (no ``jax.tree_util``): flatten order, repacking and
  the wire schema are ``jax.tree_util``'s and the JAX package's.
- The modules copied with edits (telemetry, profiling, rpc) agree on the
  functions they kept.
"""

from collections import OrderedDict, namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest

from learning_at_home_tpu.utils import nested as jnested
from learning_at_home_tpu.utils import serialization as jser
from learning_at_home_tpu_torch.utils import nested as tnested
from learning_at_home_tpu_torch.utils import serialization as tser

REPO = Path(__file__).resolve().parents[1]
VERBATIM = [
    "utils/sanitizer.py", "utils/flight.py", "utils/asyncio_utils.py",
    "utils/connection.py", "utils/sketch.py", "utils/metrics.py",
    "server/staging.py", "server/task_pool.py", "server/chaos.py",
    "server/connection_handler.py", "client/routing.py",
    "averaging/matchmaking.py", "averaging/handler.py",
    "averaging/averager.py", "utils/slo.py", "gateway/admission.py",
    "gateway/scheduler.py",
]


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_are_the_originals(rel):
    original = (REPO / "learning_at_home_tpu" / rel).read_text()
    copy = (REPO / "learning_at_home_tpu_torch" / rel).read_text()
    assert copy == original.replace("learning_at_home_tpu.",
                                    "learning_at_home_tpu_torch.")


# ---- the wire ----

def _payload(rng):
    return [
        rng.standard_normal((5, 1030)).astype(np.float32),  # crosses a block
        (rng.standard_normal((3, 4)) * 100).astype(np.float32),
        rng.integers(-50, 50, size=(5,)).astype(np.int32),
        rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        np.float32(2.5) * np.ones((), np.float32),
    ]


@pytest.mark.parametrize("codec", jser.WIRE_CODECS)
def test_frames_are_bit_for_bit_the_jax_packages(codec):
    rng = np.random.default_rng(0)
    tensors = _payload(rng)
    if codec in ("bf16", "f16"):  # the legacy downcast forms: float payloads
        tensors = [t for t in tensors if t.dtype != ml_dtypes.bfloat16]
    assert tser.WIRE_CODECS == jser.WIRE_CODECS
    jw, jmeta = jser.encode_wire_tensors(tensors, codec)
    tw, tmeta = tser.encode_wire_tensors(tensors, codec)
    assert tmeta == jmeta
    for a, b in zip(tw, jw):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    meta = {"uid": "ffn.0"}
    if jmeta is not None:
        meta["wire"] = jmeta
    jframe = jser.frame_payload(jser.pack_frames(
        "forward", jser.WireTensors.prepare(jw), meta, rid=7))
    tframe = tser.frame_payload(tser.pack_frames(
        "forward", tser.WireTensors.prepare(tw), meta, rid=7))
    assert tframe == jframe
    assert tser.pack_message("forward", tw, meta) == \
        jser.pack_message("forward", jw, meta)
    # each side decodes the other's frame to the same tensors
    for unpack, decode, frame in (
            (tser.unpack_message, tser.decode_wire_tensors, jframe),
            (jser.unpack_message, jser.decode_wire_tensors, tframe)):
        msg_type, got, gmeta = unpack(frame)
        assert msg_type == "forward" and gmeta == meta
        dec = decode(got, gmeta.get("wire"), lazy=False)
        want = jser.decode_wire_tensors(jw, jmeta, lazy=False)
        for a, b in zip(dec, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_codec_selection_and_constants_match():
    for name in ("WIRE_DTYPES", "QUANTIZED_CODECS", "BLOCKQ8_BLOCK",
                 "BLOCKQ8_CLIP", "CODEC_WIRE_RATIO", "MAX_FRAME_BYTES"):
        assert getattr(tser, name) == getattr(jser, name), name
    rng = np.random.default_rng(1)
    for _ in range(200):
        kw = dict(kind=str(rng.choice(["forward", "backward"])),
                  nbytes=int(rng.integers(1, 1 << 24)),
                  rtt_ema=(None if rng.random() < 0.2
                           else float(rng.uniform(0, 0.5))),
                  bw_ema=(None if rng.random() < 0.2
                          else float(rng.uniform(1e6, 1e10))),
                  base=str(rng.choice(["none", "bf16", "f16"])))
        assert tser.select_wire_codec(**kw) == jser.select_wire_codec(**kw)


DTYPES = [np.float16, np.float32, np.float64, ml_dtypes.bfloat16,
          ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2, np.int8, np.int16,
          np.int32, np.int64, np.uint8, np.uint32, np.bool_, np.complex64,
          ml_dtypes.int4, ml_dtypes.uint4, np.dtype([("a", np.int32)]),
          np.dtype("V4")]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_is_float_dtype_is_jax_floating(dtype):
    assert tser.is_float_dtype(dtype) == bool(
        jnp.issubdtype(np.dtype(dtype), jnp.floating))


def test_bfloat16_is_floating_though_numpy_says_void():
    assert np.dtype(ml_dtypes.bfloat16).kind == "V"
    assert tser.is_float_dtype(ml_dtypes.bfloat16)
    cast = tser.wire_cast([np.ones(3, np.float32), np.arange(3)], "bfloat16")
    assert cast[0].dtype == ml_dtypes.bfloat16 and cast[1].dtype.kind == "i"


def test_msgpack_header_is_the_jax_packages():
    meta = {"uid": "a.1", "n_inputs": 2, "wire": {"c": "u8", "h": [None]},
            "trace": "0123456789abcdef", "f": 1.5, "b": True, "l": [1, "x"]}
    j = jser.pack_frames("backward", jser.WireTensors.prepare(), meta, rid=1)
    t = tser.pack_frames("backward", tser.WireTensors.prepare(), meta, rid=1)
    assert bytes(t[0]) == bytes(j[0])
    header = msgpack.unpackb(bytes(t[0])[8:], raw=False)
    assert header == {"t": "backward", "m": meta, "ts": [], "rid": 1}


# ---- nests ----

Point = namedtuple("Point", ["y", "x"])


def _trees():
    a = np.arange(3)
    return [
        {"b": 1, "a": 2, "c": {"z": 3, "y": [4, 5]}},
        OrderedDict([("b", 1), ("a", 2)]),
        (Point(y=1, x=2), None, [3, (4, None)], {"k": None, "j": 5}),
        [a, {"w": a, "v": (a, a)}],
        {"params": {"Dense_1": {"kernel": 1, "bias": 2},
                    "Dense_0": {"kernel": 3, "bias": 4},
                    "LayerNorm_0": {"scale": 5, "bias": 6}}},
        7,
        None,
    ]


@pytest.mark.parametrize("i", range(len(_trees())))
def test_flatten_order_is_jax_tree_util(i):
    tree = _trees()[i]
    got = tnested.nested_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(got) == len(want)
    assert all(g is w for g, w in zip(got, want))
    assert all(g is w for g, w in zip(got, jnested.nested_flatten(tree)))
    assert tnested.schema_from_tree(tree) == jnested.schema_from_tree(tree)
    leaves = list(range(100, 100 + len(got)))
    packed = tnested.nested_pack(leaves, tree)
    jpacked = jnested.nested_pack(leaves, tree)
    assert jax.tree_util.tree_structure(packed) == \
        jax.tree_util.tree_structure(jpacked)
    assert jax.tree_util.tree_leaves(packed) == leaves
    schema = tnested.schema_from_tree(tree)
    assert tnested.tree_from_schema(schema, leaves) == \
        jnested.tree_from_schema(schema, leaves)


def test_nested_structure_map_and_compare():
    tree = {"b": (1, 2), "a": Point(3, 4)}
    struct = tnested.nested_structure(tree)
    assert tnested.nested_pack([10, 20, 30, 40], struct) == \
        {"a": Point(10, 20), "b": (30, 40)}
    assert tnested.nested_map(lambda u, v: u + v, tree, tree) == \
        {"a": Point(6, 8), "b": (2, 4)}
    assert tnested.nested_compare(tree, {"a": Point(0, 0), "b": (0, 0)})
    assert not tnested.nested_compare(tree, {"a": (0, 0), "b": (0, 0)})
    with pytest.raises(ValueError):
        tnested.nested_pack([1], struct)


# ---- modules copied with edits ----

def test_telemetry_keys_and_parsers_match():
    from learning_at_home_tpu.utils import telemetry as jt
    from learning_at_home_tpu_torch.utils import telemetry as tt

    for fn in ("load_key", "links_key"):
        assert getattr(tt, fn)("p") == getattr(jt, fn)("p")
    samples = [None, 3, "x", [1, 2, "s"], ["h", 80, "server"],
               {"q": 1.0, "n": 2, "hot": {"a": 1.0}}, {"q": "bad"},
               {"l": {"h:1": [0.01, None], "h:2": [0.02, 1e9]}}, {"l": 5},
               [0.5, "h", 9]]
    for fn in ("parse_links_value", "parse_load_value"):
        for v in samples:
            assert getattr(tt, fn)(v) == getattr(jt, fn)(v), (fn, v)


def test_trace_ids_match():
    from learning_at_home_tpu.utils import profiling as jp
    from learning_at_home_tpu_torch.utils import profiling as tp

    tid = tp.new_trace_id()
    assert jp.valid_trace_id(tid) and tp.valid_trace_id(tid)
    for bad in ("", "x" * 65, 3, None, "zz"):
        assert tp.valid_trace_id(bad) == jp.valid_trace_id(bad)


def test_bucket_rows_matches():
    from learning_at_home_tpu.server.task_pool import bucket_rows as jb
    from learning_at_home_tpu_torch.server.task_pool import bucket_rows as tb

    for mbs in (1, 7, 64, 1000, 1024):
        for n in range(1, 1100, 7):
            assert tb(n, mbs) == jb(n, mbs)


def test_top_k_selection_matches():
    from learning_at_home_tpu.client import routing as jr
    from learning_at_home_tpu_torch.client import routing as tr

    rng = np.random.default_rng(3)
    uids = [f"e.{i}.{j}" for i in range(4) for j in range(3)
            if (i + j) % 5]
    logits = [rng.standard_normal((9, 4)).astype(np.float32),
              rng.standard_normal((9, 3)).astype(np.float32)]
    for k in (1, 2, 4):
        js, jc = jr.select_top_k(logits, uids, k)
        ts, tc = tr.select_top_k(logits, uids, k)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tc, jc)
    assert tr.filter_valid_uids(uids + ["bad", "e.9.0"], "e", (4, 3)) == \
        jr.filter_valid_uids(uids + ["bad", "e.9.0"], "e", (4, 3))
