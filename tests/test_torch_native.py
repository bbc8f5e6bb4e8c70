"""The port's native data plane (``native/``: the C++ frame pump behind
``Server(transport="native")``) against the JAX package's: the pump's
source is the JAX package's byte for byte; its library is built under
``build/native/`` and never next to the source; a port server on the
native transport answers a JAX client with the asyncio transport's reply
bytes, in request order on one connection; an unbuildable pump raises
instead of falling back to asyncio."""

from __future__ import annotations

import socket
import struct
from pathlib import Path

import numpy as np
import pytest

from learning_at_home_tpu.client import RemoteExpert as JaxRemoteExpert
from learning_at_home_tpu.client import reset_client_rpc as jax_reset_rpc
from learning_at_home_tpu.utils.connection import (
    RemoteCallError as JaxRemoteCallError,
)
from learning_at_home_tpu.utils.serialization import pack_message
from learning_at_home_tpu_torch import native
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch.server.server import Server, background_server

REPO = Path(__file__).resolve().parents[1]
H = 16


@pytest.fixture(autouse=True)
def _reset_rpc():
    yield
    jax_reset_rpc()


def test_framepump_source_is_the_jax_packages_byte_for_byte():
    ours = (REPO / "learning_at_home_tpu_torch" / "native" / "framepump.cpp")
    theirs = REPO / "learning_at_home_tpu" / "native" / "framepump.cpp"
    assert ours.read_bytes() == theirs.read_bytes()


def test_the_library_lands_under_build():
    assert native.native_available()
    so = native.library_path()
    assert so.exists() and so.parent == REPO / "build" / "native"
    assert not list(native.SRC.parent.glob("*.so"))
    assert native.library_path() == so  # keyed by the source: stable


def _exchange(endpoint, payloads: list) -> list:
    """Raw frames: send every request on one connection before reading,
    then read the replies (bytes) in order."""
    s = socket.create_connection(endpoint, timeout=20)
    try:
        for payload in payloads:
            s.sendall(struct.pack("<I", len(payload)) + payload)
        out = []
        for _ in payloads:
            (n,) = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))
            out.append(s.recv(n, socket.MSG_WAITALL))
        return out
    finally:
        s.close()


def test_native_replies_are_the_asyncio_transports_bytes():
    """Forward, backward (sgd 0: no state change), info and an unknown
    uid, pipelined on one connection: the same reply bytes from both
    transports."""
    rs = np.random.RandomState(0)
    x = rs.randn(3, H).astype(np.float32)
    g = rs.randn(3, H).astype(np.float32)
    requests = [pack_message("forward", (x,), {"uid": "nt.0"}),
                pack_message("info", (), {"uid": "nt.1"}),
                pack_message("backward", (x, g), {"uid": "nt.0"}),
                pack_message("forward", (x,), {"uid": "nt.9"}),
                pack_message("forward", (x,), {"uid": "nt.1"})]
    replies = {}
    for transport in ("asyncio", "native"):
        with background_server(num_experts=2, hidden_dim=H,
                               expert_prefix="nt", seed=3,
                               optimizer=optim.sgd(0.0), device="cpu",
                               transport=transport) as (ep, srv):
            assert srv.transport == transport
            replies[transport] = _exchange(ep, requests)
            if transport == "native":
                frames = srv._headline_metrics()
                assert frames["lah_server_native_frames_in_total"] == 5
                assert frames["lah_server_native_frames_out_total"] == 5
    assert replies["native"] == replies["asyncio"]


def test_a_jax_client_against_the_native_transport():
    rs = np.random.RandomState(1)
    x = rs.randn(3, H).astype(np.float32)
    g = rs.randn(3, H).astype(np.float32)
    outs = {}
    for transport in ("asyncio", "native"):
        with background_server(num_experts=1, hidden_dim=H,
                               expert_prefix="jn", seed=5,
                               optimizer=optim.sgd(0.05), device="cpu",
                               transport=transport) as (ep, srv):
            e = JaxRemoteExpert("jn.0", ep)
            fwd = np.asarray(e.forward_blocking([x])[0])
            bwd = np.asarray(e.backward_blocking([x], [g])[0])
            fwd2 = np.asarray(e.forward_blocking([x])[0])
            assert e.info()["update_count"] == 1
            with pytest.raises(JaxRemoteCallError, match="unknown expert"):
                JaxRemoteExpert("jn.9", ep).forward_blocking([x])
            outs[transport] = (fwd, bwd, fwd2)
        jax_reset_rpc()
    for a, b in zip(outs["native"], outs["asyncio"]):
        np.testing.assert_array_equal(a, b)


def test_pipelined_requests_are_answered_in_order():
    with background_server(num_experts=4, hidden_dim=8, expert_prefix="ord",
                           seed=4, device="cpu", transport="native") as (ep, _):
        uids = [f"ord.{i % 4}" for i in range(8)]
        replies = _exchange(ep, [pack_message("info", (), {"uid": u})
                                 for u in uids])
    from learning_at_home_tpu.utils.serialization import unpack_message

    assert [unpack_message(r)[2]["name"] for r in replies] == uids


def test_an_unbuildable_pump_raises_and_never_falls_back(monkeypatch):
    with pytest.raises(ValueError, match="transport"):
        Server({}, transport="udp")
    monkeypatch.setattr(native, "_load", lambda: None)
    srv = Server({}, host="127.0.0.1", transport="native")
    with pytest.raises(RuntimeError, match="framepump unavailable"):
        srv.run_in_background()
    assert srv._tcp_server is None  # no asyncio listener was opened
    srv.shutdown()
