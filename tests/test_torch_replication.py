"""The port's expert replicas against the JAX package's: the ``replica``
RPC from a JAX client onto a torch server; a torch replica of a
JAX-hosted uid starts from the JAX hoster's weights (within the init
tolerance of ``tests/test_torch_init_parity.py``: 2 f32 ulp; bit for bit
on these draws); ``ReplicaSync`` between a JAX server and a torch server
ends with bitwise-equal params while each keeps its optimizer state.
Every wait is bounded."""

from __future__ import annotations

import logging
import time

import jax
import numpy as np
import optax
import pytest
import torch

from learning_at_home_tpu.client import reset_client_rpc as jax_reset_rpc
from learning_at_home_tpu.client.rpc import client_loop as jax_loop
from learning_at_home_tpu.client.rpc import pool_registry as jax_pools
from learning_at_home_tpu.dht import DHT as JaxDHT
from learning_at_home_tpu.server.server import Server as JaxServer
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.server import lifecycle
from learning_at_home_tpu_torch.server.server import Server

H = 16
ULP_TOL = 2


@pytest.fixture(autouse=True)
def _reset_rpc():
    yield
    reset_client_rpc()
    jax_reset_rpc()


def _leaves(params) -> list:
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(params)]


def _max_ulps(a_tree, b_tree) -> int:
    worst = 0
    for a, b in zip(_leaves(a_tree), _leaves(b_tree), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        d = np.abs(a.view(np.int32).astype(np.int64)
                   - b.view(np.int32).astype(np.int64))
        worst = max(worst, int(d.max()) if d.size else 0)
    return worst


def _empty_torch(**kw):
    return Server.create(num_experts=0, hidden_dim=H, host="127.0.0.1",
                         optimizer=optim.sgd(0.0), device="cpu", **kw)


def _wait(pred, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_replica_rpc_from_a_jax_client_onto_a_torch_server():
    jsrv = JaxServer.create(expert_uids=["ar.0"], hidden_dim=H,
                            optimizer=optax.sgd(0.0), start=False)
    tsrv = _empty_torch()
    try:
        pool = jax_pools().get(tsrv.endpoint)

        def replica(meta):
            return jax_loop().run(pool.rpc("replica", (), meta,
                                           timeout=20.0))[1]

        assert replica({"uid": "ar.0"}) == {
            "uid": "ar.0", "installed": True, "hosted": True}
        assert replica({"uid": "ar.0"})["installed"] is False  # idempotent
        with pytest.raises(Exception, match="uid"):
            replica({"uid": ""})
        assert tsrv.replica_uids == {"ar.0"}
        assert tsrv._telemetry_extra()["replicas"] == ["ar.0"]
        assert tsrv._headline_metrics()[
            "lah_server_replica_experts_total"] == 1
        assert _max_ulps(jsrv.experts["ar.0"].params,
                         tsrv.experts["ar.0"].state_dict()["params"]) \
            <= ULP_TOL
        # a draining server takes on no replica
        tsrv.drain(grace=0.0, quiesce_timeout=1.0, handoff=False)
        assert replica({"uid": "ar.1"})["installed"] is False
        assert "ar.1" not in tsrv.experts
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


@pytest.mark.parametrize("expert_cls", ["ffn", "transformer"])
def test_torch_replica_of_a_jax_hosted_uid_starts_within_init_tolerance(
        expert_cls):
    """add_replica on a torch server grows the uid from its crc32 key:
    the JAX hoster's weights, so a dispatch answered by the replica is
    the hoster's function."""
    uid = "rq.3"
    jsrv = JaxServer.create(expert_uids=[uid], expert_cls=expert_cls,
                            hidden_dim=H, optimizer=optax.sgd(0.0),
                            host="127.0.0.1")
    tsrv = Server.create(num_experts=0, expert_cls=expert_cls, hidden_dim=H,
                         host="127.0.0.1", optimizer=optim.sgd(0.0),
                         device="cpu")
    try:
        assert tsrv.add_replica(uid) is True
        assert tsrv.add_replica(uid) is False
        assert _max_ulps(jsrv.experts[uid].params,
                         tsrv.experts[uid].state_dict()["params"]) <= ULP_TOL
        rows = np.random.RandomState(0).randn(
            *((2, 3, H) if expert_cls == "transformer" else (4, H))
        ).astype(np.float32)
        np.testing.assert_allclose(
            tsrv.experts[uid].forward([rows])[0].numpy(),
            np.asarray(jsrv.experts[uid].forward([rows])[0]),
            rtol=2e-5, atol=2e-5)
        if expert_cls == "ffn":
            moe = RemoteMixtureOfExperts(
                in_features=H, grid_size=(4,), uid_prefix="rq",
                source=StaticExpertSource({uid: tsrv.endpoint}), k_best=1,
                k_min=1, forward_timeout=20.0)
            gate = moe.init_gate_params(jrandom.PRNGKey(0))
            y = moe(torch.from_numpy(rows), gate)
            assert torch.isfinite(y).all() and moe.samples_dropped == 0
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_replica_recipe_warns_and_restores_from_its_own_checkpoint(
        tmp_path, caplog):
    """A seed-path server warns that a replica's crc32 init may not be
    its hoster's; with a checkpoint root holding the uid it restores it."""
    root = str(tmp_path / "ck")
    seeded = Server.create(num_experts=1, expert_prefix="cp", hidden_dim=H,
                           host="127.0.0.1", optimizer=optim.adam(1e-3),
                           device="cpu")
    hoster = Server.create(expert_uids=["cp.7"], hidden_dim=H,
                           host="127.0.0.1", optimizer=optim.adam(1e-3),
                           device="cpu", start=False)
    try:
        with caplog.at_level(logging.WARNING):
            seeded._make_replica_backend("cp.9")
        assert any("seed-path" in r.getMessage() for r in caplog.records)
        rs = np.random.RandomState(2)
        hoster.experts["cp.7"].backward([rs.randn(3, H).astype(np.float32)],
                                        [rs.randn(3, H).astype(np.float32)])
        hoster.save_checkpoint(root)
        seeded.replica_checkpoint_root = root
        assert seeded.add_replica("cp.7") is True
        got = seeded.experts["cp.7"].state_dict()
        want = hoster.experts["cp.7"].state_dict()
        assert got["update_count"] == want["update_count"] == 1
        assert _max_ulps(want["params"], got["params"]) == 0
    finally:
        seeded.shutdown()
        hoster.shutdown()


def test_replica_sync_between_a_jax_and_a_torch_server_is_bitwise():
    """Two hosters of one uid, one per package, diverged on purpose (+1
    on the torch copy): one ReplicaSync round each leaves both with the
    same bits, the group mean; the torch copy's adam state stays its
    own."""
    boot = DHT()
    d_t = DHT(initial_peers=[boot.endpoint])
    d_j = JaxDHT(initial_peers=[boot.endpoint])
    jsrv = tsrv = None
    try:
        jsrv = JaxServer.create(expert_uids=["rs.0"], hidden_dim=H,
                                host="127.0.0.1", optimizer=optax.sgd(0.0),
                                dht=d_j, update_period=1.0)
        tsrv = Server.create(expert_uids=["rs.0"], hidden_dim=H,
                             host="127.0.0.1", optimizer=optim.adam(0.0),
                             dht=d_t, update_period=1.0, device="cpu")
        tb = tsrv.experts["rs.0"]
        rs = np.random.RandomState(3)
        tb.backward([rs.randn(2, H).astype(np.float32)],
                    [rs.randn(2, H).astype(np.float32)])  # adam state != 0
        opt_before = tb.state_dict()["opt_state"]
        pa = jsrv.experts["rs.0"].state_dict()["params"]
        tb.replace_params(jax.tree_util.tree_map(
            lambda t: t + np.float32(1.0), tb.state_dict()["params"]))
        sync_t = tsrv.enable_replica_sync("rs.0", period=0.5)
        sync_j = jsrv.enable_replica_sync("rs.0", period=0.5)
        assert tsrv.enable_replica_sync("rs.0") is sync_t  # idempotent
        _wait(lambda: sync_t.rounds >= 1 and sync_j.rounds >= 1,
              "a replica sync round on both sides")
        # both syncs stopped before reading: no later round interleaves
        tsrv._replica_syncs.pop("rs.0").stop()
        jsrv._replica_syncs.pop("rs.0").stop()
        got_t = tsrv.experts["rs.0"].state_dict()
        got_j = jsrv.experts["rs.0"].state_dict()["params"]
        for a, b, m in zip(_leaves(got_t["params"]), _leaves(got_j),
                           _leaves(pa), strict=True):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
            np.testing.assert_allclose(a, m + np.float32(0.5), atol=1e-5)
        for a, b in zip(_leaves(opt_before), _leaves(got_t["opt_state"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        assert sync_t.stats()["uid"] == "rs.0"
    finally:
        for srv in (jsrv, tsrv):
            if srv is not None:
                srv.shutdown()
        d_j.shutdown()
        for d in (d_t, boot):
            d.shutdown()


@pytest.mark.parametrize("handoff", ["zoo mismatch", "failed verification",
                                     "verified"])
def test_handoff_into_a_synced_replica_keeps_its_sync_running(
        handoff, monkeypatch):
    """A handoff into a uid whose ReplicaSync runs, refused before the
    install (another zoo), rolled back after it (verification fails) or
    installed, leaves that sync in place: its thread runs on and its next
    rounds write their group means again."""
    boot = DHT()
    dhts = [DHT(initial_peers=[boot.endpoint]) for _ in range(2)]
    servers, sender = [], None
    try:
        for d in dhts:
            servers.append(Server.create(
                expert_uids=["sy.0"], hidden_dim=H, host="127.0.0.1",
                optimizer=optim.adam(1e-3), dht=d, update_period=1.0,
                device="cpu"))
        dst = servers[0]
        syncs = [srv.enable_replica_sync("sy.0", period=0.2)
                 for srv in servers]
        _wait(lambda: min(s.rounds for s in syncs) >= 1,
              "a replica sync round on both hosters")
        sender = Server.create(
            expert_uids=["sy.0"], host="127.0.0.1", optimizer=optim.adam(1e-3),
            hidden_dim=2 * H if handoff == "zoo mismatch" else H,
            device="cpu", start=False)
        state = sender.experts["sy.0"].state_dict()
        if handoff == "failed verification":
            monkeypatch.setattr(lifecycle, "verify_manifest",
                                lambda leaves, manifest: False)
        if handoff == "verified":
            lifecycle.send_expert_handoff(dst.endpoint, "sy.0", state,
                                          timeout=10.0)
            assert "sy.0" in dst.migrated_in
        else:
            with pytest.raises(lifecycle.HandoffError):
                lifecycle.send_expert_handoff(dst.endpoint, "sy.0", state,
                                              timeout=10.0)
        assert dst._replica_syncs["sy.0"] is syncs[0]
        assert syncs[0]._thread.is_alive()
        after = syncs[0].rounds
        _wait(lambda: syncs[0].rounds > after,
              "a replica sync round after the handoff")
    finally:
        for srv in (*servers, sender):
            if srv is not None:
                srv.shutdown()
        for d in (*dhts, boot):
            d.shutdown()


def test_lifecycle_constants_are_the_jax_packages():
    from learning_at_home_tpu.server import lifecycle as jax_lifecycle

    for name in ("SERVING", "DRAINING", "DRAINED", "HANDOFF_PART_BYTES",
                 "HANDOFF_SESSION_TTL_S", "VERIFIED_INVARIANTS"):
        assert getattr(lifecycle, name) == getattr(jax_lifecycle, name)
    assert lifecycle.HandoffReceiver.MAX_SESSIONS == \
        jax_lifecycle.HandoffReceiver.MAX_SESSIONS
