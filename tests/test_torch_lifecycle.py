"""The port's elastic lifecycle (``server/lifecycle.py``: graceful drain,
live handoff and migration) against the JAX package's, mirroring
``tests/test_lifecycle.py`` and ``tests/test_migration.py``: a JAX server
drains to a torch successor and a torch server to a JAX successor with
params, adam state and ``update_count`` bit for bit (the manifest of one
package verifies in the other); hostile handoff meta is refused; a
draining server refuses inbound handoffs; dispatch during a drain has
zero failures; restart from a checkpoint; ``migrate`` refusals.  Every
wait is bounded; no assertion depends on wall-clock time."""

from __future__ import annotations

import json
import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

from learning_at_home_tpu.client import reset_client_rpc as jax_reset_rpc
from learning_at_home_tpu.server import lifecycle as jax_lifecycle
from learning_at_home_tpu.server.server import Server as JaxServer
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.rpc import (
    client_loop,
    pool_registry,
    reset_client_rpc,
)
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.server import lifecycle
from learning_at_home_tpu_torch.server.server import Server
from learning_at_home_tpu_torch.utils.connection import RemoteCallError

H = 16


@pytest.fixture(autouse=True)
def _reset_rpc():
    yield
    reset_client_rpc()
    jax_reset_rpc()


def _leaves(state: dict) -> list:
    """A state's leaves in ``jax.tree_util``'s order, as the manifest."""
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(
        {"params": state["params"], "opt_state": state["opt_state"]})]


def assert_state_bitwise(a: dict, b: dict) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _train(backend, seed: int, steps: int = 2) -> None:
    """A few backward steps, so adam's moments and count are not trivial."""
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        x = rs.randn(4, H).astype(np.float32)
        backend.backward([x], [rs.randn(4, H).astype(np.float32)])


def _jax_server(**kwargs):
    return JaxServer.create(hidden_dim=H, host="127.0.0.1",
                            optimizer=optax.adam(1e-3), dht=None, **kwargs)


def _torch_server(**kwargs):
    return Server.create(hidden_dim=H, host="127.0.0.1",
                         optimizer=optim.adam(1e-3), dht=None, device="cpu",
                         **kwargs)


def _wait(pred, what: str, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


# ---- the wire: manifests agree across packages ----


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_fresh_manifests_agree_across_packages(opt):
    """One uid's fresh state (the same flax draw) flattens to the same
    leaves, dtypes (count int32) and crcs in both packages."""
    jopt, topt = {"adam": (optax.adam(1e-3), optim.adam(1e-3)),
                  "sgd": (optax.sgd(0.1), optim.sgd(0.1))}[opt]
    jsrv = JaxServer.create(expert_uids=["mf.0"], hidden_dim=H,
                            optimizer=jopt, start=False)
    tsrv = Server.create(expert_uids=["mf.0"], hidden_dim=H, optimizer=topt,
                         start=False, device="cpu")
    try:
        jl, jm = jax_lifecycle.flatten_state(jsrv.experts["mf.0"].state_dict())
        tl, tm = lifecycle.flatten_state(tsrv.experts["mf.0"].state_dict())
        assert tm == jm
        assert lifecycle.verify_manifest(jl, tm)
        assert jax_lifecycle.verify_manifest(tl, jm)
        if opt == "adam":
            assert any(m["dtype"] == "int32" and m["shape"] == [] for m in tm)
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_split_parts_and_verify_manifest_are_the_jax_packages():
    leaves = [np.zeros(n, np.float32) for n in (10, 10, 1000, 10)]
    for cap in (1, 100, 4000, 1 << 20):
        assert lifecycle.split_parts(leaves, cap) == \
            jax_lifecycle.split_parts(leaves, cap)
    assert lifecycle.split_parts([], 100) == [[]]
    leaves, manifest = lifecycle.flatten_state(
        {"params": {"w": np.arange(8, dtype=np.float32)},
         "opt_state": {"c": np.ones((2, 3), np.int32)}})
    assert manifest == jax_lifecycle.flatten_state(
        {"params": {"w": np.arange(8, dtype=np.float32)},
         "opt_state": {"c": np.ones((2, 3), np.int32)}})[1]
    flipped = [leaf.copy() for leaf in leaves]
    f32 = next(i for i, l in enumerate(leaves) if l.dtype == np.float32)
    flipped[f32][3] = np.nextafter(flipped[f32][3], np.float32(np.inf),
                                   dtype=np.float32)
    assert lifecycle.verify_manifest(leaves, manifest)
    assert not lifecycle.verify_manifest(flipped, manifest)
    assert not lifecycle.verify_manifest(leaves[:1], manifest)


# ---- drains across packages, both directions ----


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_drain_hands_off_bitwise_across_packages(direction):
    """Params, adam state and update_count arrive bit for bit; the
    successor verified its installed state against the sender's
    manifest, serves the migrated expert and counts it in."""
    uids = ["mig.0", "mig.1"]
    if direction == "jax_to_torch":
        src, dst = _jax_server(expert_uids=uids), _torch_server(num_experts=0)
    else:
        src, dst = _torch_server(expert_uids=uids), _jax_server(num_experts=0)
    try:
        _train(src.experts["mig.0"], 0)
        want = {uid: b.state_dict() for uid, b in src.experts.items()}
        x = np.random.RandomState(1).randn(3, H).astype(np.float32)
        fwd = np.asarray(src.experts["mig.0"].forward([x])[0])
        summary = src.drain(successor=dst.endpoint, grace=0.0,
                            quiesce_timeout=3.0)
        assert summary["handed_off"] == uids and summary["failed"] == []
        assert summary["checkpointed"] == [] and not src.experts
        for uid, state in want.items():
            got = dst.experts[uid].state_dict()
            assert_state_bitwise(state, got)
            assert got["update_count"] == state["update_count"]
        assert want["mig.0"]["update_count"] == 2
        assert dst.migrated_in == set(uids) and dst.handoff.received == 2
        np.testing.assert_allclose(
            np.asarray(dst.experts["mig.0"].forward([x])[0]), fwd,
            rtol=2e-5, atol=2e-5)
    finally:
        src.shutdown()
        dst.shutdown()


def test_handoff_overwrites_an_existing_replica_bitwise():
    src = _jax_server(expert_uids=["ow.0"])
    dst = _torch_server(expert_uids=["ow.0"])
    try:
        _train(src.experts["ow.0"], 2, steps=1)
        want = src.experts["ow.0"].state_dict()
        summary = src.drain(successor=dst.endpoint, grace=0.0,
                            quiesce_timeout=2.0)
        assert summary["handed_off"] == ["ow.0"]
        got = dst.experts["ow.0"].state_dict()
        assert_state_bitwise(want, got)
        assert got["update_count"] == 1 and "ow.0" in dst.migrated_in
        assert "ow.0" not in dst.replica_uids
    finally:
        src.shutdown()
        dst.shutdown()


def test_install_failing_verification_rolls_back(monkeypatch):
    """A mismatching installed state is refused and an existing backend
    keeps its own state."""
    dst = _torch_server(expert_uids=["rb.0"])
    src = _torch_server(expert_uids=["rb.0"], start=False)
    try:
        _train(src.experts["rb.0"], 3, steps=1)
        before = dst.experts["rb.0"].state_dict()
        real = lifecycle.verify_manifest
        monkeypatch.setattr(lifecycle, "verify_manifest",
                            lambda leaves, manifest: False)
        with pytest.raises(lifecycle.HandoffError, match="verification"):
            lifecycle.send_expert_handoff(
                dst.endpoint, "rb.0", src.experts["rb.0"].state_dict(),
                timeout=10.0)
        monkeypatch.setattr(lifecycle, "verify_manifest", real)
        assert_state_bitwise(before, dst.experts["rb.0"].state_dict())
        assert dst.handoff.rejected == 1 and dst.handoff.received == 0
    finally:
        src.shutdown()
        dst.shutdown()


def test_handoff_refused_without_recipe_falls_back_to_checkpoint(tmp_path):
    from learning_at_home_tpu_torch.utils.checkpoint import latest_step

    root = str(tmp_path / "fallback")
    src = _torch_server(expert_uids=["fb.0"])
    src.replica_checkpoint_root = root
    bare = Server({}, host="127.0.0.1", dht=None)  # no recipe
    bare.run_in_background()
    try:
        _train(src.experts["fb.0"], 4, steps=1)
        want = src.experts["fb.0"].state_dict()
        summary = src.drain(successor=bare.endpoint, grace=0.0,
                            quiesce_timeout=2.0)
        assert summary["handed_off"] == [] and summary["failed"] == ["fb.0"]
        assert summary["checkpointed"] == ["fb.0"]
        assert latest_step(root) == summary["checkpoint_step"]
        restarted = _torch_server(expert_uids=["fb.0"], start=False)
        restarted.load_checkpoint(root)
        assert_state_bitwise(want, restarted.experts["fb.0"].state_dict())
        restarted.shutdown()
    finally:
        src.shutdown()
        bare.shutdown()


def test_draining_server_refuses_inbound_handoff():
    src = _jax_server(expert_uids=["ch.0"])
    dst = _torch_server(num_experts=0)
    try:
        dst.drain(grace=0.0, quiesce_timeout=1.0, handoff=False)
        with pytest.raises(lifecycle.HandoffError, match="DRAINED"):
            lifecycle.send_expert_handoff(
                dst.endpoint, "ch.0", src.experts["ch.0"].state_dict(),
                timeout=10.0)
        assert "ch.0" not in dst.experts and dst.handoff.rejected == 1
    finally:
        src.shutdown()
        dst.shutdown()


def test_handoff_hostile_meta_rejected():
    """The JAX package's pinned handoff battery against a port server:
    every hostile entry is an error reply, nothing half-installs."""
    srv = _torch_server(num_experts=0)
    pool = pool_registry().get(srv.endpoint)
    path = os.path.join(os.path.dirname(__file__), "fuzz_corpus",
                        "handoff_meta.json")
    with open(path) as fh:
        corpus = json.load(fh)
    arr = np.ones(3, np.float32)
    manifest = [{"shape": [3], "dtype": "float32",
                 "crc": lifecycle._leaf_crc(arr)}]
    try:
        for case in corpus["cases"]:
            meta = {k: manifest if v == "$MANIFEST" else v
                    for k, v in case["meta"].items()}
            call = pool.rpc("handoff", (arr,) * case["tensors"], meta,
                            timeout=10.0)
            if case["expect"] == "ok":
                _, reply = client_loop().run(call)
                assert reply["ok"] is True, case["name"]
            else:
                with pytest.raises(RemoteCallError, match=case["match"]):
                    client_loop().run(call)
        # a wire-coded handoff is refused: migration travels the raw wire
        import ml_dtypes

        with pytest.raises(RemoteCallError, match="raw wire"):
            client_loop().run(pool.rpc(
                "handoff", (arr.astype(ml_dtypes.bfloat16),),
                {"uid": "h.1", "session": "s9", "part": 0, "n_parts": 1,
                 "manifest": manifest, "wire": "bfloat16"},
                timeout=10.0))
        assert "h.0" not in srv.experts and srv.handoff.received == 0
        assert srv.handoff._sessions == {}
    finally:
        srv.shutdown()


# ---- the drain state machine, the drain RPC, dispatch through a drain ----


def test_drain_flips_state_and_stops_expert_heartbeat():
    boot = DHT()
    d_a = DHT(initial_peers=[boot.endpoint])
    d_c = DHT(initial_peers=[boot.endpoint])
    srv = Server.create(expert_uids=["dr.0"], hidden_dim=8, host="127.0.0.1",
                        optimizer=optim.sgd(0.01), dht=d_a,
                        update_period=0.4, device="cpu")
    try:
        def alive():
            return client_loop().run(d_c.get_alive_experts_fresh("dr"))

        _wait(lambda: "dr.0" in alive(), "the expert's declaration")
        assert srv.lifecycle_state == lifecycle.SERVING
        summary = srv.drain(grace=0.0, quiesce_timeout=2.0, handoff=False)
        assert srv.lifecycle_state == lifecycle.DRAINED
        assert summary["handed_off"] == [] and srv.wait_drained(timeout=1.0)
        # the DRAINED server no longer re-declares: its record expires
        _wait(lambda: "dr.0" not in alive(), "the record to expire")
        with pytest.raises(RuntimeError, match="already draining"):
            srv.drain(grace=0.0)
        info = srv.lifecycle_info()
        assert info["state"] == lifecycle.DRAINED and info["restarts"] == 0
        assert srv._headline_metrics()["lah_server_draining"] == 1.0
    finally:
        srv.shutdown()
        for d in (d_a, d_c, boot):
            d.shutdown()


def test_drain_rpc_from_a_jax_client_migrates_and_reports_state():
    from learning_at_home_tpu.client.rpc import client_loop as jax_loop
    from learning_at_home_tpu.client.rpc import pool_registry as jax_pools

    src = _torch_server(expert_uids=["rp.0"])
    dst = _jax_server(num_experts=0)
    try:
        pool = jax_pools().get(src.endpoint)
        _, meta = jax_loop().run(pool.rpc(
            "drain", (), {"successor": list(dst.endpoint), "grace": 0.0},
            timeout=10.0))
        assert meta["draining"] is True and meta["started"] is True
        assert src.wait_drained(timeout=20.0)
        _, stats = jax_loop().run(pool.rpc("stats", (), {}, timeout=10.0))
        assert stats["lifecycle"]["state"] == lifecycle.DRAINED
        assert stats["lifecycle"]["drain_summary"]["handed_off"] == ["rp.0"]
        assert "rp.0" in dst.experts
        _, again = jax_loop().run(pool.rpc("drain", (), {}, timeout=10.0))
        assert again["started"] is False
        with pytest.raises(Exception, match="successor must be"):
            jax_loop().run(pool.rpc("drain", (), {"successor": "x"},
                                    timeout=10.0))
    finally:
        src.shutdown()
        dst.shutdown()


def test_drain_during_active_dispatch_zero_failures():
    """A JAX server drains to a torch server while a port MoE keeps
    stepping: zero quorum failures, zero dropped samples; the torch
    successor took the migrated experts over."""
    boot = DHT()
    d_b = DHT(initial_peers=[boot.endpoint])
    d_c = DHT(initial_peers=[boot.endpoint])
    from learning_at_home_tpu.dht import DHT as JaxDHT

    d_a = JaxDHT(initial_peers=[boot.endpoint])
    src = JaxServer.create(expert_uids=["lc.0", "lc.1"], hidden_dim=H,
                           host="127.0.0.1", optimizer=optax.adam(1e-3),
                           dht=d_a, update_period=0.4)
    dst = Server.create(expert_uids=["lc.2", "lc.3"], hidden_dim=H,
                        host="127.0.0.1", optimizer=optim.adam(1e-3),
                        dht=d_b, update_period=0.4, device="cpu")
    try:
        moe = RemoteMixtureOfExperts(
            in_features=H, grid_size=(4,), uid_prefix="lc", source=d_c,
            k_best=3, k_min=1, timeout_after_k_min=0.5,
            forward_timeout=20.0, backward_timeout=20.0, alive_ttl=0.4)
        _wait(lambda: len(client_loop().run(
            d_c.get_alive_experts_fresh("lc"))) == 4, "4 experts alive", 30)
        gate = moe.init_gate_params(jrandom.PRNGKey(0))
        rs = np.random.RandomState(0)
        failures = 0
        for step in range(16):
            if step == 4:
                assert src.start_drain(successor=dst.endpoint, grace=0.5,
                                       quiesce_timeout=5.0)
            x = torch.from_numpy(rs.randn(8, H).astype(np.float32))
            try:
                g = {k: v.detach().requires_grad_(True)
                     for k, v in gate.items()}
                loss = ((moe(x, g) - x.roll(1, 1)) ** 2).mean()
                loss.backward()
            except Exception:
                failures += 1
        assert src.wait_drained(timeout=30.0), "drain never finished"
        assert failures == 0
        assert moe.samples_dropped == 0 and moe.backward_samples_dropped == 0
        assert {"lc.0", "lc.1"} <= set(dst.experts)
        assert dst.handoff.received == 2
    finally:
        src.shutdown()
        dst.shutdown()
        for d in (d_b, d_c, boot):
            d.shutdown()
        d_a.shutdown()


def test_restart_from_checkpoint_rejoins_and_counts_restart(tmp_path):
    from learning_at_home_tpu_torch.utils.checkpoint import CheckpointManager

    root = str(tmp_path / "ckpt")
    srv1 = _torch_server(expert_uids=["rs.0"])
    srv2 = None
    try:
        _train(srv1.experts["rs.0"], 5, steps=1)
        step = CheckpointManager(root, keep_last=2).save_now(
            lambda s: srv1.save_checkpoint(root, s))
        assert step == 1
        want = srv1.experts["rs.0"].state_dict()
        srv1.shutdown()  # a hard kill: no drain, no final checkpoint
        srv2 = _torch_server(expert_uids=["rs.0"])
        assert srv2.load_checkpoint(root) == 1
        srv2.restarts = CheckpointManager(root, keep_last=2).record_restart()
        assert srv2.restarts == 1
        assert srv2.lifecycle_info()["restarts"] == 1
        assert_state_bitwise(want, srv2.experts["rs.0"].state_dict())
    finally:
        srv1.shutdown()
        if srv2 is not None:
            srv2.shutdown()


# ---- migrate ----


def _migrate(src_endpoint, uid, target, **extra):
    meta = {"uid": uid, "target": [target[0], target[1]], **extra}
    _, reply = client_loop().run(pool_registry().get(src_endpoint).rpc(
        "migrate", (), meta, timeout=30.0))
    return reply


def _wait_idle(srv, timeout: float = 30.0) -> dict:
    _wait(lambda: srv.placement_info()["migration_in_flight"] is None,
          "the migration slot", timeout)
    return srv.placement_info()


def test_migrate_rpc_moves_expert_bitwise_to_a_jax_server():
    src = _torch_server(expert_uids=["pl.0", "pl.1"])
    dst = _jax_server(num_experts=0)
    try:
        _train(src.experts["pl.0"], 6)
        want = src.experts["pl.0"].state_dict()
        reply = _migrate(src.endpoint, "pl.0", dst.endpoint)
        assert reply == {"uid": "pl.0", "started": True,
                         "state": lifecycle.SERVING}
        placement = _wait_idle(src)
        assert placement["migrations_out"] == 1
        assert placement["migration_failures"] == 0
        got = dst.experts["pl.0"].state_dict()
        assert_state_bitwise(want, got)
        assert got["update_count"] == want["update_count"] == 2
        assert "pl.0" not in src.experts and "pl.1" in src.experts
        assert src.lifecycle_state == lifecycle.SERVING
    finally:
        src.shutdown()
        dst.shutdown()


def test_migrate_rpc_validation_and_refusals():
    srv = _torch_server(expert_uids=["rv.0"])
    try:
        pool = pool_registry().get(srv.endpoint)
        for meta in ({"target": ["127.0.0.1", 1]},
                     {"uid": "", "target": ["127.0.0.1", 1]},
                     {"uid": "rv.0", "target": "not-an-endpoint"},
                     {"uid": "rv.0", "target": ["host-only"]},
                     {"uid": "ghost.0", "target": ["127.0.0.1", 1]}):
            with pytest.raises(RemoteCallError):
                client_loop().run(pool.rpc("migrate", (), meta,
                                           timeout=10.0))
        assert srv.placement_info()["migrations_out"] == 0
        # a dead target: the move fails in flight and the source keeps it
        reply = _migrate(srv.endpoint, "rv.0", ("127.0.0.1", 1),
                         timeout=2.0)
        assert reply["started"] is True
        placement = _wait_idle(srv)
        assert placement["migration_failures"] == 1
        assert placement["migrations_out"] == 0 and "rv.0" in srv.experts
        # a drained server refuses with started=False, not an error
        srv.drain(grace=0.0, quiesce_timeout=2.0, handoff=False)
        reply = _migrate(srv.endpoint, "rv.0", ("127.0.0.1", 1))
        assert reply["started"] is False
        assert reply["state"] == lifecycle.DRAINED
    finally:
        srv.shutdown()
