"""The port server's DHT heartbeat and its CLI, read by the JAX package.

- A port server with a DHT re-declares its experts every
  ``update_period`` and publishes the ``telemetry.``, ``load.``,
  ``links.`` and ``replicas.wanted.`` records in the same bundle; a JAX
  DHT node joined to the port's DHT reads every one of them and parses it
  with the JAX package's parsers (and the port's own parsers agree).
- After shutdown the records expire within one TTL (2 × update_period):
  record expiry is the swarm's failure detector.
- ``routing="beam"`` runs against the DHT and picks what enumerating
  the grid picks; a trainer's ``TelemetryPublisher`` heartbeats into it.
- ``python -m learning_at_home_tpu_torch.server --device cpu`` boots,
  declares its experts through the DHT and answers the port's and the JAX
  package's clients; it takes the JAX CLI's graceful-drain and native
  transport flags, and without a card and without ``--device`` the CLI
  raises instead of falling back.
"""

import contextlib
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_at_home_tpu.client import reset_client_rpc as jax_reset_client
from learning_at_home_tpu.client.expert import RemoteExpert as JaxRemoteExpert
from learning_at_home_tpu.dht import DHT as JaxDHT
from learning_at_home_tpu.utils import telemetry as jax_telemetry
from learning_at_home_tpu.utils.subproc import clean_jax_subprocess_env
from learning_at_home_tpu_torch.client.expert import RemoteExpert
from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.optim import sgd
from learning_at_home_tpu_torch.server import __main__ as cli
from learning_at_home_tpu_torch.server.server import background_server
from learning_at_home_tpu_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 8
PERIOD = 0.5
PREFIX = "tp"  # the telemetry prefix


@pytest.fixture(autouse=True)
def _clean_clients():
    yield
    reset_client_rpc()
    jax_reset_client()


@contextlib.contextmanager
def _dhts():
    """A port bootstrap node, a port node for the server and a JAX node
    joined to them (the reader)."""
    boot = DHT(cache_ttl=0.0)
    nodes = [boot]
    try:
        nodes.append(DHT(initial_peers=[boot.endpoint]))
        nodes.append(JaxDHT(initial_peers=[boot.endpoint], cache_ttl=0.0))
        yield nodes
    finally:
        for n in reversed(nodes):
            n.shutdown()


def _wait_for(fn, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


@contextlib.contextmanager
def _heartbeating_server(server_dht):
    with background_server(num_experts=3, hidden_dim=H, expert_prefix="hb",
                           device="cpu", dht=server_dht,
                           update_period=PERIOD,
                           telemetry_prefix=PREFIX) as (ep, srv):
        yield ep, srv


def test_heartbeat_records_parse_with_jax_parsers(monkeypatch):
    monkeypatch.setenv("LAH_REPLICA_HOT_DEPTH", "0")  # every expert is hot
    with _dhts() as (boot, server_dht, jax_reader):
        with _heartbeating_server(server_dht) as (ep, srv):
            # one RPC, so this process's pools hold a measured link the
            # next heartbeat publishes under links.<prefix>
            RemoteExpert("hb.0", ep)(torch.ones(2, H))
            ep_key = f"{ep[0]}:{ep[1]}"
            links = _wait_for(
                lambda: jax_reader.get_sync(jax_telemetry.links_key(PREFIX),
                                            bypass_cache=True),
                "the links record")
            uids = ["hb.0", "hb.1", "hb.2"]
            assert jax_reader.get_experts_sync(uids) == {u: ep for u in uids}
            assert jax_reader._loop.run(jax_reader._get_alive("hb")) == {
                u: ep for u in uids}
            # telemetry.<prefix>: the metrics endpoint, role "server"
            peers = jax_telemetry.discover_telemetry(jax_reader, PREFIX)
            assert peers[f"server-{ep_key}"]["endpoint"] == (
                ep[0], srv.metrics_port)
            assert peers[f"server-{ep_key}"]["role"] == "server"
            port_peers = telemetry.discover_telemetry(boot, PREFIX)
            assert {k: {**v, "expires_at": 0} for k, v in port_peers.items()} \
                == {k: {**v, "expires_at": 0} for k, v in peers.items()}
            # load.<prefix>: queue depth, expert count, the hot map
            load = jax_reader.get_sync(jax_telemetry.load_key(PREFIX))
            parsed = jax_telemetry.parse_load_value(load[ep_key][0])
            assert parsed["n"] == 3 and set(parsed["hot"]) == set(uids)
            assert telemetry.parse_load_value(load[ep_key][0]) == parsed
            # links.<prefix>: this process's view of the server it dialed
            got = jax_telemetry.parse_links_value(links[ep_key][0])
            assert ep_key in got and got[ep_key]["rtt_s"] > 0
            assert telemetry.parse_links_value(links[ep_key][0]) == got
            # replicas.wanted.<prefix>: one entry per hot expert
            wanted = jax_reader.get_sync(
                jax_telemetry.replicas_wanted_key(PREFIX))
            assert set(wanted) == set(uids)
            for uid in uids:
                w = jax_telemetry.parse_wanted_value(wanted[uid][0])
                assert w["endpoint"] == ep and w["depth"] >= 0
                assert telemetry.parse_wanted_value(wanted[uid][0]) == w
            # every record carries the TTL of 2 update periods
            exp = load[ep_key][1]
            assert 0 < exp - time.time() <= 2 * PERIOD + 0.5


def test_heartbeat_records_expire_within_one_ttl_after_shutdown():
    with _dhts() as (boot, server_dht, jax_reader):
        keys = ["hb.1", "hb", jax_telemetry.load_key(PREFIX),
                jax_telemetry.telemetry_key(PREFIX)]
        with _heartbeating_server(server_dht):
            _wait_for(lambda: all(jax_reader.get_sync(k, bypass_cache=True)
                                  for k in keys), "the heartbeat's records")
            time.sleep(PERIOD)  # one more heartbeat lands
        t_down = time.monotonic()
        _wait_for(lambda: not any(jax_reader.get_sync(k, bypass_cache=True)
                                  for k in keys), "the records to expire",
                  timeout=2 * PERIOD + 2.0)
        assert time.monotonic() - t_down <= 2 * PERIOD + 1.0
        assert not any(boot.get_sync(k, bypass_cache=True) for k in keys)


def test_beam_routing_through_the_dht_equals_enumeration():
    """``routing="beam"`` walks the DHT's prefix records (first_k_active,
    then the leaf rows) and, with every expert alive, picks what
    enumerating the whole grid picks: the same outputs and gradients."""
    uids = [f"bm.{a}.{b}" for a in range(3) for b in range(2)]
    with _dhts() as (boot, server_dht, _), background_server(
            num_experts=0, expert_uids=uids, hidden_dim=H, device="cpu",
            dht=server_dht, update_period=PERIOD, optimizer=sgd(0.0)):
        _wait_for(lambda: len(boot._loop.run(boot._get_alive("bm"))) == 6,
                  "the grid's experts")
        rng = np.random.default_rng(1)
        x = rng.standard_normal((10, H)).astype(np.float32)
        gate = {"w0": rng.standard_normal((H, 3)).astype(np.float32),
                "w1": rng.standard_normal((H, 2)).astype(np.float32)}
        out = {}
        for routing in ("beam", "enumerate"):
            moe = RemoteMixtureOfExperts(
                in_features=H, grid_size=(3, 2), uid_prefix="bm", k_best=2,
                routing=routing, beam_size=2, source=boot,
                timeout_after_k_min=30.0)
            xt = torch.from_numpy(x).requires_grad_(True)
            g = {k: torch.from_numpy(v).requires_grad_(True)
                 for k, v in gate.items()}
            y = moe(xt, g)
            y.square().sum().backward()
            out[routing] = [y.detach(), xt.grad, g["w0"].grad, g["w1"].grad]
        for a, b in zip(out["beam"], out["enumerate"]):
            assert torch.equal(a, b)


def test_telemetry_publisher_heartbeats_a_trainer():
    with _dhts() as (boot, _, jax_reader):
        pub = telemetry.TelemetryPublisher(boot, prefix=PREFIX,
                                           peer_id="trainer-t", period=0.5)
        try:
            pub.start()
            peers = jax_telemetry.discover_telemetry(jax_reader, PREFIX)
            assert peers["trainer-t"]["role"] == "trainer"
            assert peers["trainer-t"]["endpoint"] == pub.endpoint
            doc = telemetry.fetch_json(pub.endpoint)
            assert doc is not None
        finally:
            pub.stop()
        _wait_for(lambda: "trainer-t" not in jax_telemetry.discover_telemetry(
            jax_reader, PREFIX), "the trainer's record to expire", 5.0)


@pytest.mark.parametrize("flags", [
    ["--drain-on-term"], ["--drain-grace", "3"],
    ["--drain-successor", "127.0.0.1:1"], ["--transport", "native"],
])
def test_cli_refuses_unported_flags(flags, capsys):
    """The JAX CLI's drain and transport flags are ported: none is refused
    any more, each parses into its value (the drain and native paths run
    in tests/test_torch_lifecycle.py and test_torch_native.py)."""
    want = {"--drain-on-term": ("drain_on_term", True),
            "--drain-grace": ("drain_grace", 3.0),
            "--drain-successor": ("drain_successor", "127.0.0.1:1"),
            "--transport": ("transport", "native")}[flags[0]]
    args = cli.build_parser().parse_args(["--no-dht", "--device", "cpu",
                                          *flags])
    assert getattr(args, want[0]) == want[1]
    assert not hasattr(cli, "refuse_unported")
    assert capsys.readouterr().err == ""


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--no-dht", "--num-experts", "1", "--hidden-dim", str(H)])


def test_cli_boots_declares_and_answers():
    boot = DHT(cache_ttl=0.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "learning_at_home_tpu_torch.server",
         "--device", "cpu", "--num-experts", "2", "--hidden-dim", str(H),
         "--expert-prefix", "cli", "--host", "127.0.0.1",
         "--initial-peers", f"{boot.endpoint[0]}:{boot.endpoint[1]}",
         "--update-period", "1", "--optimizer", "sgd", "--lr", "0.1",
         "--warmup", "1", "2"],
        env=clean_jax_subprocess_env(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        def alive():
            if proc.poll() is not None:
                raise AssertionError(f"server died: {proc.stdout.read()}")
            return boot._loop.run(boot._get_alive("cli"))

        found = _wait_for(alive, "the CLI's experts", timeout=120)
        assert set(found) == {"cli.0", "cli.1"}
        ep = found["cli.1"]
        x = np.random.default_rng(0).standard_normal((3, H)).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = RemoteExpert("cli.1", ep)(xt)
        y.sum().backward()
        assert y.shape == (3, H) and torch.isfinite(xt.grad).all()
        assert RemoteExpert("cli.1", ep).info()["update_count"] == 1
        # the JAX client gets the same forward from the port server
        jy = JaxRemoteExpert("cli.0", ep)(jnp.asarray(x))
        np.testing.assert_allclose(
            np.asarray(jy), RemoteExpert("cli.0", ep)(torch.from_numpy(x))
            .detach().numpy(), atol=2e-5, rtol=2e-5)
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
        boot.shutdown()
    assert proc.returncode == 0, out
    assert "serving 2 'ffn' experts" in out and "server shut down" in out
