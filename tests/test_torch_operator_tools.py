"""The port's lah_top, lah_rebalance and build_corpus
(``learning_at_home_tpu_torch/tools/``, ``experiments/build_corpus.py``)
against the JAX repo's ``tools/`` and ``experiments/`` twins, on the CPU.

- lah_top: ``render``, ``fleet_latency_rows`` and ``slo_rows`` give the
  JAX tool's output on the JAX tests' rows (gateway, lifecycle and fleet
  panels), and ``--once --json`` through a DHT finds two live port
  servers and a port trainer's ``TelemetryPublisher``.
- lah_rebalance: ``plan_actions``, ``build_snapshot`` and ``sample_slo``
  return the JAX tool's values; ``--plan`` prints the JAX tool's bytes,
  the same in two processes; one live ``run_pass`` grows exactly one
  replica, on the less-loaded of two port servers.
- build_corpus: ``clean``, ``natural_language_score`` and
  ``harvest_docstrings`` return the JAX script's values on installed
  files, and the script reads the interpreter's own directories.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import sysconfig
import time

import pytest

from learning_at_home_tpu.utils.sketch import QuantileSketch
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.experiments import build_corpus
from learning_at_home_tpu_torch.server.server import Server
from learning_at_home_tpu_torch.tools import (
    collect_gate,
    lah_rebalance,
    lah_top,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jax_top = importlib.import_module("tools.lah_top")
jax_rebalance = importlib.import_module("tools.lah_rebalance")
_spec = importlib.util.spec_from_file_location(
    "jax_build_corpus", os.path.join(REPO, "experiments", "build_corpus.py"))
jax_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_corpus)


@pytest.fixture(autouse=True)
def _reset_rpc():
    yield
    reset_client_rpc()


# ---- lah_top: the panels on the JAX tests' rows ----


def _peer(peer_id, snapshot, role="gateway"):
    return {"peer_id": peer_id, "role": role, "endpoint": "127.0.0.1:0",
            "expires_at": 0.0, "snapshot": snapshot}


def _hist(values, with_sketch=True):
    sk = QuantileSketch()
    for v in values:
        sk.add(v)
    out = {"count": len(values), "sum": sum(values), "buckets": {}}
    if with_sketch:
        out["sketch"] = sk.to_dict()
    return out


def _section_row(peer_id, role, key, section):
    return {"peer_id": peer_id, "role": role,
            "endpoint": ("127.0.0.1", 1), "expires_at": 0.0,
            "snapshot": {key: section, "metrics": {}}}


ROWS = {
    "gateway": [
        _section_row("gw-1", "gateway", "gateway", {
            "streams_active": 3, "streams_total": 41, "slots": 8,
            "slots_in_use": 2, "shed_total": 7, "kv_pages_total": 33,
            "kv_pages_used": 12, "prefix_hits_total": 5}),
        _section_row("gw-dense", "gateway", "gateway", {
            "streams_active": 1, "streams_total": 2, "slots": 4,
            "slots_in_use": 1, "shed_total": 0}),
        {"peer_id": "srv-1", "role": "server",
         "endpoint": ("127.0.0.1", 2), "expires_at": 0.0, "snapshot": {}},
    ],
    "lifecycle": [
        _section_row("srv-serving", "server", "lifecycle", {
            "state": "SERVING", "uptime_s": 12.3, "restarts": 2}),
        _section_row("srv-draining", "server", "lifecycle", {
            "state": "DRAINING", "uptime_s": 5.0, "restarts": 0}),
        {"peer_id": "trainer-1", "role": "trainer",
         "endpoint": ("127.0.0.1", 2), "expires_at": 0.0, "snapshot": {}},
        _section_row("srv-weird", "server", "lifecycle", {"state": 42}),
    ],
    "fleet-sketch": [
        _peer("gw-slow", {"metrics": {"histograms": {
            "lah_x_seconds": _hist([1.0] * 5)}}}),
        _peer("gw-fast", {"metrics": {"histograms": {
            "lah_x_seconds": _hist([0.001] * 995)}}}),
    ],
    "fleet-partial": [
        _peer("gw-new", {"metrics": {"histograms": {
            "lah_x_seconds": _hist([0.5] * 10)}}}),
        _peer("gw-old", {"metrics": {"histograms": {
            "lah_x_seconds": _hist([0.5] * 10, with_sketch=False)}}}),
    ],
    "fleet-junk": [
        _peer("dead", None),
        _peer("junk1", {"metrics": "nope"}),
        _peer("junk2", {"metrics": {"histograms": [1, 2]}}),
        _peer("junk3", {"metrics": {"histograms": {"lah_x_seconds": {
            "count": 3, "sketch": {"kind": "garbled"}}}}}),
    ],
    "fleet-labeled": [_peer("gw", {"metrics": {"histograms": {
        "lah_x_seconds": {'{"pool": "a"}': _hist([0.1] * 4),
                          '{"pool": "b"}': _hist([0.2] * 4)}}}})],
    "slo": [
        _peer("gw-1", {"metrics": {"collected": {
            "lah_slo_gateway_ttft_state": 2.0,
            "lah_slo_gateway_ttft_fast_burn": 21.5,
            "lah_slo_gateway_ttft_slow_burn": 16.0,
            "lah_slo_gateway_ttft_objective": 0.99}}}),
        _peer("gw-2", {"metrics": {"collected": {
            "lah_slo_gateway_ttft_state": "paged",
            "lah_server_jobs_processed_total": 9.0}}}),
        _peer("dead", None),
    ],
    "fleet-and-slo": [
        _peer("gw-1", {"metrics": {
            "collected": {"lah_slo_gateway_ttft_state": 1.0,
                          "lah_slo_gateway_ttft_fast_burn": 4.0,
                          "lah_slo_gateway_ttft_slow_burn": 3.5,
                          "lah_slo_gateway_ttft_objective": 0.99},
            "histograms": {"lah_gateway_ttft_seconds": _hist([0.05] * 20)},
        }}),
        _peer("junk", {"metrics": {"histograms": 3, "collected": []}}),
        _peer("dead", None),
    ],
}


@pytest.mark.parametrize("rows", list(ROWS))
def test_lah_top_panels_are_the_jax_tools(rows, monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda *a: "12:34:56")
    got, want = ROWS[rows], ROWS[rows]
    for dead in (set(), {"srv-gone"}):
        text = lah_top.render(got, "swarm", dead=dead)
        assert text == jax_top.render(want, "swarm", dead=dead)
        assert "12:34:56" in text
    assert lah_top.fleet_latency_rows(got) == jax_top.fleet_latency_rows(
        want)
    assert lah_top.slo_rows(got) == jax_top.slo_rows(want)
    assert [lah_top.peer_health(r) for r in got] == [
        jax_top.peer_health(r) for r in want]


def test_lah_top_fleet_p99_is_the_fast_mass():
    (row,) = lah_top.fleet_latency_rows(ROWS["fleet-sketch"])
    assert row["source"] == "sketch" and row["count"] == 1000
    assert abs(row["p99"] - 0.001) <= 0.001 * 0.011


# ---- lah_rebalance: the pure steps and --plan ----

EP_A, EP_B, EP_C = ("10.0.0.1", 9000), ("10.0.0.2", 9000), ("10.0.0.3", 9000)
NODE_A, NODE_B = "10.0.0.1:31330", "10.0.0.2:31330"


def _key(ep):
    return f"{ep[0]}:{ep[1]}"


PLAN_CASES = [
    ({"h.0": {"depth": 12.0, "endpoint": EP_A},
      "h.1": {"depth": 30.0, "endpoint": EP_A}},
     {_key(EP_A): {"q": 9.0, "n": 4}, _key(EP_B): {"q": 0.0, "n": 1},
      _key(EP_C): {"q": 0.0, "n": 1}},
     {"h.0": {EP_A}, "h.1": {EP_A}}, 2),
    ({"h.0": {"depth": 12.0, "endpoint": EP_A}},
     {_key(EP_A): {"q": 0.0, "n": 1}, _key(EP_B): {"q": 0.0, "n": 1}},
     {"h.0": {EP_A, EP_B}}, 2),
    ({"h.0": {"depth": 12.0, "endpoint": EP_A}},
     {_key(EP_A): {"q": 0.0, "n": 1}}, {"h.0": {EP_A}}, 2),
    ({"h.0": {"depth": 5.0}, "h.1": {"depth": 5.0}, "h.2": {}},
     {_key(EP_A): {"q": 2.0}, _key(EP_B): {"q": 1.0, "n": 3},
      "no-port": {"q": 0.0}}, {}, 3),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_actions_are_the_jax_tools(case):
    got = lah_rebalance.plan_actions(*PLAN_CASES[case])
    assert got == jax_rebalance.plan_actions(*PLAN_CASES[case])
    if case == 0:
        assert [(a["uid"], a["target"]) for a in got] == [
            ("h.1", EP_B), ("h.0", EP_C)]


SNAPSHOT_ROWS = [
    {"peer_id": "srv-a", "role": "server", "snapshot": {
        "endpoint": ["10.0.0.1", 31330], "experts": {"e.0": 5, "e.2": 3}}},
    {"peer_id": "srv-b", "role": "server", "snapshot": {
        "endpoint": ["10.0.0.2", 31330], "experts": {"e.1": 4, "e.3": 2}}},
    {"peer_id": "trn-a", "role": "trainer", "snapshot": {
        "dispatch": {"placement": {
            "coact": {"e.0|e.1": 50, "e.2|e.3": 40},
            "coact_dispatches": 90,
            "links": {NODE_A: {"rtt_s": 0.002, "bw_bps": 2e8}},
            "bytes_per_dispatch": 1.5e6}},
        "metrics": {"collected": {
            "lah_client_dispatch_p99_ms": 80.0,
            "lah_client_samples_total": 100,
            "lah_client_samples_dropped_total": 10}}}},
    {"peer_id": "trn-b", "role": "trainer", "snapshot": {"metrics": {
        "collected": {"lah_client_dispatch_p99_ms": 120.0,
                      "lah_client_samples_total": 100,
                      "lah_client_samples_dropped_total": 0}}}},
    {"peer_id": "dead", "role": "server", "snapshot": None},
]


@pytest.mark.parametrize("rows,links,capacity", [
    (SNAPSHOT_ROWS, {NODE_A: {NODE_B: {"rtt_s": 0.04, "bw_bps": 5e7}}},
     None),
    (SNAPSHOT_ROWS, None, 3),
    ([None, {}, {"snapshot": 5}, {"peer_id": "x", "snapshot": {
        "endpoint": ["h"], "experts": {"u": 1},
        "dispatch": {"placement": {"coact": "nope"}}}}], "junk", None),
])
def test_build_snapshot_and_sample_slo_are_the_jax_tools(rows, links,
                                                        capacity):
    got = lah_rebalance.build_snapshot(rows, links, capacity=capacity)
    assert got == jax_rebalance.build_snapshot(rows, links,
                                               capacity=capacity)
    assert lah_rebalance.sample_slo(rows) == jax_rebalance.sample_slo(rows)


def test_sample_slo_takes_worst_trainer():
    slo = lah_rebalance.sample_slo(SNAPSHOT_ROWS)
    assert slo["p99_ms"] == 120.0
    assert abs(slo["shed_fraction"] - 0.05) < 1e-12


def test_plan_cli_prints_the_jax_tools_bytes(tmp_path):
    """On the placement gate's fixtures, the port gate's own copies (each
    equal to the JAX gate's)."""
    jax_gate = importlib.import_module("tools.collect_gate")
    assert collect_gate._PLACEMENT_FIXTURE == jax_gate._PLACEMENT_FIXTURE
    assert collect_gate._PLACEMENT_SWAP_FIXTURE == \
        jax_gate._PLACEMENT_SWAP_FIXTURE
    outs = {}
    for label, fixture in (("skewed", collect_gate._PLACEMENT_FIXTURE),
                           ("swap", collect_gate._PLACEMENT_SWAP_FIXTURE)):
        path = tmp_path / f"{label}.json"
        path.write_text(json.dumps(fixture))
        argv = ["--plan", str(path), "--seed", "0"]
        port = [subprocess.run(
            [sys.executable, "-m",
             "learning_at_home_tpu_torch.tools.lah_rebalance", *argv],
            capture_output=True, timeout=120, cwd=REPO) for _ in range(2)]
        jax = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "lah_rebalance.py"),
             *argv], capture_output=True, timeout=120, cwd=REPO)
        assert [r.returncode for r in port + [jax]] == [0, 0, 0]
        assert port[0].stdout == port[1].stdout == jax.stdout
        outs[label] = json.loads(port[0].stdout)
    for plan in outs.values():
        assert plan["moves"] and plan["cost_after"] < plan["cost_before"]


# ---- live: lah_top --once --json and one run_pass on port servers ----


@contextlib.contextmanager
def _swarm(n_experts: list):
    """A bootstrap DHT node and one port CPU server per entry of
    ``n_experts`` (uids ``rb.<i>`` numbered across servers), each
    heartbeating its telemetry and load records every second."""
    boot = DHT()
    dht = DHT(initial_peers=[boot.endpoint])
    servers = []
    try:
        uid = 0
        for n in n_experts:
            servers.append(Server.create(
                expert_uids=[f"rb.{uid + i}" for i in range(n)],
                hidden_dim=8, optimizer=optim.sgd(0.0), host="127.0.0.1",
                dht=dht, update_period=1.0, device="cpu"))
            uid += n
        yield boot, dht, servers
    finally:
        for srv in servers:
            srv.shutdown()
        dht.shutdown()
        boot.shutdown()


def _wait(pred, what: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.2)


def test_lah_top_once_json_finds_two_servers_and_a_trainer(capsys):
    from learning_at_home_tpu_torch.utils.telemetry import (
        TelemetryPublisher,
        discover_telemetry,
    )

    with _swarm([1, 1]) as (boot, dht, servers):
        telemetry = TelemetryPublisher(dht, role="trainer",
                                       period=1.0).start()
        try:
            _wait(lambda: sorted(p["role"] for p in discover_telemetry(
                boot).values()) == ["server", "server", "trainer"],
                "three telemetry records")
            capsys.readouterr()
            rc = lah_top.main(["--once", "--json", "--initial-peers",
                               f"{boot.endpoint[0]}:{boot.endpoint[1]}"])
            doc = json.loads(capsys.readouterr().out.splitlines()[-1])
        finally:
            telemetry.stop()
        assert rc == 0
        peers = {p["peer_id"]: p for p in doc["peers"]}
        for srv in servers:
            row = peers[f"server-127.0.0.1:{srv.port}"]
            assert row["role"] == "server" and row["health"] == "ok"
            assert row["snapshot"]["endpoint"] == ["127.0.0.1", srv.port]
            assert set(row["snapshot"]["experts"]) == set(srv.experts)
        (trainer,) = [p for p in doc["peers"] if p["role"] == "trainer"]
        assert trainer["snapshot"] is not None
        assert doc["dead"] == []


def test_run_pass_grows_one_replica_on_the_less_loaded_server():
    """Server A hosts the hot ``rb.0``; B hosts two experts, C one.  The
    pass reads the hot record, every server's load heartbeat and
    ``rb.0``'s replica set from the DHT, and asks C (the less loaded
    candidate) for a replica, which C installs and then hosts."""
    from learning_at_home_tpu_torch.utils.telemetry import (
        load_key,
        replicas_wanted_key,
    )

    with _swarm([1, 2, 1]) as (_boot, dht, (a, b, c)):
        _wait(lambda: len(dht.get_sync(load_key("swarm"),
                                       bypass_cache=True)) == 3,
              "three load records")
        assert dht.store_sync(replicas_wanted_key("swarm"),
                              [20.0, "127.0.0.1", a.port], 60.0,
                              subkey="rb.0")
        actions = lah_rebalance.run_pass(dht, "swarm", max_replicas=2,
                                         sync=False)
        assert actions == [{"uid": "rb.0", "target": ("127.0.0.1", c.port),
                            "depth": 20.0, "installed": True,
                            "hosted": True}]
        assert c.replica_uids == {"rb.0"} and "rb.0" in c.experts
        assert b.replica_uids == set() and set(b.experts) == {"rb.1", "rb.2"}
        assert set(a.experts) == {"rb.0"}


# ---- build_corpus ----


def _installed_files():
    site = pathlib.Path(sysconfig.get_paths()["purelib"])
    stdlib = pathlib.Path(sysconfig.get_paths()["stdlib"])
    return [stdlib / "textwrap.py", stdlib / "argparse.py",
            site / "numpy" / "linalg" / "_linalg.py",
            site / "numpy" / "lib" / "_function_base_impl.py"]


@pytest.mark.parametrize("i", range(4))
def test_build_corpus_scoring_and_cleaning_are_the_jax_scripts(i):
    path = _installed_files()[i]
    if not path.exists():  # numpy 1.x names these modules without "_"
        path = path.with_name(path.name.lstrip("_").replace("_impl", ""))
    got = build_corpus.harvest_docstrings(path)
    assert got and got == jax_corpus.harvest_docstrings(path)
    for ds in got:
        assert build_corpus.natural_language_score(ds) == \
            jax_corpus.natural_language_score(ds)
        assert build_corpus.clean(ds) == jax_corpus.clean(ds)


def test_build_corpus_reads_the_interpreters_directories():
    assert build_corpus.SITE == pathlib.Path(sysconfig.get_paths()["purelib"])
    assert build_corpus.STDLIB == pathlib.Path(
        sysconfig.get_paths()["stdlib"])
    assert build_corpus.PACKAGES == jax_corpus.PACKAGES
