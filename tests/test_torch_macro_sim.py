"""The port's virtual-clock macro-sim (``learning_at_home_tpu_torch/sim``,
``analysis/placement.py``, ``experiments/dht_swarm_sim.py``) against the
JAX package's, on the CPU.

- ``python -m ...sim.runner``: the port's canonical report is the JAX
  runner's byte for byte at the same seed and scenario (the runner's
  determinism contract, across the two packages: every clock and entropy
  seam virtualized, the same real scheduler, admission, routing, DHT and
  placement code on both sides), and ``--check`` gives the same verdict.
- ``dht_swarm_sim --sizes 64``: the JAX script's report keys; the lookup
  hit rate and the store-RPC reduction pass the same floors (wall-clock
  numbers, so not compared value for value).
- ``placement.solve`` on the 512-expert clustered stress input gives the
  JAX plan's bytes.
- The clock and entropy seams patch and restore the port's modules, and
  the sim runs the port's real admission code.
"""

import importlib
import json
import os
import random
import sys

import pytest

from learning_at_home_tpu_torch.sim import clock as port_clock
from learning_at_home_tpu_torch.sim import runner as port_runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the runner's docstring scenario, and the JAX tests' tiny one at two seeds
SCENARIOS = {
    "docstring": ["--nodes", "200", "--servers", "48", "--gateways", "4",
                  "--experts", "64", "--trace", "poisson:60:6,burst:420:3",
                  "--churn", "4:kill:0.15", "--check"],
    **{f"tiny-seed{seed}": [
        "--seed", str(seed), "--nodes", "24", "--servers", "6",
        "--gateways", "2", "--experts", "8", "--trace",
        "poisson:40:2,burst:150:1", "--churn", "1.5:kill:0.34", "--slots",
        "16", "--check"] for seed in (0, 1)},
}


def _run_main(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_runner_report_is_the_jax_runners_byte_for_byte(scenario, capsys):
    from learning_at_home_tpu.sim import runner as jax_runner

    argv = SCENARIOS[scenario]
    want = _run_main(jax_runner.main, argv, capsys)
    got = _run_main(port_runner.main, argv, capsys)
    report = got[1].splitlines()[0]
    assert report == want[1].splitlines()[0]
    assert json.loads(report)["traffic"]["arrivals"] > 0
    # the same floors, the same verdict and failure lines
    assert got[0] == want[0]
    fails = [l for l in got[2].splitlines() if l.startswith("MACRO_SIM")]
    assert fails == [l for l in want[2].splitlines()
                     if l.startswith("MACRO_SIM")]
    assert got[1].splitlines()[1:] == want[1].splitlines()[1:]


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return None


def test_dht_swarm_sim_keys_and_floors(tmp_path, monkeypatch, capsys):
    from learning_at_home_tpu_torch.experiments import dht_swarm_sim
    from test_torch_experiments import jax_script

    argv = ["--sizes", "64", "--experts", "64", "--churn-rounds", "2",
            "--lookups", "100", "--check"]
    jax_mod = jax_script("dht_swarm_sim")
    monkeypatch.setattr(sys, "argv", ["dht_swarm_sim.py", *argv, "--json",
                                      str(tmp_path / "jax.json")])
    capsys.readouterr()
    assert jax_mod.main() == 0
    jax_out = capsys.readouterr().out
    assert dht_swarm_sim.main(argv + ["--json", str(tmp_path / "port.json")]
                              ) == 0
    port_out = capsys.readouterr().out
    assert "DHT_SWARM_SIM_OK" in jax_out and "DHT_SWARM_SIM_OK" in port_out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert _keys(got) == _keys(want)
    size = got["sizes"][0]
    assert size["nodes"] == 64
    assert size["churn"]["hit_rate"] >= 0.99
    assert size["heartbeat"]["reduction"] >= 4.0
    assert size["heartbeat"]["store_rpcs_per_key"] == \
        want["sizes"][0]["heartbeat"]["store_rpcs_per_key"]


def _stress_snapshot(link_model_cls, n_nodes=256, seed=0):
    """``tests/test_macro_sim.py``'s 512-expert clustered stress input:
    every node full (capacity 2), each co-activating pair split across
    anti-podal nodes."""
    lm = link_model_cls(seed, n_clusters=4)
    nodes = [f"10.0.0.{i // 250}:{31000 + i}" for i in range(n_nodes)]
    half = n_nodes // 2
    experts, coact = {}, {}
    for i in range(n_nodes):
        experts[f"a.{i:03d}"] = nodes[i]
        experts[f"b.{i:03d}"] = nodes[(i + half) % n_nodes]
        coact[f"a.{i:03d}|b.{i:03d}"] = 50
    links = {}
    for i in range(n_nodes):
        j = (i + half) % n_nodes
        rtt, bw = lm.link(31000 + i, 31000 + j)
        links.setdefault(nodes[i], {})[nodes[j]] = [rtt, bw]
    return {"experts": experts, "activations": {u: 1 for u in experts},
            "coact": coact, "links": links,
            "capacity": {n: 2 for n in nodes}}


@pytest.mark.parametrize("neighborhoods", [("move", "swap"), ("move",)])
def test_placement_plan_is_the_jax_plans_bytes(neighborhoods):
    from learning_at_home_tpu.analysis import placement as jax_placement
    from learning_at_home_tpu.sim.serving import LinkModel as JaxLinkModel
    from learning_at_home_tpu_torch.analysis import placement
    from learning_at_home_tpu_torch.sim.serving import LinkModel

    snap = _stress_snapshot(LinkModel)
    assert snap == _stress_snapshot(JaxLinkModel)
    assert len(snap["experts"]) == 512
    kw = dict(seed=11, max_moves=32, max_rounds=2,
              neighborhoods=neighborhoods)
    got = placement.plan_to_json(placement.solve(snap, **kw))
    assert got == jax_placement.plan_to_json(jax_placement.solve(snap, **kw))
    if neighborhoods == ("move", "swap"):
        assert json.loads(got)["moves"]  # the swaps reunite pairs


def test_clock_seams_patch_and_restore_the_ports_modules():
    assert port_clock.SEAMS and all(
        mod.startswith("learning_at_home_tpu_torch.")
        for mod, _, _ in port_clock.SEAMS)
    clk = port_clock.VirtualClock(step=0.0, start=42.0)
    originals = {(m, a): getattr(importlib.import_module(m), a)
                 for m, a, _ in port_clock.SEAMS}
    with port_clock.installed_clock(clk):
        for mod_name, attr, method in port_clock.SEAMS:
            assert getattr(importlib.import_module(mod_name), attr) == \
                getattr(clk, method), f"{mod_name}.{attr} not patched"
        from learning_at_home_tpu_torch.utils.timed_storage import (
            get_dht_time,
        )
        assert get_dht_time() == clk.epoch + 42.0
    for (mod_name, attr), orig in originals.items():
        assert getattr(importlib.import_module(mod_name), attr) is orig


def test_entropy_seam_seeds_the_ports_dht_ids():
    from learning_at_home_tpu.dht import routing as jax_routing
    from learning_at_home_tpu.sim import clock as jax_clock
    from learning_at_home_tpu_torch.dht import routing

    orig = routing._urandom
    with port_clock.installed_entropy(random.Random(7)):
        a = routing.DHTID.generate()
    with jax_clock.installed_entropy(random.Random(7)):
        b = jax_routing.DHTID.generate()
    assert routing._urandom is orig
    assert int(a) == int(b)  # the same seeded id in both packages


def test_sim_runs_the_ports_admission_code(monkeypatch):
    """Patch the port's real admission and the port's report changes: the
    sim calls ``AdmissionController.admit``, it does not reimplement it."""
    from learning_at_home_tpu_torch.gateway.admission import (
        AdmissionController,
    )

    def shed_everything(self, pages_needed=0):
        self.shed_total += 1
        return False, 1.0, "patched: always shed"

    monkeypatch.setattr(AdmissionController, "admit", shed_everything)
    rep = port_runner.run_macro_sim(
        seed=0, nodes=24, servers=6, gateways=2, experts=8,
        trace="poisson:40:2,burst:150:1", churn="1.5:kill:0.34", slots=16,
        lookup_period_s=0.5, placement_period_s=2.0, join_batch=8)
    assert rep["traffic"]["shed"] == rep["traffic"]["arrivals"] > 0
    assert rep["traffic"]["completed"] == 0
