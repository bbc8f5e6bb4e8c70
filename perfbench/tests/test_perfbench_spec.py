"""BENCHMARK.json and the files it names load, and names are checked."""

import json
import re

import pytest

from perfbench import run as bench
from perfbench.lib import spec

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
UNCUT = {"dmoe256-s256", "dmoe256-s8192"}  # run at their published sizes


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads(name):
    cell = spec.load_cell(name)
    assert bench.runner(cell.traffic["kind"]).run
    assert cell.family.leaf_specs(cell.config)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names, (m["name"], m["moves"])
    if cell.traffic["kind"] == "train":
        assert set(cell.limits) == {"loss_gap", "grad_norm_gap", "change_gap"}


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    text = spec.metric_path(name).read_text()
    assert re.search(r"^def read\(run", text, re.M)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_is_under_paths(entry):
    assert entry["file"].startswith("perfbench/")
    cfg = spec.load_json(spec.REPO / entry["file"])
    assert spec.family_path(cfg["family"]).is_file()
    assert set(entry["reduced"]) <= set(cfg), entry["reduced"]
    assert UNCUT <= {c["name"] for c in BENCH["configs"]}
    if entry["name"] in UNCUT:
        assert entry["reduced"] == []


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", ".x", "", "x" * 65,
                                 "ü", "a\tb"])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)
    with pytest.raises((ValueError, KeyError)):
        spec.load_cell(bad)


@pytest.mark.parametrize("good", ["dmoe256-s256.train-b176", "_x", "9a.b-c"])
def test_good_names_pass(good):
    assert spec.check_name(good) == good
