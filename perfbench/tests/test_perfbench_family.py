"""A configuration names its model family, and a family with a tree of
its own runs through the harness with new files alone: the test writes a
benchmark of one cell (its ``BENCHMARK.json``, configuration, traffic,
limits and ``families/gqa_swiglu.py``, a copy of ``family_gqa_swiglu.py``
beside this file) into a directory of its own, points ``spec`` at it, and
runs the cell through ``run_cell`` on the CPU."""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from perfbench import run as bench
from perfbench.lib import spec, train, weights
from perfbench.lib.trace import range_device_ms

FAMILY = Path(__file__).with_name("family_gqa_swiglu.py")
CELL = "tiny-gqa.train-b8"
CONFIG = {"family": "gqa_swiglu", "vocab_size": 256, "d_model": 128,
          "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 64,
          "ffn_dim": 256, "seq_len": 16, "rms_eps": 1e-6,
          "compute_dtype": "float32"}
TRAFFIC = {"kind": "train", "batch": 8, "pool_batches": 4,
           "param_dtype": "bfloat16", "stack_layers": False,
           "optimizer": "fused_adafactor", "learning_rate": 0.001,
           "checked_steps": 2, "warmup_steps": 1, "traced_steps": 2}
LIMITS = {"loss_gap": 1e-05, "grad_norm_gap": 0.032, "change_gap": 0.4}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


@pytest.fixture
def own_bench(tmp_path, monkeypatch):
    """A checkout of one cell of the tiny family, which ``spec`` reads."""
    root = tmp_path / "perfbench"
    real = spec.load_json(spec.REPO / "BENCHMARK.json")
    _write(tmp_path / "BENCHMARK.json", {
        "configs": [{"name": "tiny-gqa", "file": "perfbench/configs/tiny-gqa.json",
                     "source": "a test", "reduced": [], "why": "a test"}],
        "workloads": [{"name": CELL, "config": "tiny-gqa", "traffic": "train-b8",
                       "chips": 1, "why": "a test"}],
        "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                       for m in real["end_to_end"]],
        "per_layer": []})
    _write(root / "configs" / "tiny-gqa.json", CONFIG)
    _write(root / "traffic" / "train-b8.json", TRAFFIC)
    _write(root / "limits" / f"{CELL}.json", LIMITS)
    (root / "families").mkdir()
    shutil.copy(FAMILY, root / "families" / "gqa_swiglu.py")
    monkeypatch.setattr(spec, "REPO", tmp_path)
    monkeypatch.setattr(spec, "ROOT", root)
    return root


class DroppedUp(train.Program):
    """The program with one term left out of its FFN: ``silu(x W_gate)``
    alone, without the product with ``x W_up``."""

    def __init__(self, *args):
        super().__init__(*args)
        self.model.ffn = lambda lp, x: (
            F.silu(x @ lp["gate_proj"]) @ lp["down_proj"])


def _run(program_cls=None, trace=False):
    cell = spec.load_cell(CELL)
    return bench.run_cell(cell, 2**31 + 7, 0.3, trace, "cpu",
                          time.perf_counter(), program_cls=program_cls)


def test_another_family_runs_correct(own_bench):
    out = _run()
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_tokens_per_s", "train_step_ms_p90",
                                   "setup_s"}
    cell = out["run"]["cell"]
    assert out["run"]["train_flops"] == pytest.approx(
        cell.family.train_flops_per_token(CONFIG) * 8 * 16 * res["attempted"])


def test_a_family_of_more_than_256_leaves_runs_correct(own_bench):
    cfg = dict(CONFIG, n_layers=29)
    _write(own_bench / "configs" / "tiny-gqa.json", cfg)
    family = spec.load_cell(CELL).family
    assert len(family.leaf_specs(cfg)) == 3 + 9 * 29 > 256
    res = _run()["result"]
    assert res["correct"], res["checks"]


def test_more_than_256_leaves_keep_their_values_in_either_layout():
    family = spec.load_file(FAMILY, "family")
    cfg = dict(CONFIG, n_layers=29)
    specs = family.leaf_specs(cfg)
    a = weights.make_params(family, cfg, 2**31 + 7, torch.float32, "cpu")
    b = weights.make_params(family, cfg, 2**31 + 7, torch.float32, "cpu",
                            stacked=True)
    assert len(a["layers"]) == 29
    drawn = set()
    for index, (path, _, init, _) in enumerate(specs):
        leaf = weights.get_leaf(a, path)
        assert torch.equal(leaf, weights.get_leaf(b, path))
        assert torch.equal(leaf, weights.draw_leaf(specs, index, 2**31 + 7,
                                                   torch.float32, "cpu"))
        if init == "normal":
            drawn.add(float(leaf.flatten()[0]))
    assert len(drawn) == sum(init == "normal" for _, _, init, _ in specs)


def test_another_family_fault_is_not_correct(own_bench):
    res = _run(DroppedUp)["result"]
    assert not res["correct"], res["checks"]
    assert res["checks"]["loss_gap"]["value"] > LIMITS["loss_gap"]


def test_traced_ranges_take_the_family_prefix(own_bench):
    ranges = _run(trace=True)["run"]["trace"].ranges
    assert {"layer*/attention", "layer*/ffn", "optimizer"} <= set(ranges)


def test_ranges_default_to_every_family_prefix(own_bench):
    assert spec.range_prefixes() == ("tiny/",)
    prog = train.Program(spec.load_cell(CELL), 2**31 + 7, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prog.step()
    ranges = range_device_ms(prof.events(), 1)
    assert ranges == range_device_ms(prof.events(), 1, "tiny/")
    assert {"layer*/attention", "layer*/ffn", "optimizer"} <= set(ranges)


def test_the_trees_share_only_the_layers():
    dmoe = spec.load_family("dmoe")
    cfg = spec.load_json(spec.ROOT / "configs" / "dmoe256-s256.json")
    ours = spec.load_file(FAMILY, "family")

    def keys(specs):
        return {k for path, *_ in specs for k in path if isinstance(k, str)}

    shared = keys(dmoe.leaf_specs(cfg)) & keys(ours.leaf_specs(CONFIG))
    assert shared == {"layers"}


def test_a_config_without_a_family_is_refused(own_bench):
    _write(own_bench / "configs" / "tiny-gqa.json",
           {k: v for k, v in CONFIG.items() if k != "family"})
    with pytest.raises(ValueError, match="configs/tiny-gqa.json names no "
                                         "model family"):
        spec.load_cell(CELL)


def test_an_unknown_family_names_the_file_it_looked_for(own_bench):
    _write(own_bench / "configs" / "tiny-gqa.json",
           dict(CONFIG, family="nosuch"))
    with pytest.raises(ValueError, match="families/nosuch.py"):
        spec.load_cell(CELL)
    _write(own_bench / "configs" / "tiny-gqa.json",
           dict(CONFIG, family="../lib/train"))
    with pytest.raises(ValueError, match="invalid family"):
        spec.load_cell(CELL)


def test_a_family_is_loaded_once(own_bench):
    assert spec.load_family("gqa_swiglu") is spec.load_family("gqa_swiglu")
    assert spec.range_prefixes() is spec.range_prefixes()


def test_a_family_may_hold_dataclasses(tmp_path):
    path = tmp_path / "with_dataclass.py"
    path.write_text("from __future__ import annotations\n"
                    "from dataclasses import dataclass\n"
                    "@dataclass\nclass Sizes:\n    d: int\n")
    assert spec.load_file(path, "family").Sizes(3).d == 3


def test_a_traffic_kind_is_found_by_file():
    assert bench.runner("train") is train
    for lib in ("spec", "check", "trace", "weights"):
        with pytest.raises(ValueError, match=f"lib/{lib}.py has no run"):
            bench.runner(lib)
    with pytest.raises(ValueError, match="lib/serve.py"):
        bench.runner("serve")
    with pytest.raises(ValueError, match="invalid traffic kind"):
        bench.runner("../run")
