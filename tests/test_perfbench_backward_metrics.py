"""The benchmark's readers of the backward's ranges by block
(``perfbench/metrics/``: ``attention_bwd_ms.train``, ``moe_bwd_ms.train``,
``loss_bwd_ms.train``, ``unattributed_ms.train``) on hand-built
``perfbench.lib.trace.Trace`` objects, and their entries in
``BENCHMARK.json``."""

import json

import pytest

from perfbench.lib import spec
from perfbench.lib.trace import Trace
from perfbench.run import read_metric

NEW = ["attention_bwd_ms.train", "moe_bwd_ms.train", "loss_bwd_ms.train",
       "unattributed_ms.train"]
CELLS = [w["name"] for w in json.loads(
    (spec.REPO / "BENCHMARK.json").read_text())["workloads"]]
RANGE_OF = {"attention_bwd_ms.train": "layer*/attention/backward",
            "moe_bwd_ms.train": "layer*/moe/backward",
            "loss_bwd_ms.train": "loss/backward"}

# device ms a step (2 steps traced) by range and kind, as range_device_ms
# gives them with the backward's ranges by block
RANGES = {
    "embed": {"index / scatter / gather": 1.5},
    "embed/backward": {"index / scatter / gather": 4.0},
    "layer*/attention": {"matmul (cuBLAS)": 200.0, "elementwise": 30.0},
    "layer*/attention/backward": {"matmul (cuBLAS)": 250.0, "reduce": 12.5},
    "layer*/moe": {"matmul (cuBLAS)": 300.0},
    "layer*/moe/backward": {"matmul (cuBLAS)": 400.0,
                            "index / scatter / gather": 110.0},
    "loss": {"fused CE (K1-K3)": 60.0},
    "loss/backward": {"fused CE (K1-K3)": 190.0, "copy / cast": 2.5},
    "backward": {"reduce": 20.0},  # the final norm's gradient, glue
    "optimizer": {"other": 100.0},
}


def trace(ranges: dict, kernel_ms: float, per: int = 2) -> Trace:
    """A trace of ``per`` steps whose device ops take ``kernel_ms`` a step
    in all (two ops a step)."""
    us = kernel_ms * 1e3 * per / (2 * per)
    kernels = [(f"k{i}", 10.0 * i * us, 10.0 * i * us + us)
               for i in range(2 * per)]
    return Trace(per=per, window_s=1.0, busy_s=0.5, kernels=kernels,
                 ranges=ranges)


def test_readers_read_their_ranges():
    run = {"trace": trace(RANGES, 2000.0)}
    assert read_metric("attention_bwd_ms.train", run) == pytest.approx(262.5)
    assert read_metric("moe_bwd_ms.train", run) == pytest.approx(510.0)
    assert read_metric("loss_bwd_ms.train", run) == pytest.approx(192.5)
    # 2000 less every range but "backward" (1660.5)
    assert read_metric("unattributed_ms.train", run) == pytest.approx(339.5)


@pytest.mark.parametrize("name", NEW)
def test_readers_are_silent_without_their_ranges(name):
    # the ranges of a program whose backward has no ranges by block
    old = {k: v for k, v in RANGES.items()
           if not k.endswith("/backward") and k != "embed"}
    assert read_metric(name, {"trace": trace(old, 2000.0)}) is None
    assert read_metric(name, {}) is None
    if name in RANGE_OF:
        without = {k: v for k, v in RANGES.items() if k != RANGE_OF[name]}
        assert read_metric(name, {"trace": trace(without, 2000.0)}) is None


@pytest.mark.parametrize("kernel_ms", [0.0, 1000.0, 1660.5])
def test_unattributed_never_below_zero(kernel_ms):
    value = read_metric("unattributed_ms.train",
                        {"trace": trace(RANGES, kernel_ms)})
    assert value == pytest.approx(0.0)
    assert value >= 0.0


def test_unattributed_counts_what_no_block_explains():
    # "backward" counts as unattributed: its kernels are in no block
    ranges = dict(RANGES, backward={"reduce": 500.0})
    assert read_metric("unattributed_ms.train",
                       {"trace": trace(ranges, 2000.0)}) == pytest.approx(339.5)
    ranges = dict(RANGES, optimizer={"other": 0.0})
    assert read_metric("unattributed_ms.train",
                       {"trace": trace(ranges, 2000.0)}) == pytest.approx(439.5)


@pytest.mark.parametrize("cell", CELLS)
def test_new_metrics_load_for_every_cell(cell):
    loaded = spec.load_cell(cell)
    entries = {m["name"]: m for m in loaded.per_layer}
    e2e = {m["name"] for m in loaded.end_to_end}
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "train_tokens_per_s" and m["moves"] in e2e
        assert m["source"] == "device_trace"
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert spec.metric_path(name).exists()
    assert [entries[n]["layer"] for n in NEW] == [
        "attention", "MoE", "loss", "model step"]
