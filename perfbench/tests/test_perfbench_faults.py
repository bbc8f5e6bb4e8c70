"""A whole run but the look for a card, on the CPU at a tiny size, comes
out correct, and comes out not correct with the timed path broken
underneath: a step that returns its state unchanged, half of each batch
left out (the mean over the rest).  The compute is f32 here, so a sound run reads ~0 on every
number and each fault is judged by the cell's own limits."""

import time

import pytest

from conftest import tiny_train
from perfbench import run as bench
from perfbench.lib import train


class StateUnchanged(train.Program):
    def __init__(self, *args):
        super().__init__(*args)

        def step_fn(params, state, ids, tgt):
            (loss, metrics), _ = self.model.value_and_grad(params, ids, tgt)
            return params, state, loss, metrics

        self.step_fn = step_fn


class HalfBatch(train.Program):
    def __init__(self, *args):
        super().__init__(*args)
        inner = self.step_fn

        def step_fn(params, state, ids, tgt):
            half = ids.shape[0] // 2
            return inner(params, state, ids[:half], tgt[:half])

        self.step_fn = step_fn


def _run(cell, program_cls=None, trace=False):
    return bench.run_cell(cell, 2**31 + 3, 0.5, trace, "cpu",
                          time.perf_counter(), program_cls=program_cls)


def test_sound_training_run_is_correct():
    out = _run(tiny_train())
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_tokens_per_s", "train_step_ms_p90",
                                   "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [StateUnchanged, HalfBatch],
                         ids=lambda f: f.__name__)
def test_broken_training_is_not_correct(fault):
    res = _run(tiny_train(), fault)["result"]
    assert not res["correct"], res["checks"]


def test_traced_run_reads_the_host_metrics():
    out = _run(tiny_train(), trace=True)
    res = out["result"]
    # no card here: the device metrics find nothing and are left out
    assert "train_mfu" in res["metrics"]
    assert "fused_ce_roofline" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"]
