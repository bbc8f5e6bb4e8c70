"""The control and the faults come out as not correct, the program as
correct.  On the card (``-m cuda``) at each cell's own size on three
seeds, against the cell's limits; on the CPU at a tiny size in the cells'
bf16 compute, where the control reads three times the program's reading
or more on at least one number."""

import pytest

from conftest import tiny_train
from perfbench import control
from perfbench.lib import spec

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CELLS = [w["name"] for w in spec.load_json(spec.REPO / "BENCHMARK.json")["workloads"]]


def test_control_separates_at_a_tiny_size():
    cell = tiny_train(compute="bfloat16")
    rows = control.train_seed(cell, SEEDS[0], "cpu", True)
    prog = next(r for r in rows if r["side"] == "program")
    low = next(r for r in rows if r["side"] == "control_fp8")
    names = [k for k in prog if k not in ("side", "detail")]
    assert any(low[k] >= 3 * prog[k] for k in names), (prog, low)
    for row in rows:
        if row["side"] not in ("program", "control_fp8"):  # the faults
            assert any(row[k] >= 3 * prog[k] for k in names), row


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_on_the_card(card, name):
    cell = spec.load_cell(name)
    for seed in SEEDS:
        for row in control.train_seed(cell, seed, card, True):
            numbers = {k: v for k, v in row.items()
                       if k not in ("side", "detail")}
            within = all(v <= cell.limits[k] for k, v in numbers.items())
            assert within == (row["side"] == "program"), (seed, row)
