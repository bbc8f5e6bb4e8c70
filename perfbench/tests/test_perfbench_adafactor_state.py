"""The adapter that reads the fused Adafactor's state gives each leaf's
first gradient norm, and refuses a state laid out otherwise."""

from collections import namedtuple

import pytest
import torch

from conftest import tiny_train
from perfbench.lib import adafactor_state, train, weights

SEED = 2**31 + 21


@pytest.fixture(scope="module")
def stepped():
    """(program after one step, the port's gradient norms at the start)."""
    cell = tiny_train()
    prog = train.Program(cell, SEED, "cpu")
    (_, _), grads = prog.model.value_and_grad(prog.params, prog.ids[0],
                                              prog.tgt[0])
    want = [float(torch.linalg.vector_norm(weights.get_leaf(grads, p).float()))
            for p, *_ in prog.specs]
    prog.step()
    return prog, want


def test_norms_are_the_first_gradients(stepped):
    prog, want = stepped
    got = adafactor_state.first_grad_norms(prog.state, prog.specs, prog.dtype)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # the moments are stored in bf16, as the parameters are
        assert g == pytest.approx(w, rel=1e-2, abs=1e-12)


def _swap_leaf(state, field, fn):
    """``state`` with one leaf of ``field`` (the first matrix of layer 0)
    replaced by ``fn(leaf)``."""
    layers = list(getattr(state, field)["layers"])
    layer = dict(layers[0])
    layer["wq"] = fn(layer["wq"])
    layers[0] = layer
    tree = dict(getattr(state, field), layers=tuple(layers))
    return state._replace(**{field: tree})


@pytest.mark.parametrize("count", [0, 2])
def test_a_step_not_taken_once_reads_zero(stepped, count):
    prog, _ = stepped
    state = prog.state._replace(count=torch.full_like(prog.state.count, count))
    got = adafactor_state.first_grad_norms(state, prog.specs, prog.dtype)
    assert got == [0.0] * len(got)


@pytest.mark.parametrize("fault", ["dtype", "shape", "fields"])
def test_another_layout_is_refused(stepped, fault):
    prog, _ = stepped
    state = prog.state
    if fault == "dtype":
        state = _swap_leaf(state, "v_row", lambda t: t.float())
    elif fault == "shape":
        state = _swap_leaf(state, "v_col", lambda t: t[:-1])
    else:
        other = namedtuple("Other", ("count", "v_row", "v_col", "nu"))
        state = other(*state)
    with pytest.raises(adafactor_state.StateLayoutError):
        adafactor_state.first_grad_norms(state, prog.specs, prog.dtype)
