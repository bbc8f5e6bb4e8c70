"""The one place that reads the port's fused Adafactor state.

The check needs each leaf's first gradient norm as the optimizer got it.
The train step returns no gradients, so the norm is worked out from the
optimizer's second moments after step 1, where the decay is 0 and each
moment is a mean of ``g ** 2 + eps``: the row moment ``v_row`` is the
mean over the largest dim (``d0``) of a factored leaf, ``v`` the whole
``g ** 2 + eps`` of an unfactored one.

That leans on the state's layout in ``ops/fused_adafactor.py``: the
fields ``count``, ``v_row``, ``v_col``, ``v``, a ``[1]`` sentinel where
a moment is not kept, the factoring rule and the moments stored in the
parameters' dtype.  :func:`first_grad_norms` asserts all of it and raises
:class:`StateLayoutError` on any mismatch, so a change to the state's
layout stops the run instead of being misread.  Such a change needs this
file brought up to date with it.  A state whose ``count`` is not 1 after
the first step is the program's fault, not a layout: the step was not
taken once, the norms read 0, and the check fails on them.
"""

from __future__ import annotations

from perfbench.lib import weights
from perfbench.reference import adafactor as ref_adafactor

FIELDS = ("count", "v_row", "v_col", "v")


class StateLayoutError(RuntimeError):
    """The optimizer state is not laid out as this adapter reads it."""


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise StateLayoutError(
            f"the fused Adafactor state does not match perfbench/lib/"
            f"adafactor_state.py: {what}")


def moment_shapes(shape: tuple) -> tuple[tuple, tuple, tuple]:
    """(v_row, v_col, v) shapes of a leaf of ``shape``, by the reference's
    factoring rule."""
    dims = ref_adafactor.factored_dims(shape)
    if dims is None:
        return (1,), (1,), shape
    d1, d0 = dims
    return (shape[:d0] + shape[d0 + 1:], shape[:d1] + shape[d1 + 1:], (1,))


def first_grad_norms(state, specs: list, dtype) -> list[float]:
    """Each leaf's gradient norm (in the order of ``specs``, a family's
    ``leaf_specs``) from the state after the first step (all 0 where the
    state does not count exactly one step); :class:`StateLayoutError` if
    the state is laid out otherwise."""
    _expect(tuple(getattr(state, "_fields", ())) == FIELDS,
            f"fields {getattr(state, '_fields', None)}, expected {FIELDS}")
    _expect(state.count.numel() == 1 and not state.count.is_floating_point(),
            f"count {state.count!r}, expected an integer scalar")
    stepped_once = int(state.count) == 1
    norms = []
    for path, shape, *_ in specs:
        name = "/".join(map(str, path))
        got = [weights.get_leaf(getattr(state, f), path) for f in FIELDS[1:]]
        for field, t, want in zip(FIELDS[1:], got, moment_shapes(shape)):
            _expect(tuple(t.shape) == want,
                    f"{name} {field} shape {tuple(t.shape)}, expected {want}")
            _expect(t.dtype == dtype,
                    f"{name} {field} dtype {t.dtype}, expected {dtype}")
        if not stepped_once:
            norms.append(0.0)
            continue
        v_row, _, v = got
        dims = ref_adafactor.factored_dims(shape)
        if dims is None:
            total = float(v.double().sum())
        else:
            total = float(v_row.double().sum()) * shape[dims[1]]
        numel = 1
        for n in shape:
            numel *= n
        norms.append(max(total - ref_adafactor.EPS * numel, 0.0) ** 0.5)
    return norms
