"""The comparisons that decide ``correct``, and the readings they take.

Training: the loss of each checked step, each leaf's first gradient norm
and each leaf's change after the checked steps.  Each is taken from the
program and from the plain reference on the same weights and batches; a
number compared is the worst gap:

- ``loss_gap``: ``max_step |L_prog - L_ref| / |L_ref|``;
- ``grad_norm_gap``: ``max_leaf |n_prog - n_ref| / max(n_ref,
  median_leaf n_ref)``, the program's norm worked out from its optimizer
  state after one step (``lib/adafactor_state.py``);
- ``change_gap``: the same over each leaf's change ``|p_3 - p_0|``,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone).

"""

from __future__ import annotations

import statistics

import torch

ROUNDOFF_GRAD = 1e-3  # a leaf under this share of the median leaf's gradient


def change_norm(p_now: torch.Tensor, p_start: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(p_now.float() - p_start.float()))


def _worst(prog, ref, keep=None) -> tuple[float, int]:
    """(the worst leaf's gap, its index)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    if not idx:
        return 0.0, -1
    med = statistics.median(ref[i] for i in idx)
    return max((abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30), i)
               for i in idx)


def train_gaps(prog: dict, ref: dict, names=None) -> dict:
    """The three numbers compared, of two readings ``{"losses",
    "grad_norms", "changes"}`` (lists of floats, leaves in one order).
    With the leaves' ``names``, also which leaf each worst gap is of and
    how many leaves the change leaves out."""
    med = statistics.median(ref["grad_norms"])
    keep = [g >= ROUNDOFF_GRAD * med for g in ref["grad_norms"]]
    grad, grad_leaf = _worst(prog["grad_norms"], ref["grad_norms"])
    change, change_leaf = _worst(prog["changes"], ref["changes"], keep)
    out = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": grad,
        "change_gap": change,
    }
    if names is not None:
        out["detail"] = {"grad_norm_leaf": names[grad_leaf],
                         "change_leaf": names[change_leaf],
                         "left_out": [n for n, k in zip(names, keep) if not k]}
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, shown
