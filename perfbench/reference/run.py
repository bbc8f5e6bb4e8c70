"""Driving the plain reference: the checked training steps.  It draws the
weights from the seed again (``perfbench/lib/weights.py``) and takes the
inputs the benchmark made; the model family gives the tree and the plain
model."""

from __future__ import annotations

import torch

from perfbench.lib import weights
from perfbench.reference import adafactor
from perfbench.reference.precision import DTYPES, exact_f32


def train_readings(family, cfg: dict, traffic: dict, seed: int, ids, tgt,
                   device, precision: str = "f32",
                   rows: int | None = None) -> dict:
    """The reference's readings of ``len(ids)`` training steps from the
    seed's weights: ``{"losses", "grad_norms" (the first step's, by
    leaf), "changes" (by leaf, after the last step)}``.  Parameters and
    moments are stored in the traffic's param dtype and computed in f32.
    ``rows`` keeps only the first rows of each batch (a fault: half the
    batch left out, the mean taken over the rest)."""
    exact_f32()
    model = family.reference(cfg, precision)
    dtype = DTYPES[traffic["param_dtype"]]
    specs = family.leaf_specs(cfg)
    stored = weights.make_params(family, cfg, seed, dtype, device)
    leaves = [weights.get_leaf(stored, path) for path, *_ in specs]
    states = [adafactor.init(p) for p in leaves]
    losses, grad_norms = [], None
    for step in range(len(ids)):
        live = [p.float().requires_grad_(True) for p in leaves]
        tree = weights.tree_of(specs, live)
        b = ids[step] if rows is None else ids[step][:rows]
        t = tgt[step] if rows is None else tgt[step][:rows]
        loss, grads = model.loss_and_grads(tree, live, b.to(device),
                                           t.to(device))
        losses.append(loss)
        if step == 0:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        del live, tree
        for p, g, s in zip(leaves, grads, states):
            adafactor.step(p, g, s, step, traffic["learning_rate"])
        del grads
    changes = []
    for index, p in enumerate(leaves):
        start = weights.draw_leaf(specs, index, seed, dtype, device)
        changes.append(float(torch.linalg.vector_norm(p.float() - start.float())))
        del start
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes}

