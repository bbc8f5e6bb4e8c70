"""Driving the plain reference: the checked training steps.  It draws the weights from the seed again
(``perfbench/lib/weights.py``) and takes the inputs the benchmark made."""

from __future__ import annotations

import torch

from perfbench.lib import weights
from perfbench.reference import adafactor
from perfbench.reference.dmoe import Model, exact_f32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def train_readings(cfg: dict, traffic: dict, seed: int, ids, tgt, device,
                   precision: str = "f32", rows: int | None = None) -> dict:
    """The reference's readings of ``len(ids)`` training steps from the
    seed's weights: ``{"losses", "grad_norms" (the first step's, by
    leaf), "changes" (by leaf, after the last step)}``.  Parameters and
    moments are stored in the traffic's param dtype and computed in f32.
    ``rows`` keeps only the first rows of each batch (a fault: half the
    batch left out, the mean taken over the rest)."""
    exact_f32()
    model = Model(cfg, precision)
    dtype = DTYPES[traffic["param_dtype"]]
    specs = weights.leaf_specs(cfg)
    stored = weights.make_params(cfg, seed, dtype, device)
    leaves = [weights.get_leaf(stored, path) for path, *_ in specs]
    states = [adafactor.init(p) for p in leaves]
    losses, grad_norms = [], None
    for step in range(len(ids)):
        live = [p.float().requires_grad_(True) for p in leaves]
        tree = _tree(cfg, live)
        b = ids[step] if rows is None else ids[step][:rows]
        t = tgt[step] if rows is None else tgt[step][:rows]
        loss, grads = model.loss_and_grads(tree, tree["layers"], live,
                                           b.to(device), t.to(device))
        losses.append(loss)
        if step == 0:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        del live, tree
        for p, g, s in zip(leaves, grads, states):
            adafactor.step(p, g, s, step, traffic["learning_rate"])
        del grads
    changes = []
    for index, p in enumerate(leaves):
        start = weights.draw_leaf(cfg, index, seed, dtype, device)
        changes.append(float(torch.linalg.vector_norm(p.float() - start.float())))
        del start
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes}


def _tree(cfg: dict, leaves: list) -> dict:
    """The nested tree of a flat leaf list in :func:`leaf_specs` order."""
    tree: dict = {"ln_f": {}, "layers": [
        {"ln1": {}, "ln2": {}, "moe": {}} for _ in range(cfg["n_layers"])]}
    for (path, *_), leaf in zip(weights.leaf_specs(cfg), leaves):
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return tree
