"""Weights from the seed, made on the device in the model family's tree.

The family (``families/<name>.py``) gives the tree's leaves
(``leaf_specs``: path, shape, init and scale of each); the paths give
their nesting.  The layers are either a tuple of layer trees or one tree
of leaves stacked on a leading dim.  Each leaf that is drawn gets a
generator of its own, seeded from the run's seed and the leaf's index, so
one leaf can be drawn again alone (the reference and the checks do) and
the same seed gives the same tensors in either layout.
"""

from __future__ import annotations

import torch


LOW_LEAVES = 250  # leaves below it seed in the low byte; 250 is the inputs'
MAX_LEAVES = 1 << 16


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index``.  A leaf below 250 takes the
    seed's low 55 bits over an index byte, ``seed << 8 | index`` (below
    2**63); the byte's values from 250 up are left to the inputs
    (:func:`input_seed`).  A leaf from 250 on takes bit 63 over the seed's
    low 47 bits and a 16-bit index, ``1 << 63 | seed << 16 | index``,
    which no seed of the first kind has; so a family has at most 65536
    leaves."""
    if not 0 <= index < MAX_LEAVES:
        raise ValueError(f"leaf index {index} is outside 0..{MAX_LEAVES - 1}")
    if index < LOW_LEAVES:
        return ((int(seed) & ((1 << 55) - 1)) << 8) | index
    return (1 << 63) | ((int(seed) & ((1 << 47) - 1)) << 16) | index


def input_seed(seed: int) -> int:
    """The generator seed of the run's inputs: ``seed << 8 | 250``, which
    no leaf takes."""
    return ((int(seed) & ((1 << 55) - 1)) << 8) | LOW_LEAVES


def fill_leaf(t: torch.Tensor, init: str, std: float, seed: int,
              index: int) -> torch.Tensor:
    """Fill ``t`` in place with leaf ``index``'s values."""
    if init == "ones":
        return t.fill_(1.0)
    if init == "zeros":
        return t.zero_()
    gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, index))
    return t.normal_(0.0, std, generator=gen)


def draw_leaf(specs: list, index: int, seed: int, dtype,
              device) -> torch.Tensor:
    """Leaf ``index`` of a family's ``leaf_specs`` alone, as a fresh
    tensor."""
    _, shape, init, std = specs[index]
    return fill_leaf(torch.empty(shape, dtype=dtype, device=device), init,
                     std, seed, index)


def set_leaf(tree: dict, path: tuple, value) -> None:
    """Put ``value`` at ``path`` in a tree of nested dicts, making the
    dicts on the way (a layer index is a key until :func:`listed`)."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def listed(tree):
    """``tree`` with every dict whose keys are the indices 0..n-1 turned
    into a tuple in their order (the layers)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: listed(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"layer indices {sorted(out)} are not 0..n-1")
        return tuple(out[i] for i in range(len(out)))
    return out


def tree_of(specs: list, leaves: list) -> dict:
    """The tuple layout's tree of a flat leaf list in ``specs`` order."""
    tree: dict = {}
    for (path, *_), leaf in zip(specs, leaves):
        set_leaf(tree, path, leaf)
    return listed(tree)


def make_params(family, cfg: dict, seed: int, dtype, device,
                stacked: bool = False) -> dict:
    """The family's whole tree, each leaf drawn on ``device`` in
    ``dtype``.  With ``stacked`` the layers are one tree of ``[n_layers,
    ...]`` leaves whose slices hold the tuple layout's values."""
    specs = family.leaf_specs(cfg)
    n = 1 + max((path[1] for path, *_ in specs if path[0] == "layers"),
                default=-1)
    tree: dict = {}
    stacks: dict = {}
    for index, (path, shape, init, std) in enumerate(specs):
        if stacked and path[0] == "layers":
            key = path[2:]
            if key not in stacks:
                stacks[key] = torch.empty((n, *shape), dtype=dtype,
                                          device=device)
                set_leaf(tree, ("layers",) + key, stacks[key])
            fill_leaf(stacks[key][path[1]], init, std, seed, index)
            continue
        t = torch.empty(shape, dtype=dtype, device=device)
        set_leaf(tree, path, fill_leaf(t, init, std, seed, index))
    return tree if stacked else listed(tree)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s tree under either layout (views of a stack)."""
    layers = params["layers"]
    if isinstance(layers, (tuple, list)):
        return layers[i]

    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]

    return pick(layers)


def get_leaf(params: dict, path: tuple) -> torch.Tensor:
    """The leaf at a tuple-layout ``path`` under either layout."""
    if path[0] == "layers":
        tree = layer_params(params, path[1])
        path = path[2:]
    else:
        tree = params
    for key in path:
        tree = tree[key]
    return tree
