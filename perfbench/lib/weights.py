"""Weights from the seed, made on the device in the port's param tree.

The tree has the port's keys and layouts (``embed [V,d]``, ``pos [S,d]``,
``ln_f``, and per layer ``ln1``, ``wq``..``wo`` ``[d,d]``, ``ln2`` and
``moe``: ``gate [d,E]``, ``w1 [E,d,f]``, ``b1 [E,f]``, ``w2 [E,f,d]``,
``b2 [E,d]``), either a tuple of layers or the layers stacked on a
leading dim.  Each leaf that is drawn gets a generator of its own, seeded
from the run's seed and the leaf's index, so one leaf can be drawn again
alone (the reference and the checks do) and the same seed gives the same
tensors in either layout.  Scales: lecun-normal variance (1 / the product
of every dim but the last, as the port's initialiser counts fan-in), the
embeddings and positions N(0, 1/d), the gate N(0, 1e-2 ** 2); norms 1 and
0, biases 0.
"""

from __future__ import annotations

import math

import torch

def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple, str, float]]:
    """``(path, shape, init, std)`` of every leaf of one layer-less tree:
    paths into the tuple layout (``("layers", i, "moe", "w1")``).  ``init``
    is ``normal``, ``ones`` or ``zeros``."""
    d, v, s = cfg["d_model"], cfg["vocab_size"], cfg["seq_len"]
    e, f = cfg["num_experts"], cfg["expert_ffn_dim"]

    def lecun(shape):
        return 1.0 / math.sqrt(math.prod(shape[:-1]))

    out = [(("embed",), (v, d), "normal", d ** -0.5),
           (("pos",), (s, d), "normal", d ** -0.5),
           (("ln_f", "scale"), (d,), "ones", 0.0),
           (("ln_f", "bias"), (d,), "zeros", 0.0)]
    for i in range(cfg["n_layers"]):
        lay = ("layers", i)
        for ln in ("ln1", "ln2"):
            out += [(lay + (ln, "scale"), (d,), "ones", 0.0),
                    (lay + (ln, "bias"), (d,), "zeros", 0.0)]
        for w in ("wq", "wk", "wv", "wo"):
            out.append((lay + (w,), (d, d), "normal", lecun((d, d))))
        moe = lay + ("moe",)
        out += [(moe + ("gate",), (d, e), "normal", 1e-2),
                (moe + ("w1",), (e, d, f), "normal", lecun((e, d, f))),
                (moe + ("b1",), (e, f), "zeros", 0.0),
                (moe + ("w2",), (e, f, d), "normal", lecun((e, f, d))),
                (moe + ("b2",), (e, d), "zeros", 0.0)]
    return out


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` (fits in 64 bits for any seed
    below 2**55)."""
    return ((int(seed) & ((1 << 55) - 1)) << 8) | index


def fill_leaf(t: torch.Tensor, init: str, std: float, seed: int,
              index: int) -> torch.Tensor:
    """Fill ``t`` in place with leaf ``index``'s values."""
    if init == "ones":
        return t.fill_(1.0)
    if init == "zeros":
        return t.zero_()
    gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, index))
    return t.normal_(0.0, std, generator=gen)


def draw_leaf(cfg: dict, index: int, seed: int, dtype, device) -> torch.Tensor:
    """Leaf ``index`` of :func:`leaf_specs` alone, as a fresh tensor."""
    _, shape, init, std = leaf_specs(cfg)[index]
    return fill_leaf(torch.empty(shape, dtype=dtype, device=device), init,
                     std, seed, index)


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def make_params(cfg: dict, seed: int, dtype, device,
                stacked: bool = False) -> dict:
    """The whole tree, each leaf drawn on ``device`` in ``dtype``.  With
    ``stacked`` the layers are one tree of ``[n_layers, ...]`` leaves whose
    slices hold the tuple layout's values."""
    n = cfg["n_layers"]

    def layer():
        return {"ln1": {}, "ln2": {}, "moe": {}}

    layers = [layer() for _ in range(n)]
    tree = {"ln_f": {}, "layers": layers}
    stacks: dict = {}
    for index, (path, shape, init, std) in enumerate(leaf_specs(cfg)):
        if stacked and path[0] == "layers":
            key = path[2:]
            if key not in stacks:
                stacks[key] = torch.empty((n, *shape), dtype=dtype,
                                          device=device)
            fill_leaf(stacks[key][path[1]], init, std, seed, index)
            continue
        t = torch.empty(shape, dtype=dtype, device=device)
        _set(tree, path, fill_leaf(t, init, std, seed, index))
    if stacked:
        top = layer()
        for key, t in stacks.items():
            _set(top, key, t)
        tree["layers"] = top
    else:
        tree["layers"] = tuple(layers)
    return tree


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
