"""Nested-structure helpers: flatten / repack arbitrary nests of tensors.

The port of ``learning_at_home_tpu/utils/nested.py`` without
``jax.tree_util``.  Experts accept and return nests of tensors over a
wire that carries flat tensor lists, so both ends must flatten in ONE
order, and a JAX peer flattens with ``jax.tree_util``.  The walk here is
that order:

- a ``dict``'s values by sorted key, an ``OrderedDict``'s by insertion;
- tuples, lists and named tuples (the port's ``tree.py`` nodes) item by
  item;
- ``None`` is an empty node (no leaves); anything else is a leaf.

``state_dict`` leaf order, the ``input_schema``/``output_schema`` of the
``info`` RPC and checkpoints all depend on it.  The wire-portable schema
(:func:`schema_from_tree` / :func:`tree_from_schema`) is the JAX
package's, byte for byte after msgpack.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Iterable, Sequence

from learning_at_home_tpu_torch.tree import _is_namedtuple


def _children(node) -> list | None:
    """The children of a container node in jax's flatten order, or None
    for a leaf."""
    if isinstance(node, OrderedDict):
        return [node[k] for k in node]
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def _rebuild(node, children: list):
    """A node like ``node`` holding ``children`` (in :func:`_children`'s
    order)."""
    if isinstance(node, OrderedDict):
        return OrderedDict(zip(node, children))
    if isinstance(node, dict):
        return type(node)(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _map(fn: Callable, tree, *rest):
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    for o in others:
        if o is None or len(o) != len(kids):
            raise ValueError("nests differ in structure")
    return _rebuild(tree, [_map(fn, k, *(o[i] for o in others))
                           for i, k in enumerate(kids)])


def nested_flatten(t: Any) -> list[Any]:
    """Flatten an arbitrary nest of containers into a flat list of leaves,
    in ``jax.tree_util.tree_leaves``' order."""
    out: list = []
    _map(out.append, t)
    return out


class _Leaf:
    """The leaf marker of a structure."""

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def nested_structure(t: Any):
    """The nest's structure: ``t`` with every leaf replaced by a marker
    (pair with :func:`nested_pack`)."""
    return _map(lambda _: _LEAF, t)


def nested_pack(flat: Iterable[Any], structure: Any) -> Any:
    """Inverse of :func:`nested_flatten`: ``structure`` (from
    :func:`nested_structure`, or an example nest) filled with ``flat``."""
    leaves = list(flat)
    it = iter(leaves)
    n = len(nested_flatten(structure))
    if n != len(leaves):
        raise ValueError(f"structure has {n} leaves, got {len(leaves)}")
    return _map(lambda _: next(it), structure)


def nested_map(fn, *trees: Any) -> Any:
    """Map ``fn`` over corresponding leaves of one or more nests."""
    return _map(fn, *trees)


def nested_compare(t1: Any, t2: Any) -> bool:
    """True iff two nests share the same structure (leaf values ignored)."""
    return schema_from_tree(t1) == schema_from_tree(t2) and (
        _types(t1) == _types(t2))


def _types(t) -> list:
    """The container types of a nest in walk order (named tuples differ
    from tuples, as in jax's treedefs)."""
    out: list = []

    def walk(node):
        kids = _children(node)
        if kids is not None:
            out.append(type(node))
            for k in kids:
                walk(k)

    walk(t)
    return out


# ---- wire-portable structure encoding -------------------------------------
# a small msgpack-able description of dict/list/tuple nesting with leaf
# positions: the JAX package's encoding, unchanged


def schema_from_tree(tree: Any) -> Any:
    """Encode a nest's structure as plain msgpack-able data."""

    def encode(node):
        if node is None:
            return {"t": "n"}  # jax drops None from leaves
        if isinstance(node, OrderedDict):
            keys = list(node)  # jax flattens OrderedDict in insertion order
            return {"t": "od", "k": keys, "c": [encode(node[k]) for k in keys]}
        if isinstance(node, dict):
            keys = sorted(node)  # jax flattens plain dicts in sorted-key order
            return {"t": "d", "k": keys, "c": [encode(node[k]) for k in keys]}
        if isinstance(node, tuple):
            return {"t": "t", "c": [encode(x) for x in node]}
        if isinstance(node, list):
            return {"t": "l", "c": [encode(x) for x in node]}
        return {"t": "x"}  # leaf

    return encode(tree)


def tree_from_schema(schema: Any, flat: Sequence[Any]) -> Any:
    """Rebuild a nest from its schema and flat leaves (inverse pairing with
    :func:`nested_flatten`, which uses jax's sorted-dict-key order)."""
    it = iter(flat)

    def take_leaf():
        try:
            return next(it)
        except StopIteration:
            raise ValueError("too few leaves for schema") from None

    def decode(node):
        kind = node["t"]
        if kind == "x":
            return take_leaf()
        if kind == "n":
            return None
        if kind in ("d", "od"):
            # children were encoded in flatten order for their dict kind
            pairs = [(k, decode(c)) for k, c in zip(node["k"], node["c"])]
            return OrderedDict(pairs) if kind == "od" else dict(pairs)
        children = [decode(c) for c in node["c"]]
        return tuple(children) if kind == "t" else children

    tree = decode(schema)
    leftovers = sum(1 for _ in it)
    if leftovers:
        raise ValueError(f"{leftovers} extra leaves for schema")
    return tree
