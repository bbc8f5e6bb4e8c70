"""Parameter and optimizer-state trees: nested dicts, tuples and lists
(named tuples included) whose leaves are tensors, walked in one fixed
order (a dict's own key order), so ``tree_leaves`` and ``tree_map`` agree
and a flat list of leaves maps back onto its tree.

``jax_tree_leaves`` and ``jax_tree_unflatten`` walk ``jax.tree.flatten``'s
order instead (dict keys sorted, None an empty subtree): the order of the
leaves that travel between the two packages (averaging vectors, handoff
manifests)."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val, *(r[key] for r in rest))
                for key, val in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, val, *(r[i] for r in rest))
                 for i, val in enumerate(tree)]
        return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(structure, leaves) -> Any:
    """A tree shaped like ``structure`` holding ``leaves`` in order."""
    it: Iterator = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def _jax_walk(tree, leaf_fn) -> Any:
    """``tree`` rebuilt with ``leaf_fn(leaf)`` at each leaf, the leaves
    visited in ``jax.tree.flatten``'s order; dicts keep their key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {key: _jax_walk(tree[key], leaf_fn) for key in sorted(tree)}
        return {key: done[key] for key in tree}
    if isinstance(tree, (tuple, list)):
        items = [_jax_walk(val, leaf_fn) for val in tree]
        return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(items)
    return leaf_fn(tree)


def jax_tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    out: list = []
    _jax_walk(tree, out.append)
    return out


def jax_tree_unflatten(structure, leaves) -> Any:
    """A tree shaped like ``structure`` holding ``leaves`` in
    ``jax.tree.flatten``'s order."""
    it: Iterator = iter(leaves)
    return _jax_walk(structure, lambda _: next(it))
