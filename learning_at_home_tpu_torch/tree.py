"""Parameter and optimizer-state trees: nested dicts, tuples and lists
(named tuples included) whose leaves are tensors, walked in one fixed
order (a dict's own key order), so ``tree_leaves`` and ``tree_map`` agree
and a flat list of leaves maps back onto its tree."""

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
