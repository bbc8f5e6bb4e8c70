"""Pytree ⇄ flat float32 vector, group partitions, and wire chunks.

The port of ``learning_at_home_tpu/averaging/partitioning.py``.  The
all-reduce operates on ONE contiguous float32 vector per peer: the
trainer's trunk+gate tree (the port's nested dicts, lists, tuples and
named tuples of tensors) is flattened leaf by leaf in
``jax.tree.flatten``'s order — dict keys sorted, list and tuple items in
order, named tuples by field — so a torch peer and a JAX peer of one
group reduce the same element at the same offset.  Leaves become host
f32 (bf16 widened exactly), and come back on the tree's device in the
tree's dtype: each f32 slice is copied once to the device, and a bf16
leaf is rounded once from the reduced f32, as JAX's ``astype`` does.
Reducing in float32 regardless of storage dtype keeps the accumulation
exact enough for the bitwise-parity contract: every partition is summed
ONCE, on one member, in sorted-peer order, so all members receive
identical bytes.

Partitioning is `np.array_split` semantics — member *i* of the sorted
group owns partition *i* — and each partition is further cut into
``chunk_elems``-sized wire chunks so one partition rides several
rid-tagged mux frames instead of one huge payload (the client's
MAX_FRAME_BYTES cap, and finer-grained timeout accounting).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from learning_at_home_tpu_torch.convert import numpy_dtype, numpy_to_tensor
from learning_at_home_tpu_torch.tree import jax_tree_leaves, jax_tree_unflatten


def _host_f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy().ravel()
    return np.asarray(leaf).astype(np.float32, copy=False).ravel()


def flatten_tree(tree: Any) -> tuple[np.ndarray, Any, list]:
    """Flatten a tree to (float32 vector, treedef, leaf specs)."""
    leaves = jax_tree_leaves(tree)
    specs = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            specs.append((tuple(leaf.shape), leaf.dtype, leaf.device))
        else:
            arr = np.asarray(leaf)
            specs.append((arr.shape, arr.dtype, None))
    if not leaves:
        return np.zeros((0,), np.float32), _skeleton(tree), specs
    vec = np.concatenate([_host_f32(leaf) for leaf in leaves])
    return vec, _skeleton(tree), specs


def _skeleton(tree: Any) -> Any:
    """``tree``'s structure, each leaf a 0 (the treedef)."""
    return jax_tree_unflatten(tree, [0] * len(jax_tree_leaves(tree)))


def unflatten_tree(vec: np.ndarray, treedef: Any, specs: list) -> Any:
    """Inverse of :func:`flatten_tree`; tensor leaves come back on their
    device in their dtype, array leaves as numpy arrays."""
    leaves, off = [], 0
    for shape, dtype, device in specs:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        part = vec[off: off + n].reshape(shape)
        if device is None:
            leaves.append(part.astype(dtype))
        else:  # one rounding from the reduced f32, as JAX's astype
            leaves.append(numpy_to_tensor(
                part.astype(numpy_dtype(dtype)), device))
        off += n
    if off != vec.size:
        raise ValueError(
            f"vector of {vec.size} elements does not match specs ({off})"
        )
    return jax_tree_unflatten(treedef, leaves)


def partition_bounds(n_elements: int, n_parts: int) -> list[tuple[int, int]]:
    """[start, end) bounds of `np.array_split(range(n), n_parts)`."""
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    base, extra = divmod(n_elements, n_parts)
    bounds, start = [], 0
    for i in range(n_parts):
        size = base + (1 if i < extra else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def chunk_ranges(length: int, chunk_elems: int) -> list[tuple[int, int]]:
    """[offset, n) chunks covering a partition of ``length`` elements.
    A zero-length partition still yields one empty chunk so the protocol
    round-trips it (tiny trees with more members than elements)."""
    if chunk_elems <= 0:
        raise ValueError("chunk_elems must be positive")
    if length == 0:
        return [(0, 0)]
    return [
        (off, min(chunk_elems, length - off))
        for off in range(0, length, chunk_elems)
    ]


def weighted_mean(
    parts: Sequence[tuple[str, float, np.ndarray]]
) -> np.ndarray:
    """Weighted mean over ``(peer_id, weight, vector)`` contributions,
    accumulated in sorted-peer order (float32 throughout) — the single
    place reduction arithmetic happens, so every member of a group gets
    bitwise-identical results for a partition and a re-weighted degraded
    round is just this function over the survivors."""
    if not parts:
        raise ValueError("weighted_mean of no contributions")
    ordered = sorted(parts, key=lambda p: p[0])
    total_w = np.float32(0.0)
    acc = None
    for _, weight, vec in ordered:
        w = np.float32(weight)
        contrib = vec * w if weight != 1.0 else vec
        acc = contrib.copy() if acc is None else acc + contrib
        total_w = total_w + w
    return (acc / total_w).astype(np.float32, copy=False)
