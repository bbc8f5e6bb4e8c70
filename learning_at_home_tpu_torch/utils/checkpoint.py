"""Checkpoint / resume of per-expert server state, without orbax.

The port of ``learning_at_home_tpu/utils/checkpoint.py`` with the JAX
package's layout and crash-safety semantics:

    <root>/step_000000123/<name>/{tree.json, arrays.npz}
    <root>/step_000000123/.complete     (written after every item)

A step without its ``.complete`` marker is invisible to :func:`list_steps`
and :func:`latest_step`; :func:`next_step` never reuses a step directory,
complete or not; :func:`prune_old_steps` keeps the newest complete steps
and the newest directory (possibly a save in progress); and
:class:`CheckpointManager` runs periodic saves and counts restarts.

The on-disk form of one tree is the port's own: the leaves as numpy
arrays in ``arrays.npz`` under their tree paths (``params/Dense_0/kernel``),
read back with ``allow_pickle=False``, and the structure in ``tree.json``
(the wire schema of ``utils/nested.py``, plus each leaf's dtype, so
bfloat16 travels as its bits).  It does not read orbax checkpoints:
``convert.py`` carries state between the packages.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np

from learning_at_home_tpu_torch.utils.nested import (
    nested_flatten,
    nested_pack,
    schema_from_tree,
    tree_from_schema,
)

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


_COMPLETE_MARKER = ".complete"


def mark_step_complete(root: str, step: int) -> None:
    """Write the completion marker — call ONLY after every item of the step
    is saved.  Without it the step is invisible to list_steps/latest_step,
    so a crash mid-save can never be mistaken for a usable checkpoint."""
    with open(os.path.join(_step_dir(root, step), _COMPLETE_MARKER), "w") as f:
        f.write("ok")


def list_steps(root: str, only_complete: bool = True) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and (
            not only_complete
            or os.path.exists(os.path.join(root, name, _COMPLETE_MARKER))
        ):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def next_step(root: str) -> int:
    """The next unused step number — strictly above every existing step
    directory, complete or not (a crashed half-save must never be
    overwritten in place: its directory may hold a partially-written
    item a same-numbered retry would merge with)."""
    steps = list_steps(root, only_complete=False)
    return (steps[-1] + 1) if steps else 1


def _leaf_paths(tree: Any) -> list[str]:
    """Each leaf's path in the nest's flatten order: dict keys, named
    tuple fields and sequence indices joined by ``/``."""
    out: list[str] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            keys = list(node) if isinstance(node, OrderedDict) else sorted(node)
            for k in keys:
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (tuple, list)):
            names = getattr(node, "_fields", range(len(node)))
            for name, v in zip(names, node):
                walk(v, f"{path}/{name}" if path else str(name))
        else:
            out.append(path or ".")

    walk(tree, "")
    return out


def _leaf_to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor
        from learning_at_home_tpu_torch.convert import tensor_to_numpy

        leaf = tensor_to_numpy(leaf)
    return np.asarray(leaf)


def save_pytree(root: str, step: int, name: str, tree: Any) -> str:
    """Save one tree under <root>/step_XXXXXXXXX/<name>."""
    path = os.path.join(_step_dir(root, step), name)
    os.makedirs(path, exist_ok=True)
    leaves = [_leaf_to_numpy(x) for x in nested_flatten(tree)]
    paths = _leaf_paths(tree)
    dtypes = [a.dtype.name for a in leaves]
    arrays = {
        p: (a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
        for p, a in zip(paths, leaves)
    }
    if len(arrays) != len(leaves):
        raise ValueError(f"checkpoint item {name!r}: leaf paths collide")
    with open(os.path.join(path, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump({"schema": schema_from_tree(tree), "paths": paths,
                   "dtypes": dtypes}, f)
    return path


def restore_pytree(root: str, step: int, name: str, like: Any = None) -> Any:
    """Restore one tree.  ``like`` (a tree of the same structure, e.g. a
    backend's ``state_template``) gives the containers back their own
    types (named tuples included) and Python-int leaves back as ints;
    without it dicts, lists and tuples come back plain."""
    path = os.path.join(_step_dir(root, step), name)
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as z:
        leaves = []
        for p, dt in zip(meta["paths"], meta["dtypes"]):
            arr = z[p]
            if dt == "bfloat16":
                import ml_dtypes

                arr = arr.view(ml_dtypes.bfloat16)
            leaves.append(arr)
    if like is None:
        return tree_from_schema(meta["schema"], leaves)
    like_leaves = nested_flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint item {name!r} has {len(leaves)} leaves, the "
            f"template {len(like_leaves)}")
    restored = [int(a) if type(t) is int else a
                for a, t in zip(leaves, like_leaves)]
    return nested_pack(restored, like)


def prune_old_steps(root: str, keep_last: int) -> None:
    """Delete old step directories, keeping the newest ``keep_last``
    COMPLETE steps.  Incomplete (crashed mid-save) steps are always
    swept — except the newest directory, which may be a save currently
    in progress by another thread/process.  By construction the only
    complete step can never be deleted: it is always among the newest
    ``keep_last >= 1`` complete steps."""
    steps = list_steps(root, only_complete=False)
    complete = set(list_steps(root))
    keep = set(sorted(complete)[-keep_last:]) if keep_last > 0 else complete
    if steps:
        # the newest directory might be a concurrent save that has not
        # written its completion marker YET — never sweep it as garbage
        keep.add(steps[-1])
    for step in steps:
        if step not in keep:
            shutil.rmtree(_step_dir(root, step), ignore_errors=True)


_RESTARTS_FILE = ".restarts"


class CheckpointManager:
    """Server-side checkpoint lifecycle: periodic crash-safe snapshots,
    pruning, and a persisted restart counter.

    The manager owns the step-number bookkeeping (monotonic across
    process restarts via :func:`next_step`) and a daemon thread that
    calls the supplied ``save_fn(step)`` every ``every_s`` seconds —
    ``save_fn`` writes the step's items and its completion marker (e.g.
    ``Server.save_checkpoint``); the manager prunes afterwards.  A crash
    at ANY point leaves the newest *complete* step restorable.
    ``record_restart`` persists how many times a server booted from this
    root: the count survives the restarts it counts.
    """

    def __init__(self, root: str, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        self.saves = 0
        self.save_failures = 0
        self._stop = threading.Event()
        self._thread = None

    # ---- step bookkeeping ----

    def next_step(self) -> int:
        return next_step(self.root)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.root)

    def save_now(self, save_fn) -> Optional[int]:
        """One snapshot: pick the next step, run ``save_fn(step)``,
        prune.  Returns the step saved, or None on failure (periodic
        checkpointing must never kill its owner)."""
        step = self.next_step()
        try:
            save_fn(step)
        except Exception:
            self.save_failures += 1
            logger.exception(
                "checkpoint save @ step %d failed (root %s)", step, self.root
            )
            return None
        self.saves += 1
        prune_old_steps(self.root, self.keep_last)
        return step

    # ---- periodic thread ----

    def start_periodic(self, save_fn, every_s: float) -> "CheckpointManager":
        if self._thread is not None or every_s <= 0:
            return self

        def loop():
            while not self._stop.wait(every_s):
                self.save_now(save_fn)

        self._thread = threading.Thread(
            target=loop, name="lah-checkpointer", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # ---- restart counter ----

    def restart_count(self) -> int:
        try:
            with open(os.path.join(self.root, _RESTARTS_FILE)) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def record_restart(self) -> int:
        """Increment + persist the restart counter; returns the new
        count.  Called once per boot-from-checkpoint."""
        count = self.restart_count() + 1
        os.makedirs(self.root, exist_ok=True)
        tmp = os.path.join(self.root, _RESTARTS_FILE + ".tmp")
        with open(tmp, "w") as f:
            f.write(str(count))
        os.replace(tmp, os.path.join(self.root, _RESTARTS_FILE))
        return count
