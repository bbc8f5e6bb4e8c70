"""Checkpoint / resume of per-expert server state, without orbax.

The port of ``learning_at_home_tpu/utils/checkpoint.py`` with the JAX
package's layout and crash-safety semantics:

    <root>/step_000000123/<name>/{tree.json, arrays.npz}
    <root>/step_000000123/.complete     (written after every item)

A step without its ``.complete`` marker is invisible to :func:`list_steps`
and :func:`latest_step`; :func:`next_step` never reuses a step directory,
complete or not; :func:`prune_old_steps` keeps the newest complete steps
and the newest directory (possibly a save in progress);
:class:`CheckpointManager` runs periodic saves and counts restarts; and
:class:`TrainCheckpointer` saves and restores a trainer's
``(step, params, opt_state)``.

The on-disk form of one tree is the port's own: the leaves as numpy
arrays in ``arrays.npz`` under their tree paths (``params/Dense_0/kernel``),
read back with ``allow_pickle=False``, and the structure in ``tree.json``
(the wire schema of ``utils/nested.py``, plus each leaf's dtype, so
bfloat16 travels as its bits).  It does not read orbax checkpoints:
``convert.py`` carries state between the packages.

On a mesh of ranks (``parallel/mesh.py``; the counterpart of orbax's
sharded save and restore) a tree's leaves are a rank's slices, each split
by its spec (``parallel.mesh.P``).  Each rank writes the slices it owns
to ``shard_<rank>/<i>.npy`` (``i`` the leaf's index in the tree; ``.npy``
files, which a restore maps instead of parsing a zip): a slice held by
several ranks (a leaf replicated over an axis) is written once, by the
lowest rank that holds it.  Rank 0 writes ``tree.json`` with each leaf's
global shape, dtype and spec and the mesh's axes.
:class:`TrainCheckpointer` writes ``.complete`` from rank 0 only after a
barrier, so a step that a dead rank left half-written stays invisible.
A restore reads, for each leaf, the slice its ``like`` tree's shape and
spec ask for on the restoring mesh, which may differ from the saving one,
or whole leaves without a mesh; a step in either layout restores onto
any mesh or none.
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
    nested_map,
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


def _on_mesh(mesh) -> bool:
    return mesh is not None and mesh.world_size > 1


def _spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in (spec or ())]


def _spec_from_json(entries):
    from learning_at_home_tpu_torch.parallel.mesh import P

    return P(*(tuple(e) if isinstance(e, list) else e for e in entries))


def _leaf_specs(tree, specs) -> list:
    """``specs`` (a tree like ``tree`` of ``P``) flattened in the tree's
    leaf order."""
    leaves = nested_flatten(specs)
    if len(leaves) != len(nested_flatten(tree)):
        raise ValueError("the specs tree does not match the tree's leaves")
    return leaves


def _writes(spec, mesh) -> bool:
    """Whether this rank writes its slice of a leaf split by ``spec``: it
    is the lowest rank holding that slice (coordinate 0 on every axis the
    leaf is replicated over)."""
    from learning_at_home_tpu_torch.parallel.mesh import spec_axes

    split = spec_axes(spec)
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in split)


def _shard_file(rank: int, leaf: int) -> str:
    return os.path.join(f"shard_{rank:05d}", f"{leaf:05d}.npy")


def _storable(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _loaded(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        import ml_dtypes

        return a.view(ml_dtypes.bfloat16)
    return a


def save_pytree(root: str, step: int, name: str, tree: Any, mesh=None,
                specs: Any = None) -> str:
    """Save one tree under <root>/step_XXXXXXXXX/<name>.  On a mesh of more
    than one rank every rank calls it with its slices and ``specs`` (a
    tree like ``tree`` of each leaf's ``P``), and writes the slices it
    owns (module docstring)."""
    path = os.path.join(_step_dir(root, step), name)
    os.makedirs(path, exist_ok=True)
    leaves = [_leaf_to_numpy(x) for x in nested_flatten(tree)]
    paths = _leaf_paths(tree)
    dtypes = [a.dtype.name for a in leaves]
    if len(set(paths)) != len(leaves):
        raise ValueError(f"checkpoint item {name!r}: leaf paths collide")
    meta = {"schema": schema_from_tree(tree), "paths": paths,
            "dtypes": dtypes}
    if not _on_mesh(mesh):
        with open(os.path.join(path, "arrays.npz"), "wb") as f:
            np.savez(f, **{p: _storable(a) for p, a in zip(paths, leaves)})
    else:
        from learning_at_home_tpu_torch.parallel.mesh import global_shape

        leaf_specs = _leaf_specs(tree, specs)
        os.makedirs(os.path.join(path, f"shard_{mesh.rank:05d}"),
                    exist_ok=True)
        for i, (a, spec) in enumerate(zip(leaves, leaf_specs)):
            if _writes(spec, mesh):
                np.save(os.path.join(path, _shard_file(mesh.rank, i)),
                        _storable(a), allow_pickle=False)
        if mesh.rank != 0:
            return path
        meta.update(
            mesh=mesh.shape,
            shapes=[list(global_shape(a.shape, spec, mesh))
                    for a, spec in zip(leaves, leaf_specs)],
            specs=[_spec_to_json(spec) for spec in leaf_specs])
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump(meta, f)
    return path


def _box(slices, shape) -> list[tuple[int, int]]:
    return [(sl.start or 0, shape[i] if sl.stop is None else sl.stop)
            for i, sl in enumerate(slices)]


class _ShardedItem:
    """One item of a step saved on a mesh: each leaf's writers and the
    part of the global leaf each holds."""

    def __init__(self, path: str, meta: dict):
        from learning_at_home_tpu_torch.parallel.mesh import (
            mesh_layout,
            shard_slices,
        )

        self.path = path
        self.meta = meta
        axes = meta["mesh"]
        world = int(np.prod(list(axes.values())))
        layouts = [mesh_layout(axes, r) for r in range(world)]
        self.writers = []  # per leaf: [(rank, box), ...]
        for shape, entries in zip(meta["shapes"], meta["specs"]):
            spec = _spec_from_json(entries)
            self.writers.append([
                (lay.rank, _box(shard_slices(shape, spec, lay), shape))
                for lay in layouts if _writes(spec, lay)])

    def read(self, i: int, want: list[tuple[int, int]]) -> np.ndarray:
        """Leaf ``i``'s part ``want`` (a (start, stop) per dim), assembled
        from the writers' slices that meet it."""
        key, dtype = self.meta["paths"][i], self.meta["dtypes"][i]
        out, covered = None, 0
        for rank, box in self.writers[i]:
            meet = [(max(a0, b0), min(a1, b1))
                    for (a0, a1), (b0, b1) in zip(box, want)]
            if any(lo >= hi for lo, hi in meet):
                continue
            part = np.load(os.path.join(self.path, _shard_file(rank, i)),
                           mmap_mode="r", allow_pickle=False)
            if out is None:
                out = np.empty([hi - lo for lo, hi in want], part.dtype)
            src = tuple(slice(lo - b0, hi - b0)
                        for (lo, hi), (b0, _) in zip(meet, box))
            dst = tuple(slice(lo - w0, hi - w0)
                        for (lo, hi), (w0, _) in zip(meet, want))
            out[dst] = part[src]
            covered += int(np.prod([hi - lo for lo, hi in meet]))
            del part
        size = int(np.prod([hi - lo for lo, hi in want]))
        if covered != size:
            raise ValueError(f"checkpoint leaf {key!r}: the shards cover "
                             f"{covered} of the {size} elements asked for")
        return _loaded(out, dtype)


def restore_pytree(root: str, step: int, name: str, like: Any = None,
                   mesh=None, specs: Any = None) -> Any:
    """Restore one tree as numpy arrays.  ``like`` (a tree of the same
    structure, e.g. a backend's ``state_template``) gives the containers
    back their own types (named tuples included) and Python-int leaves
    back as ints; without it dicts, lists and tuples come back plain.
    With ``mesh`` (of more than one rank) and ``specs`` (a tree like
    ``like`` of each leaf's ``P``) each leaf is this rank's slice on that
    mesh; without, the whole leaf.  The step may have been saved on any
    mesh or none."""
    from learning_at_home_tpu_torch.parallel.mesh import shard_slices

    path = os.path.join(_step_dir(root, step), name)
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    leaf_specs = ([None] * len(meta["paths"]) if not _on_mesh(mesh)
                  else _leaf_specs(like, specs))
    if "mesh" in meta:
        item = _ShardedItem(path, meta)
        shapes = meta["shapes"]
    else:
        item = None
        with np.load(os.path.join(path, "arrays.npz"),
                     allow_pickle=False) as z:
            whole = [_loaded(z[p], dt)
                     for p, dt in zip(meta["paths"], meta["dtypes"])]
        shapes = [list(a.shape) for a in whole]
    if len(leaf_specs) != len(shapes):
        raise ValueError(
            f"checkpoint item {name!r} has {len(shapes)} leaves, the "
            f"template {len(leaf_specs)}")
    leaves = []
    for i, (shape, spec) in enumerate(zip(shapes, leaf_specs)):
        want = (_box(shard_slices(shape, spec, mesh), shape)
                if spec is not None else [(0, n) for n in shape])
        if item is not None:
            leaves.append(item.read(i, want))
        else:
            leaves.append(whole[i][tuple(slice(a, b) for a, b in want)])
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


class TrainCheckpointer:
    """A trainer's ``(step, params, opt_state)``: :meth:`save` writes both
    trees, then the step's completion marker, then prunes to the newest
    ``keep_last`` complete steps; :meth:`restore_latest` reads the newest
    complete step back as tensors on the devices of the templates'
    leaves, in their dtypes (bfloat16 bit for bit).

    On a mesh of ranks (``mesh``, and ``specs``: the params' specs, e.g.
    ``DMoETransformerLM.param_specs``; the optimizer state's follow by
    ``parallel.mesh.opt_state_shardings``) every rank calls :meth:`save`
    and :meth:`restore_latest` with its slices: each writes the slices it
    owns, and rank 0 writes the marker after a barrier and prunes."""

    def __init__(self, root: str, keep_last: int = 3, mesh=None,
                 specs: Any = None):
        if _on_mesh(mesh) and specs is None:
            raise ValueError("a checkpointer on a mesh needs the params' "
                             "specs")
        self.root = root
        self.keep_last = keep_last
        self.mesh = mesh if _on_mesh(mesh) else None
        self.specs = specs

    def _specs(self, params, opt_state):
        if self.mesh is None:
            return None, None
        from learning_at_home_tpu_torch.parallel.mesh import (
            opt_state_shardings,
        )

        return self.specs, opt_state_shardings(opt_state, self.specs, params)

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        import torch.distributed as dist

        p_specs, s_specs = self._specs(params, opt_state)
        save_pytree(self.root, step, "params", params, self.mesh, p_specs)
        save_pytree(self.root, step, "opt_state", opt_state, self.mesh,
                    s_specs)
        if self.mesh is not None:
            dist.barrier()  # every rank's slices are on disk
        if self.mesh is None or self.mesh.rank == 0:
            mark_step_complete(self.root, step)
            prune_old_steps(self.root, self.keep_last)
        if self.mesh is not None:
            dist.barrier()  # no rank runs ahead of the marker

    def restore_latest(
        self, params_like: Any, opt_state_like: Any
    ) -> Optional[tuple[int, Any, Any]]:
        step = latest_step(self.root)
        if step is None:
            return None
        p_specs, s_specs = self._specs(params_like, opt_state_like)
        return (step,
                restore_pytree_like(self.root, step, "params", params_like,
                                    self.mesh, p_specs),
                restore_pytree_like(self.root, step, "opt_state",
                                    opt_state_like, self.mesh, s_specs))


def restore_pytree_like(root: str, step: int, name: str, like: Any,
                        mesh=None, specs: Any = None) -> Any:
    """One tree of a step as tensors shaped, typed and placed as the
    leaves of ``like`` (on a mesh, this rank's slices: see
    :func:`restore_pytree`)."""
    from learning_at_home_tpu_torch.convert import numpy_to_tensor

    def leaf(arr, t):
        if not hasattr(t, "detach"):
            return arr
        out = numpy_to_tensor(arr, t.device)
        if out.dtype != t.dtype or out.shape != t.shape:
            raise ValueError(
                f"checkpoint item {name!r}: a {out.dtype} {tuple(out.shape)} "
                f"leaf where the template has {t.dtype} {tuple(t.shape)}")
        return out

    return _in_order_of(nested_map(leaf, restore_pytree(
        root, step, name, like, mesh, specs), like), like)


def _in_order_of(tree, like):
    """``tree`` with its dicts' keys in the order of ``like``'s (a nest
    rebuilds dicts in sorted key order), so that both trees list their
    leaves alike."""
    if isinstance(like, dict):
        return type(tree)((k, _in_order_of(tree[k], like[k])) for k in like)
    if isinstance(like, (tuple, list)) and len(like):
        items = [_in_order_of(t, l) for t, l in zip(tree, like)]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return tree
