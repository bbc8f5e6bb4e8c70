"""Named process meshes for the pod tier on many cards.

The counterpart of ``learning_at_home_tpu/parallel/mesh.py``.  A JAX mesh
lays the devices out on named axes and ``shard_map`` runs one program per
device; here each rank of a ``torch.distributed`` job is one device of the
mesh, with the same layout: ranks reshaped row-major to the axis sizes in
the order given (so the first axes are process-major, as JAX's multi-host
meshes need), rank ``r`` at coordinates ``np.unravel_index(r, sizes)``.

:func:`make_mesh` creates one process group for every set of axes of size
> 1 (over the ranks that share the other coordinates), in one fixed order
on every rank, as ``torch.distributed.new_group`` requires; a collective
over a set of axes uses that group, and over axes of size 1 none at all.

Shardings are :class:`P` specs like JAX's ``PartitionSpec``: one entry per
dim, ``None`` (replicated), an axis name or a tuple of axis names (the dim
split over those axes, the first one major); a spec is a leaf of the
port's trees (``tree.py``), so a tree of specs mirrors a param tree.
:func:`local_shard` takes a rank's slice of a global tensor under a spec, and :func:`batch_sharding`,
:func:`expert_sharding` and :func:`opt_state_shardings`
give the JAX module's specs and its suffix-and-shape rule for optimizer
state.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from learning_at_home_tpu_torch.tree import tree_unflatten

# the axes a token batch is split over, and every axis that holds distinct
# tokens (the sequence axis splits each row's positions)
DATA_AXES = ("data", "expert")
TOKEN_AXES = ("data", "expert", "seq")


class P:
    """A partition spec: one entry per leading dim (missing dims are
    replicated).  ``P()`` is replicated."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


class Mesh:
    """One rank's view of a named mesh: the axis sizes, its coordinates,
    the process groups, the backend and the rank's device."""

    def __init__(self, axes: dict[str, int], rank: int, backend: str | None,
                 device: torch.device, groups: dict):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.rank = rank
        self.world_size = int(math.prod(axes.values())) if axes else 1
        sizes = [self.shape[a] for a in self.axis_names]
        coords = np.unravel_index(rank, sizes) if sizes else ()
        self.coords = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self.backend = backend
        self.device = torch.device(device)
        # gloo takes card tensors only through host copies
        self.stage = backend == "gloo" and self.device.type != "cpu"
        self._groups = groups

    def _known(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (axes the mesh lacks count
        as size 1)."""
        return int(math.prod(self.shape[a] for a in self._known(axes)))

    def index(self, axes) -> int:
        """This rank's linear index along ``axes``, the first one major
        (its position in the group over those axes)."""
        idx = 0
        for a in self._known(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` holding this rank, or None when
        they number one rank."""
        key = frozenset(a for a in self._known(axes) if self.shape[a] > 1)
        if not key:
            return None
        return self._groups[key]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")


def _axis_sets(names, shape):
    """Every non-empty set of the axes of size > 1, in one fixed order."""
    live = [a for a in names if shape[a] > 1]
    for r in range(1, len(live) + 1):
        yield from itertools.combinations(live, r)


def local_rank() -> int:
    """The rank's index among the ranks of its host (``LOCAL_RANK`` as
    ``torchrun`` sets it, else the global rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The rank's device: ``device`` as given, else its card
    (``cuda:LOCAL_RANK``), raising where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run the mesh on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def make_mesh(axes: dict[str, int] | None = None, device=None) -> Mesh:
    """A named mesh over the ranks of the default process group (a job of
    one rank needs none); the axis sizes must multiply to the world size.
    Default: every rank on one ``expert`` axis.  ``device`` is the rank's
    device (default its card, see :func:`rank_device`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if axes is None:
        axes = {"expert": world}
    axes = dict(axes)
    need = int(math.prod(axes.values()))
    if need != world:
        raise ValueError(f"mesh axes {axes} need {need} ranks, have {world}")
    names = tuple(axes)
    sizes = [axes[a] for a in names]
    groups = {}
    grid = np.arange(world).reshape(sizes) if sizes else np.zeros((), int)
    for subset in _axis_sets(names, axes):
        inner = [names.index(a) for a in subset]
        outer = [i for i in range(len(names)) if i not in inner]
        flat = np.transpose(grid, outer + inner).reshape(-1, math.prod(
            sizes[i] for i in inner))
        for ranks in flat:
            members = sorted(int(r) for r in ranks)
            g = dist.new_group(members)
            if rank in members:
                groups[frozenset(subset)] = g
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh(axes, rank, backend, rank_device(device), groups)


def mesh_layout(axes: dict[str, int], rank: int,
                device="cpu") -> Mesh:
    """The layout of a mesh of ``axes`` as rank ``rank`` sees it, without
    process groups: for slicing (``local_shard``), not for collectives."""
    return Mesh(dict(axes), rank, None, torch.device(device), {})


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes a token batch is sharded over (everything but model axes)."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def token_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes whose ranks hold different tokens: the data axes and ``seq``."""
    return tuple(a for a in mesh.axis_names if a in TOKEN_AXES)


def batch_sharding(mesh: Mesh) -> P:
    """Tokens split across the data axes; with a ``seq`` axis the sequence
    dim (axis 1) too."""
    if "seq" in mesh.axis_names:
        return P(data_axes(mesh), "seq")
    return P(data_axes(mesh))


def expert_sharding(mesh: Mesh) -> P:
    """Stacked per-expert params: leading axis split over ``expert``."""
    return P("expert")


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis a spec splits some dim over."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def shard_slices(shape, spec, mesh: Mesh) -> tuple[slice, ...]:
    """This rank's slice of each dim of a global ``shape`` under ``spec``;
    raises when a split dim does not divide."""
    out = []
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n = mesh.size(_entry_axes(entry))
        if size % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {n} ranks of {entry!r}")
        chunk = size // n
        j = mesh.index(_entry_axes(entry))
        out.append(slice(j * chunk, (j + 1) * chunk))
    return tuple(out)


def local_shard(t, spec, mesh: Mesh):
    """This rank's slice of the global tensor (or array) ``t``."""
    return t[shard_slices(t.shape, spec, mesh)]


def global_shape(local_shape, spec, mesh: Mesh) -> tuple[int, ...]:
    """The global shape whose ``spec`` slices have ``local_shape``."""
    return tuple(
        size * mesh.size(_entry_axes(spec[i] if i < len(spec) else None))
        for i, size in enumerate(local_shape))


def _paths(tree, prefix=()):
    """(key path, leaf) pairs in the tree's order; a path holds dict keys,
    sequence indices and named-tuple field names."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _paths(val, prefix + (key,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, val in zip(tree._fields, tree):
            yield from _paths(val, prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, val in enumerate(tree):
            yield from _paths(val, prefix + (i,))
    else:
        yield prefix, tree


def opt_state_shardings(opt_state, param_specs, params) -> Any:
    """Specs for an optimizer state mirroring the param tree: a state leaf
    whose key-path SUFFIX names a param and whose shape equals that
    param's takes the param's spec; everything else (counts, the reduced
    statistics of a factored optimizer) is replicated.  The JAX rule
    (``mesh.py:62-112``), with its limit: a same-shaped leaf of other
    per-axis meaning would wrongly inherit the spec."""
    specs = dict(_paths(param_specs))
    shapes = {path: tuple(p.shape) for path, p in _paths(params)}
    if specs.keys() != shapes.keys():
        differ = sorted(map(str, specs.keys() ^ shapes.keys()))[:4]
        raise ValueError(f"param_specs and params trees disagree: {differ}")

    def assign(path, leaf):
        for i in range(len(path)):
            suffix = path[i:]
            if suffix in specs:
                if tuple(getattr(leaf, "shape", ())) == shapes[suffix]:
                    return specs[suffix]
                return P()
        return P()

    return tree_unflatten(opt_state,
                          [assign(p, l) for p, l in _paths(opt_state)])


class LeafShard:
    """How one parameter leaf is split over a mesh, for statistics that
    span the whole leaf (an optimizer's means): its global shape, this
    rank's slice and the axes that split it.  :meth:`of` gives None for a
    leaf that every rank holds whole."""

    def __init__(self, mesh: Mesh, spec, local_shape):
        self.mesh = mesh
        self.axes = spec_axes(spec)
        self.shape = global_shape(local_shape, spec, mesh)
        self.slices = shard_slices(self.shape, spec, mesh)

    @classmethod
    def of(cls, mesh: Optional[Mesh], spec, local_shape) -> "LeafShard | None":
        if mesh is None or spec is None or mesh.size(spec_axes(spec)) == 1:
            return None
        return cls(mesh, spec, local_shape)

    def numel(self) -> int:
        return int(math.prod(self.shape))

    def total(self, partial: torch.Tensor) -> torch.Tensor:
        """A sum over the whole leaf from this rank's partial sum."""
        from learning_at_home_tpu_torch.parallel.comm import all_reduce_

        return all_reduce_(partial.clone(), self.mesh, self.axes)

    def stat(self, partial: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf's sums over ``dim`` (the global shape without
        ``dim``), every rank alike, from this rank's sums over its slice:
        each rank writes its part of the result into zeros and the parts
        are summed over the leaf's axes."""
        from learning_at_home_tpu_torch.parallel.comm import all_reduce_

        keep = [i for i in range(len(self.shape)) if i != dim]
        full = torch.zeros([self.shape[i] for i in keep], dtype=partial.dtype,
                           device=partial.device)
        full[tuple(self.slices[i] for i in keep)] = partial
        return all_reduce_(full, self.mesh, self.axes)

    def local(self, stat: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of a statistic of the global shape without
        ``dim``."""
        keep = [i for i in range(len(self.shape)) if i != dim]
        return stat[tuple(self.slices[i] for i in keep)]
