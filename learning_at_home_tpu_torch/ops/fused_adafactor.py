"""Single-traversal Adafactor: the whole per-leaf update in one pass.

The PyTorch counterpart of ``learning_at_home_tpu/ops/fused_adafactor.py``:
the update rule of ``optax.adafactor`` (factored second moments,
block-RMS clipping, parameter-scale multiply), computed per leaf in f32
whatever the storage dtype, with the JAX module's state layout
(``count``, ``v_row``, ``v_col``, ``v`` with ``[1]`` sentinels, stats in
the param dtype), so states convert leaf for leaf (``convert.py``).

``init``/``update`` keep the optax contract (``update`` returns the
additive delta); ``apply_fused(params, grads, state)`` folds the
parameter add into the same pass and updates the parameters in place
under ``torch.no_grad()`` (the counterpart of JAX's buffer donation: no
second parameter tree is allocated).  Plain tensor code: the JAX module is
not a Pallas kernel, so there is no kernel here.

On a mesh (``mesh`` and ``specs``, a tree like the params of each leaf's
``parallel.mesh.P``) a rank updates its slices and takes every statistic
over the whole leaf, as the JAX optimizer under GSPMD does: the factored
second moments of a split leaf (``v_row``/``v_col`` are kept whole on
every rank, the JAX rule that replicates reduced-rank state; for the
expert stacks one of them is a mean across experts), the block-RMS clip
and the parameter-scale RMS, each a sum over the rank's slice all-reduced
over the axes that split the leaf.  The unfactored ``v`` is a slice, like
its param.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from learning_at_home_tpu_torch.parallel.mesh import LeafShard
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map

NO_PARAMS_MSG = (
    "You are using a transformation that requires the current value of "
    "parameters, but you are not passing `params` when calling `update`."
)


class FusedAdafactorState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    v_row: Any  # factored row stats ([1] sentinel when unfactored)
    v_col: Any
    v: Any  # full second moment ([1] sentinel when factored)


class FusedOptimizer(NamedTuple):
    """The optax contract (``init``, ``update``) plus ``apply_fused``,
    which ``make_train_step`` uses when present."""

    init: Callable
    update: Callable
    apply_fused: Callable


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, held at the dtype's maximum instead of wrapping."""
    top = torch.iinfo(count.dtype).max
    return torch.where(count < top, count + 1, count)


def _factored_dims(shape, factored: bool,
                   min_dim: int) -> Optional[tuple[int, int]]:
    """The two largest axes to reduce over, or None (optax's rule, with
    numpy's argsort so that ties resolve the same way)."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def state_shapes(shape, factored: bool = True, min_dim: int = 128,
                 local_shape=None):
    """(v_row, v_col, v) shapes of one leaf of global ``shape``; an
    unfactored ``v`` takes the rank's ``local_shape`` (default ``shape``)."""
    shape = tuple(shape)
    dims = _factored_dims(shape, factored, min_dim)
    if dims is None:
        return (1,), (1,), tuple(shape if local_shape is None else local_shape)
    d1, d0 = dims
    return (tuple(np.delete(shape, d0)), tuple(np.delete(shape, d1)), (1,))


def leaf_shards(params, mesh, specs):
    """A tree like ``params`` of each leaf's ``LeafShard`` (None for a leaf
    held whole, and everywhere without a mesh)."""
    if mesh is None:
        return tree_map(lambda p: None, params)
    return tree_map(lambda p, spec: LeafShard.of(mesh, spec, p.shape),
                    params, specs)


def global_shape_of(p, shard) -> tuple:
    return tuple(p.shape) if shard is None else tuple(shard.shape)


def fused_adafactor(
    learning_rate: float,
    min_dim_size_to_factor: int = 128,
    decay_rate: float = 0.8,
    decay_offset: int = 0,
    multiply_by_parameter_scale: bool = True,
    clipping_threshold: Optional[float] = 1.0,
    weight_decay_rate: Optional[float] = None,
    eps: float = 1e-30,
    factored: bool = True,
    mesh=None,
    specs=None,
) -> FusedOptimizer:
    """Adafactor with the JAX package's defaults and update rule; over a
    mesh with ``mesh`` and ``specs`` (module docstring)."""

    def init_fn(params):
        def zeros(p, shape):
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        def leaf(p, shard):
            shapes = state_shapes(global_shape_of(p, shard), factored,
                                  min_dim_size_to_factor, p.shape)
            return tuple(zeros(p, s) for s in shapes)

        trip = tree_map(leaf, params, leaf_shards(params, mesh, specs))
        device = tree_leaves(params)[0].device
        return FusedAdafactorState(
            count=torch.zeros([], dtype=torch.int32, device=device),
            v_row=tree_map(lambda _, t: t[0], params, trip),
            v_col=tree_map(lambda _, t: t[1], params, trip),
            v=tree_map(lambda _, t: t[2], params, trip),
        )

    def _leaf(g, vr, vc, v, p, decay_t, shard=None):
        """One leaf: (f32 update u, new v_row, new v_col, new v)."""
        g32 = g.float()
        g_sqr = g32 * g32 + eps
        shape = global_shape_of(p, shard)
        dims = _factored_dims(shape, factored, min_dim_size_to_factor)

        def mean(x, dim=None):
            """x's mean over ``dim`` (None: the whole leaf) of the
            global leaf."""
            if shard is None:
                return x.mean() if dim is None else x.mean(dim=dim)
            if dim is None:
                return shard.total(x.sum()) / shard.numel()
            return shard.stat(x.sum(dim=dim), dim) / shape[dim]

        if dims is not None:
            d1, d0 = dims
            new_vr32 = decay_t * vr.float() + (1.0 - decay_t) * mean(g_sqr, d0)
            new_vc32 = decay_t * vc.float() + (1.0 - decay_t) * mean(g_sqr, d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = new_vr32.mean(dim=reduced_d1, keepdim=True)
            row_factor = (new_vr32 / row_mean) ** -0.5
            col_factor = new_vc32 ** -0.5
            if shard is not None:  # the whole stats, this rank's slices
                row_factor = shard.local(row_factor, d0)
                col_factor = shard.local(col_factor, d1)
            u = g32 * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            new_vr, new_vc, new_v = new_vr32.to(p.dtype), new_vc32.to(p.dtype), v
        else:
            new_v32 = decay_t * v.float() + (1.0 - decay_t) * g_sqr
            u = g32 * new_v32 ** -0.5
            new_vr, new_vc, new_v = vr, vc, new_v32.to(p.dtype)
        if clipping_threshold is not None:
            clip_denom = torch.clamp(
                torch.sqrt(mean(u * u)) / clipping_threshold, min=1.0)
            u = u / clip_denom
        scale = torch.tensor(learning_rate, dtype=torch.float32,
                             device=u.device)
        if multiply_by_parameter_scale:
            p32 = p.float()
            p_rms = torch.sqrt(mean(p32 * p32))
            scale = scale * torch.clamp(p_rms, min=1e-3)
        u = u * scale
        if weight_decay_rate is not None:
            u = u + weight_decay_rate * p.float()
        return u, new_vr, new_vc, new_v

    def _transform(grads, state, params, apply: bool):
        if params is None:
            raise ValueError(NO_PARAMS_MSG)
        # optax's _decay_rate_pow(step - offset): 1 - (t+1)^-decay_rate
        t = (state.count - decay_offset + 1).float()
        decay_t = 1.0 - t ** (-decay_rate)

        def leaf(g, vr, vc, v, p, shard):
            u, new_vr, new_vc, new_v = _leaf(g, vr, vc, v, p, decay_t, shard)
            if apply:  # p - u in f32, written back in place
                p.copy_((p.float() - u).to(p.dtype))
                first = p
            else:
                first = (-u).to(p.dtype)
            return first, new_vr, new_vc, new_v

        out = tree_map(leaf, grads, state.v_row, state.v_col, state.v, params,
                       leaf_shards(params, mesh, specs))
        new_state = FusedAdafactorState(
            count=safe_increment(state.count),
            v_row=tree_map(lambda _, o: o[1], params, out),
            v_col=tree_map(lambda _, o: o[2], params, out),
            v=tree_map(lambda _, o: o[3], params, out),
        )
        return tree_map(lambda _, o: o[0], params, out), new_state

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        return _transform(grads, state, params, apply=False)

    @torch.no_grad()
    def apply_fused(params, grads, state):
        """Updates ``params`` in place; returns ``(params, new_state)``."""
        return _transform(grads, state, params, apply=True)

    return FusedOptimizer(init_fn, update_fn, apply_fused)
