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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

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


def state_shapes(shape, factored: bool = True, min_dim: int = 128):
    """(v_row, v_col, v) shapes of one leaf of ``shape``."""
    shape = tuple(shape)
    dims = _factored_dims(shape, factored, min_dim)
    if dims is None:
        return (1,), (1,), shape
    d1, d0 = dims
    return (tuple(np.delete(shape, d0)), tuple(np.delete(shape, d1)), (1,))


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
) -> FusedOptimizer:
    """Adafactor with the JAX package's defaults and update rule."""

    def init_fn(params):
        def zeros(p, shape):
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        def leaf(p):
            shapes = state_shapes(p.shape, factored, min_dim_size_to_factor)
            return tuple(zeros(p, s) for s in shapes)

        trip = tree_map(leaf, params)
        device = tree_leaves(params)[0].device
        return FusedAdafactorState(
            count=torch.zeros([], dtype=torch.int32, device=device),
            v_row=tree_map(lambda _, t: t[0], params, trip),
            v_col=tree_map(lambda _, t: t[1], params, trip),
            v=tree_map(lambda _, t: t[2], params, trip),
        )

    def _leaf(g, vr, vc, v, p, decay_t):
        """One leaf: (f32 update u, new v_row, new v_col, new v)."""
        g32 = g.float()
        g_sqr = g32 * g32 + eps
        dims = _factored_dims(tuple(p.shape), factored, min_dim_size_to_factor)
        if dims is not None:
            d1, d0 = dims
            new_vr32 = decay_t * vr.float() + (1.0 - decay_t) * g_sqr.mean(dim=d0)
            new_vc32 = decay_t * vc.float() + (1.0 - decay_t) * g_sqr.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = new_vr32.mean(dim=reduced_d1, keepdim=True)
            row_factor = (new_vr32 / row_mean) ** -0.5
            col_factor = new_vc32 ** -0.5
            u = g32 * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            new_vr, new_vc, new_v = new_vr32.to(p.dtype), new_vc32.to(p.dtype), v
        else:
            new_v32 = decay_t * v.float() + (1.0 - decay_t) * g_sqr
            u = g32 * new_v32 ** -0.5
            new_vr, new_vc, new_v = vr, vc, new_v32.to(p.dtype)
        if clipping_threshold is not None:
            clip_denom = torch.clamp(
                torch.sqrt(torch.mean(u * u)) / clipping_threshold, min=1.0)
            u = u / clip_denom
        scale = torch.tensor(learning_rate, dtype=torch.float32,
                             device=u.device)
        if multiply_by_parameter_scale:
            p32 = p.float()
            p_rms = torch.sqrt(torch.mean(p32 * p32))
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

        def leaf(g, vr, vc, v, p):
            u, new_vr, new_vc, new_v = _leaf(g, vr, vc, v, p, decay_t)
            if apply:  # p - u in f32, written back in place
                p.copy_((p.float() - u).to(p.dtype))
                first = p
            else:
                first = (-u).to(p.dtype)
            return first, new_vr, new_vc, new_v

        out = tree_map(leaf, grads, state.v_row, state.v_col, state.v, params)
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
