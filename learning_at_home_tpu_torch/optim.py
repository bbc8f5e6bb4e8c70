"""Adam, AdamW, SGD and Adafactor with optax's semantics and state.

``optax.adamw(lr)`` is the chain scale_by_adam → add_decayed_weights →
scale_by_learning_rate; ``optax.adam(lr)`` the same chain without the
decay; ``optax.sgd(lr)`` (no momentum) identity → scale_by_learning_rate.
The functions here compute the same updates in the same order and dtypes
(moments in the param dtype, bias corrections in f32), with optax's
state, so a converted state continues identically (``convert.py``):

- :func:`adamw`: ``AdamWState(count, mu, nu)``, the fields of optax's
  ``ScaleByAdamState``;
- :func:`adam`: ``(ScaleByAdamState(count, mu, nu), EmptyState())``, the
  tuple optax's chain keeps (count int32);
- :func:`sgd`: ``(EmptyState(), EmptyState())``;
- :func:`adafactor`: ``(FactoredState(count, v_row, v_col, v),
  EmptyState(), EmptyState(), EmptyState(), EmptyState())``, the state of
  optax's five-stage chain (``scale_by_factored_rms``,
  ``clip_by_block_rms(1.0)``, ``scale_by_learning_rate``,
  ``scale_by_param_block_rms``, ``scale(-1)``).  Unlike the fused
  Adafactor of ``ops/fused_adafactor.py``, which does its math in f32, it
  rounds as XLA does: each elementwise operation in the storage dtype (a
  Python constant first cast to it), each mean summed in f32 and cast
  back, the second-moment EMAs in f32 (optax's decay is a strong f32).

Their defaults are optax's, including adamw's weight decay 1e-4:
``torch.optim.AdamW`` defaults to 1e-2 and keeps another state, so it is
not used.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from learning_at_home_tpu_torch.ops.fused_adafactor import (
    NO_PARAMS_MSG,
    _factored_dims,
    global_shape_of,
    leaf_shards,
    safe_increment,
    state_shapes,
)
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: Any  # first moment, param dtype
    nu: Any  # second moment, param dtype


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the first entry of ``adam``'s state."""

    count: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: the state of a stateless transformation."""


class FactoredState(NamedTuple):
    """optax's ``FactoredState``: the first entry of ``adafactor``'s
    state; ``[1]`` sentinels where a leaf keeps the other form."""

    count: torch.Tensor  # int32 scalar
    v_row: Any
    v_col: Any
    v: Any


class GradientTransformation(NamedTuple):
    """The optax contract: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def _c(value, like):
    """A Python constant in ``like``'s dtype, as JAX casts a weakly typed
    scalar to the array's dtype (bf16 for bf16 params) before the
    operation, where torch would keep it in f32."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _zero_moments(params):
    device = tree_leaves(params)[0].device
    return (torch.zeros([], dtype=torch.int32, device=device),
            tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params))


def _scale_by_adam(grads, count, mu, nu, b1, b2, eps):
    """optax's ``scale_by_adam``: the new moments and count, and the
    bias-corrected direction ``mu_hat / (sqrt(nu_hat) + eps)``."""
    mu = tree_map(lambda g, m: _c(1 - b1, g) * g + _c(b1, m) * m, grads, mu)
    nu = tree_map(lambda g, v: _c(1 - b2, g) * (g ** 2) + _c(b2, v) * v,
                  grads, nu)
    count = safe_increment(count)
    # bias corrections in f32, then in each moment's own dtype
    bc1 = 1 - b1 ** count.float()
    bc2 = 1 - b2 ** count.float()
    direction = tree_map(
        lambda m, v: (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype))
                                              + _c(eps, v)),
        mu, nu)
    return direction, count, mu, nu


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    def init_fn(params):
        return AdamWState(*_zero_moments(params))

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError(NO_PARAMS_MSG)
        u, count, mu, nu = _scale_by_adam(grads, state.count, state.mu,
                                          state.nu, b1, b2, eps)
        updates = tree_map(
            lambda d, p: _c(-learning_rate, d) * (d + _c(weight_decay, p) * p),
            u, params)
        return updates, AdamWState(count, mu, nu)

    return GradientTransformation(init_fn, update_fn)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam``: the server's default optimizer."""

    def init_fn(params):
        return (ScaleByAdamState(*_zero_moments(params)), EmptyState())

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        adam_state = state[0]
        u, count, mu, nu = _scale_by_adam(grads, adam_state.count,
                                          adam_state.mu, adam_state.nu,
                                          b1, b2, eps)
        updates = tree_map(lambda d: _c(-learning_rate, d) * d, u)
        return updates, (ScaleByAdamState(count, mu, nu), EmptyState())

    return GradientTransformation(init_fn, update_fn)


def sgd(learning_rate: float) -> GradientTransformation:
    """``optax.sgd`` without momentum: ``-learning_rate * g``."""

    def init_fn(params):
        return (EmptyState(), EmptyState())

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        return tree_map(lambda g: _c(-learning_rate, g) * g, grads), state

    return GradientTransformation(init_fn, update_fn)


_XLA_WINDOW = 32


def _sequential_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim, added left to right."""
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def _xla_cpu_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` summed over ``dims`` in XLA:CPU's order: while a reduced dim
    is longer than 32, each is zero-padded evenly at both ends to a
    multiple of 32 and summed in windows of 32 (a dim of at most 32 whole),
    each window's elements added in row-major order; then the rest in
    row-major order.  Bit for bit the reference's f32 sums along one dim
    and over a window of one dim; a window over several dims (a whole
    leaf of rank >= 2) is within an ulp or so of XLA's own order."""
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    keep = [d for d in range(nd) if d not in dims]
    x = x.permute(*keep, *dims)
    k, r = len(keep), len(dims)
    while any(s > _XLA_WINDOW for s in x.shape[k:]):
        pads, counts, widths = [], [], []
        for s in x.shape[k:]:
            w = _XLA_WINDOW if s > _XLA_WINDOW else s
            p = (-s) % w
            pads.append((p // 2, p - p // 2))
            counts.append((s + p) // w)
            widths.append(w)
        x = torch.nn.functional.pad(
            x, [v for lo_hi in reversed(pads) for v in lo_hi])
        x = x.reshape(*x.shape[:k],
                      *[v for n, w in zip(counts, widths) for v in (n, w)])
        x = x.permute(*range(k), *range(k, k + 2 * r, 2),
                      *range(k + 1, k + 2 * r, 2))
        x = _sequential_sum(x.reshape(*x.shape[:k + r], -1))
    return _sequential_sum(x.reshape(*x.shape[:k], -1))


def _mean(x, dim=None, keepdim: bool = False, shard=None):
    """``jnp.mean``: summed in f32 (a bf16 input upcast), times the f32
    reciprocal of the count (XLA's rewrite of the division by a
    constant), cast back to the input's dtype.  On the CPU the sum
    follows XLA:CPU's order (:func:`_xla_cpu_sum`); on the card there is
    no XLA order to follow, and torch's f32 sum is used.  With ``shard``
    (a ``LeafShard``) ``x`` is a rank's slice and the mean is the whole
    leaf's: the slice's sum all-reduced over the leaf's axes."""
    dims = list(range(x.dim())) if dim is None else [dim % x.dim()]
    x32 = x.float()
    if x.device.type == "cpu" and x.dim():
        total = _xla_cpu_sum(x32, dims)
    else:
        total = x32.sum(dims)
    shape = x.shape
    if shard is not None:
        shape = shard.shape
        total = (shard.total(total) if dim is None
                 else shard.stat(total, dims[0]))
    n = 1
    for d in dims:
        n *= shape[d]
    m = total * float(np.float32(1.0) / np.float32(n))
    if keepdim:
        for d in dims:
            m = m.unsqueeze(d)
    return m.to(x.dtype)


# optax.adafactor's defaults, the only values the callers use
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30


def adafactor(learning_rate: float, mesh=None,
              specs=None) -> GradientTransformation:
    """``optax.adafactor(learning_rate)``: optax's defaults (clipping at
    1.0, the parameter-scale multiply, no momentum, no weight decay), its
    factoring rule (the two largest dims of a leaf of rank >= 2 whose
    second largest is >= 128) and its state.  Over a mesh (``mesh`` and
    ``specs``) every mean spans the whole leaf and the factored
    statistics are kept whole, as in ``ops/fused_adafactor.py``."""

    def init_fn(params):
        def zeros(p, shape):
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        trip = tree_map(
            lambda p, shard: tuple(zeros(p, s) for s in state_shapes(
                global_shape_of(p, shard), True,
                ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR, p.shape)),
            params, leaf_shards(params, mesh, specs))
        device = tree_leaves(params)[0].device
        first = FactoredState(
            count=torch.zeros([], dtype=torch.int32, device=device),
            v_row=tree_map(lambda _, t: t[0], params, trip),
            v_col=tree_map(lambda _, t: t[1], params, trip),
            v=tree_map(lambda _, t: t[2], params, trip))
        return (first, EmptyState(), EmptyState(), EmptyState(), EmptyState())

    def ema(decay_t, v, g_sqr):
        """``decay_t * v + (1 - decay_t) * g_sqr`` in f32 as XLA:CPU
        computes it (one fused multiply-add over the second product,
        emulated in f64), cast to v's dtype."""
        rest = ((1.0 - decay_t) * g_sqr.float()).double()
        return (decay_t.double() * v.double() + rest).float().to(v.dtype)

    def rsqrt(x):
        """``x ** -0.5``: in f32 through f64 (XLA's f32 ``pow`` is
        nearly correctly rounded), in bf16 as a bf16 power."""
        if x.dtype == torch.float32:
            return (x.double() ** -0.5).float()
        return x ** _c(-0.5, x)

    def scaled_by_factored_rms(g, vr, vc, v, p, decay_t, shard):
        """Stage 1 for one leaf: (update, v_row, v_col, v)."""
        g_sqr = g * g + _c(ADAFACTOR_EPS, g)
        dims = _factored_dims(global_shape_of(p, shard), True,
                              ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR)
        if dims is None:
            new_v = ema(decay_t, v, g_sqr)
            return g * rsqrt(new_v), vr, vc, new_v
        d1, d0 = dims
        new_vr = ema(decay_t, vr, _mean(g_sqr, d0, shard=shard))
        new_vc = ema(decay_t, vc, _mean(g_sqr, d1, shard=shard))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = _mean(new_vr, reduced_d1, keepdim=True)
        row_factor = rsqrt(new_vr / row_col_mean)
        col_factor = rsqrt(new_vc)
        if shard is not None:  # the whole stats, this rank's slices
            row_factor = shard.local(row_factor, d0)
            col_factor = shard.local(col_factor, d1)
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        return u, new_vr, new_vc, v

    def clipped(u, shard):
        """``clip_by_block_rms(1.0)``."""
        rms = torch.sqrt(_mean(u * u, shard=shard)) / _c(1.0, u)
        return u / torch.maximum(_c(1.0, u), rms)

    def by_param_rms(u, p, shard):
        """``scale_by_param_block_rms()``: ``safe_root_mean_squares``
        of the param with min_rms 1e-3."""
        rms = torch.sqrt(_mean(p * p, shard=shard))
        floor = _c(1e-3, rms)
        return u * torch.where(rms <= floor, floor, rms)

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError(NO_PARAMS_MSG)
        fs = state[0]
        # optax's _decay_rate_pow(count): a strong f32
        t = (fs.count + 1).float()
        decay_t = 1.0 - t ** -ADAFACTOR_DECAY_RATE

        def leaf(g, vr, vc, v, p, shard):
            u, vr, vc, v = scaled_by_factored_rms(g, vr, vc, v, p, decay_t,
                                                  shard)
            u = by_param_rms(_c(learning_rate, u) * clipped(u, shard), p,
                             shard)
            return -u, vr, vc, v

        out = tree_map(leaf, grads, fs.v_row, fs.v_col, fs.v, params,
                       leaf_shards(params, mesh, specs))
        new = FactoredState(
            count=safe_increment(fs.count),
            v_row=tree_map(lambda _, o: o[1], params, out),
            v_col=tree_map(lambda _, o: o[2], params, out),
            v=tree_map(lambda _, o: o[3], params, out))
        return (tree_map(lambda _, o: o[0], params, out),
                (new, *state[1:]))

    return GradientTransformation(init_fn, update_fn)


@torch.no_grad()
def apply_updates(params, updates):
    """``optax.apply_updates`` in place: each leaf becomes
    ``(p + u)`` cast to p's dtype.  Returns ``params``."""
    tree_map(lambda p, u: p.copy_((p + u).to(p.dtype)), params, updates)
    return params


@torch.no_grad()
def applied_updates(params, updates):
    """``optax.apply_updates`` out of place: a NEW tree of ``(p + u)``
    cast to p's dtype, so a reference to the old tree (a pipelined
    trainer's snapshot, autograd's saved tensors) keeps its values."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def value_and_grad(loss: Callable) -> Callable:
    """``jax.value_and_grad`` for a ``loss(params, *args)`` of a tree of
    tensors: ``(value, grads)``, the value detached and the grads a tree
    like params, by autograd from fresh leaves (params are not touched)."""

    def fn(params, *args):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        value = loss(p, *args)
        grads = torch.autograd.grad(value, tree_leaves(p))
        return value.detach(), tree_unflatten(params, grads)

    return fn
