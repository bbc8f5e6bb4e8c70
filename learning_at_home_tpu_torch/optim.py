"""Adam, AdamW and SGD with optax's semantics and state.

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
- :func:`sgd`: ``(EmptyState(), EmptyState())``.

Their defaults are optax's, including adamw's weight decay 1e-4:
``torch.optim.AdamW`` defaults to 1e-2 and keeps another state, so it is
not used.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from learning_at_home_tpu_torch.ops.fused_adafactor import (
    NO_PARAMS_MSG,
    safe_increment,
)
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map


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


@torch.no_grad()
def apply_updates(params, updates):
    """``optax.apply_updates`` in place: each leaf becomes
    ``(p + u)`` cast to p's dtype.  Returns ``params``."""
    tree_map(lambda p, u: p.copy_((p + u).to(p.dtype)), params, updates)
    return params
