"""AdamW with ``optax.adamw``'s semantics and state.

``optax.adamw(lr)`` is the chain scale_by_adam → add_decayed_weights →
scale_by_learning_rate.  :func:`adamw` computes the same update in the
same order and dtypes (moments in the param dtype, bias corrections in
f32), with the state ``(count, mu, nu)`` of its ``ScaleByAdamState``, so a
converted state continues identically (``convert.py``).  Its defaults are
optax's, including weight decay 1e-4: ``torch.optim.AdamW`` defaults to
1e-2 and keeps another state, so it is not used.
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


class GradientTransformation(NamedTuple):
    """The optax contract: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    def init_fn(params):
        device = tree_leaves(params)[0].device
        return AdamWState(
            count=torch.zeros([], dtype=torch.int32, device=device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def c(value, like):
        """A Python constant in ``like``'s dtype, as JAX casts a weakly
        typed scalar to the array's dtype (bf16 for bf16 params) before
        the operation, where torch would keep it in f32."""
        return torch.tensor(value, dtype=like.dtype, device=like.device)

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError(NO_PARAMS_MSG)
        mu = tree_map(lambda g, m: c(1 - b1, g) * g + c(b1, m) * m,
                      grads, state.mu)
        nu = tree_map(lambda g, v: c(1 - b2, g) * (g ** 2) + c(b2, v) * v,
                      grads, state.nu)
        count = safe_increment(state.count)
        # bias corrections in f32, then in each moment's own dtype
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()

        def leaf(m, v, p):
            u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype))
                                         + c(eps, v))
            return c(-learning_rate, u) * (u + c(weight_decay, p) * p)

        return tree_map(leaf, mu, nu, params), AdamWState(count, mu, nu)

    return GradientTransformation(init_fn, update_fn)


@torch.no_grad()
def apply_updates(params, updates):
    """``optax.apply_updates`` in place: each leaf becomes
    ``(p + u)`` cast to p's dtype.  Returns ``params``."""
    tree_map(lambda p, u: p.copy_((p + u).to(p.dtype)), params, updates)
    return params
