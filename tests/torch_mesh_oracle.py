"""The JAX side of the port's mesh tests: the JAX model on its virtual
mesh, built once per configuration in a test process, with one compiled
``value_and_grad`` of its loss that the tests share.

A training reference takes that gradient and applies the optax update
outside ``jit`` (what ``make_train_step`` computes, without compiling a
train step per optimizer), so a module compiles each configuration's
gradient once.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import optax

from learning_at_home_tpu.models.transformer import (
    DMoETransformerConfig as JaxConfig,
    DMoETransformerLM as JaxLM,
)
from learning_at_home_tpu.parallel import make_mesh as jax_make_mesh

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, seq_len=16,
            num_experts=8, k=2)


def jax_mesh(axes: dict):
    """The JAX mesh of ``axes`` on the first devices of the virtual mesh."""
    n = math.prod(axes.values())
    return jax_make_mesh(dict(axes), devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _model(axes: tuple, over: tuple):
    cfg = JaxConfig(**{**TINY, "dtype": jnp.float32, **dict(over)})
    model = JaxLM(cfg, jax_mesh(dict(axes)))
    params = jax.device_get(model.init_params(jax.random.PRNGKey(0)))
    grad = jax.jit(jax.value_and_grad(
        lambda p, i, t: model.loss_fn(p, i, t)[0]))
    return model, params, grad


def jax_model(axes: dict, **over):
    """(model, its params from PRNGKey(0) as numpy) of TINY with ``over``
    on the mesh of ``axes``."""
    model, params, _ = _model(tuple(axes.items()), tuple(sorted(over.items())))
    return model, params


def jax_value_and_grad(axes: dict, params, ids, tgt, **over):
    """(loss, grads as numpy) of the configuration's loss_fn."""
    _, _, grad = _model(tuple(axes.items()), tuple(sorted(over.items())))
    loss, grads = grad(params, jnp.asarray(ids), jnp.asarray(tgt))
    return float(loss), jax.device_get(grads)


def jax_train(axes: dict, opt, batches, **over):
    """The losses of optimizer steps from the configuration's params on
    ``batches`` (the loss before each update, as the train step returns
    it), the final params and the final optimizer state."""
    _, params, _ = _model(tuple(axes.items()), tuple(sorted(over.items())))
    state = opt.init(params)
    losses = []
    for ids, tgt in batches:
        loss, grads = jax_value_and_grad(axes, params, ids, tgt, **over)
        updates, state = opt.update(grads, state, params)
        params = jax.device_get(optax.apply_updates(params, updates))
        losses.append(loss)
    return losses, params, jax.device_get(state)
