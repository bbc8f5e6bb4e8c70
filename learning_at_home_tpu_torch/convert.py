"""Parameter trees between the JAX package and the port.

The JAX ``DMoETransformerLM`` keeps its parameters as a pytree of arrays;
the port keeps the same tree (same names, shapes and layouts) of tensors.
:func:`params_from_jax` takes that tree as numpy arrays (``np.asarray`` of
each leaf), checks it against a config, and returns the port's tree on a
device; :func:`params_to_jax` is its inverse.  Both layouts convert: the
stacked one (leading ``n_layers`` dim on every layer leaf) and the tuple
of per-layer trees, with a tied or an untied head.  Values are copied bit
for bit, bfloat16 included.

:func:`opt_state_from_jax` and :func:`opt_state_to_jax` do the same for
optimizer state: the fused Adafactor's ``(count, v_row, v_col, v)`` and
``optax.adamw``'s ``(count, mu, nu)``, so training carries across.
"""

from __future__ import annotations

import numpy as np
import torch

from learning_at_home_tpu_torch.device import resolve_device
from learning_at_home_tpu_torch.ops.fused_adafactor import (
    FusedAdafactorState,
    state_shapes,
)
from learning_at_home_tpu_torch.optim import AdamWState


def param_shapes(cfg) -> dict:
    """The tree of leaf shapes a model of ``cfg`` takes."""
    d, v, s, e = cfg.d_model, cfg.vocab_size, cfg.seq_len, cfg.num_experts
    f = 4 * d  # the MoE layer's ffn_mult

    def layer(lead):
        ln = {"scale": (*lead, d), "bias": (*lead, d)}
        return {
            "ln1": dict(ln), "ln2": dict(ln),
            "wq": (*lead, d, d), "wk": (*lead, d, d),
            "wv": (*lead, d, d), "wo": (*lead, d, d),
            "moe": {
                "gate": (*lead, d, e), "w1": (*lead, e, d, f),
                "b1": (*lead, e, f), "w2": (*lead, e, f, d),
                "b2": (*lead, e, d),
            },
        }

    shapes = {
        "embed": (v, d),
        "pos": (s, d),
        "ln_f": {"scale": (d,), "bias": (d,)},
        "layers": (
            layer((cfg.n_layers,))
            if cfg.stack_layers
            else tuple(layer(()) for _ in range(cfg.n_layers))
        ),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _convert(tree, shapes, path: str, leaf_fn):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(
                f"{path or 'params'}: expected keys {sorted(shapes)}, got {got}"
            )
        return {key: _convert(tree[key], shapes[key], f"{path}/{key}", leaf_fn)
                for key in shapes}
    if isinstance(shapes, tuple) and shapes and isinstance(shapes[0], dict):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(shapes):
            raise ValueError(
                f"{path}: expected a tuple of {len(shapes)} layer trees (the "
                "tuple layout), got " + type(tree).__name__
            )
        return tuple(_convert(t, sh, f"{path}/{i}", leaf_fn)
                     for i, (t, sh) in enumerate(zip(tree, shapes)))
    if tuple(tree.shape) != shapes:
        raise ValueError(
            f"{path}: expected shape {shapes}, got {tuple(tree.shape)}"
        )
    return leaf_fn(tree)


def params_from_jax(tree, cfg, device=None):
    """The JAX package's param tree (numpy arrays) → the port's tree of
    tensors on ``device`` (None: the CUDA card).  ``cfg`` is the port's or
    the JAX package's config; the tree must match its layout and shapes."""
    dev = resolve_device(device)
    return _convert(tree, param_shapes(cfg), "",
                    lambda arr: _to_tensor(arr, dev))


def params_to_jax(params, cfg):
    """The port's tree of tensors → the JAX package's layout as numpy
    arrays (``jax.device_put`` or ``jnp.asarray`` makes it a JAX tree)."""
    return _convert(params, param_shapes(cfg), "", _to_numpy)


def _map_shapes(fn, shapes):
    """``fn`` applied to every leaf shape of a :func:`param_shapes` tree."""
    if isinstance(shapes, dict):
        return {key: _map_shapes(fn, val) for key, val in shapes.items()}
    if isinstance(shapes, tuple) and shapes and isinstance(shapes[0], dict):
        return tuple(_map_shapes(fn, s) for s in shapes)
    return fn(shapes)


def _adafactor_shapes(cfg, field: int):
    return _map_shapes(lambda s: state_shapes(s)[field], param_shapes(cfg))


def opt_state_from_jax(state, cfg, device=None):
    """The JAX package's optimizer state (numpy leaves) → the port's.

    ``state`` is a ``FusedAdafactorState`` of ``ops/fused_adafactor.py``
    (default factoring: the two largest dims of each leaf of rank >= 2
    with the second largest >= 128) or ``optax.adamw``'s state (the
    chain's tuple, or its ``ScaleByAdamState``); the matching port state
    (``FusedAdafactorState`` or ``optim.AdamWState``) comes back on
    ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)

    def conv(tree, shapes, path):
        return _convert(tree, shapes, path, lambda a: _to_tensor(a, dev))

    if hasattr(state, "v_row"):
        return FusedAdafactorState(
            count=conv(state.count, (), "count"),
            v_row=conv(state.v_row, _adafactor_shapes(cfg, 0), "v_row"),
            v_col=conv(state.v_col, _adafactor_shapes(cfg, 1), "v_col"),
            v=conv(state.v, _adafactor_shapes(cfg, 2), "v"),
        )
    adam = state if hasattr(state, "mu") else next(
        (s for s in state if hasattr(s, "mu")), None)
    if adam is None:
        raise ValueError(
            f"not a fused-Adafactor or an adamw state: {type(state).__name__}")
    shapes = param_shapes(cfg)
    return AdamWState(count=conv(adam.count, (), "count"),
                      mu=conv(adam.mu, shapes, "mu"),
                      nu=conv(adam.nu, shapes, "nu"))


def opt_state_to_jax(state, cfg) -> tuple:
    """The port's optimizer state → the fields of the JAX state, in order,
    as numpy: ``(count, v_row, v_col, v)`` for the fused Adafactor (wrap
    them in its ``FusedAdafactorState``), ``(count, mu, nu)`` for adamw
    (optax's ``ScaleByAdamState``, the first entry of ``optax.adamw``'s
    chain state)."""
    if isinstance(state, FusedAdafactorState):
        return (_convert(state.count, (), "count", _to_numpy),
                _convert(state.v_row, _adafactor_shapes(cfg, 0), "v_row",
                         _to_numpy),
                _convert(state.v_col, _adafactor_shapes(cfg, 1), "v_col",
                         _to_numpy),
                _convert(state.v, _adafactor_shapes(cfg, 2), "v", _to_numpy))
    if isinstance(state, AdamWState):
        shapes = param_shapes(cfg)
        return (_convert(state.count, (), "count", _to_numpy),
                _convert(state.mu, shapes, "mu", _to_numpy),
                _convert(state.nu, shapes, "nu", _to_numpy))
    raise ValueError(f"not a port optimizer state: {type(state).__name__}")
