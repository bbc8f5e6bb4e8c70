"""The port's expert zoo (``learning_at_home_tpu_torch/models/layers.py``)
against the JAX package's ``make_expert`` blocks, on converted params.

Each of the five registry blocks at hidden 32 (transformer: 8 heads of 4)
takes the same numpy-seeded inputs in both packages: outputs, input
gradients and parameter gradients under one random cotangent.  f32
throughout; the two packages sum matmuls in other orders, measured
differences ≤ 3e-6 on values of order 1-5, so the bar is
``atol = rtol = 2e-5`` (the JAX package's own fused-vs-chunked gradient
bar).  The deterministic-dropout masks are held bit for bit, negative
int32 seeds included, because the server's backward re-runs the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_at_home_tpu.models.layers import make_expert as jax_make_expert
from learning_at_home_tpu_torch.convert import expert_from_jax, expert_to_jax
from learning_at_home_tpu_torch.models import layers
from learning_at_home_tpu_torch.models.layers import (
    DeterministicDropoutBlock,
    make_expert,
    name_to_block,
    sample_inputs,
)

H = 32
ROWS = 6
TOL = dict(atol=2e-5, rtol=2e-5)
BLOCKS = sorted(name_to_block)


def _pair(name, seed=1):
    """(JAX apply, JAX params, port apply, port params) on one init."""
    japply, jparams = jax_make_expert(name, H, jax.random.PRNGKey(seed))
    tapply, _ = make_expert(name, H, torch.Generator().manual_seed(0),
                            device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams, _ = expert_from_jax(np_params, device="cpu")
    return japply, jparams, tapply, tparams


def _inputs(name, rng, rows=ROWS):
    x = rng.standard_normal((rows, H)).astype(np.float32)
    if name == "det_dropout":
        seed = rng.integers(-2 ** 31, 2 ** 31, size=rows).astype(np.int32)
        return [x, seed]
    return [x]


def test_the_registry_matches_the_jax_package():
    from learning_at_home_tpu.models import layers as jax_layers

    assert sorted(jax_layers.name_to_block) == BLOCKS
    for name in BLOCKS:
        got = sample_inputs(name, H, rows=3)
        want = jax_layers.sample_inputs(name, H, rows=3)
        assert [(a.shape, a.dtype) for a in got] == \
            [(a.shape, a.dtype) for a in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", BLOCKS)
def test_param_tree_is_flax_tree(name):
    """Same nesting, names, shapes and dtypes as flax's init; the port's
    own init draws flax's distributions (zero biases, unit scales)."""
    _, jparams = jax_make_expert(name, H, jax.random.PRNGKey(0))
    _, tparams = make_expert(name, H, torch.Generator().manual_seed(0),
                             device="cpu")
    jspec = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jparams)
    tspec = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        tparams)
    assert jspec == tspec
    for path, leaf in jax.tree_util.tree_leaves_with_path(tparams):
        key = jax.tree_util.keystr(path)
        if key.endswith("['bias']"):
            assert not leaf.any(), key
        elif key.endswith("['scale']"):
            assert (leaf == 1).all(), key


def test_init_draws_lecun_normal():
    """Dense kernels: a truncated normal of std 1/sqrt(fan_in), as
    flax's ``lecun_normal``; attention projections by their contracted
    dims (out: heads*head_dim)."""
    _, p = make_expert("transformer", 256, torch.Generator().manual_seed(3),
                       device="cpu")
    p = p["params"]
    for kernel, fan_in in ((p["Dense_0"]["kernel"], 256),
                           (p["Dense_1"]["kernel"], 1024),
                           (p["MultiHeadDotProductAttention_0"]["query"]
                            ["kernel"], 256),
                           (p["MultiHeadDotProductAttention_0"]["out"]
                            ["kernel"], 256)):
        std = float(kernel.std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (fan_in, std)
        bound = 2 / 0.87962566103423978 / np.sqrt(fan_in)
        assert float(kernel.abs().max()) <= bound * (1 + 1e-6)


@pytest.mark.parametrize("name", BLOCKS)
def test_forward_and_grads_match_jax(name):
    rng = np.random.default_rng(7)
    japply, jparams, tapply, tparams = _pair(name)
    ins = _inputs(name, rng)
    jout, vjp = jax.vjp(
        lambda p, x: japply(p, x, *[jnp.asarray(a) for a in ins[1:]]),
        jparams, jnp.asarray(ins[0]))
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                tparams)
    x = torch.from_numpy(ins[0]).requires_grad_(True)
    tout = tapply(tp, x, *[torch.from_numpy(a) for a in ins[1:]])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)

    cot = rng.standard_normal(np.shape(jout)).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(cot))
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jgp)
    tleaves = jax.tree_util.tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for (path, jg), t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


def test_transformer_block_attends_over_a_sequence_axis():
    """[batch, seq, hidden] inputs: attention within each sequence, as
    flax's MHA over its second-to-last axis."""
    rng = np.random.default_rng(11)
    japply, jparams, tapply, tparams = _pair("transformer")
    x = rng.standard_normal((3, 5, H)).astype(np.float32)
    np.testing.assert_allclose(
        tapply(tparams, torch.from_numpy(x)).numpy(),
        np.asarray(japply(jparams, jnp.asarray(x))), **TOL)


def test_det_dropout_masks_are_jax_bit_for_bit():
    seeds = np.array([0, 1, -1, 7, 2 ** 31 - 1, -2 ** 31, 123456789],
                     np.int32)
    block = DeterministicDropoutBlock(H)
    want = np.asarray(jax.vmap(
        lambda s: jax.random.bernoulli(jax.random.PRNGKey(s), 0.9, (4 * H,))
    )(jnp.asarray(seeds)))
    got = block.masks(torch.from_numpy(seeds)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.8 < got.mean() < 0.98


def test_det_dropout_forward_is_a_function_of_the_seed():
    rng = np.random.default_rng(5)
    _, _, tapply, tparams = _pair("det_dropout")
    x, seed = _inputs("det_dropout", rng)
    a = tapply(tparams, torch.from_numpy(x), torch.from_numpy(seed))
    b = tapply(tparams, torch.from_numpy(x), torch.from_numpy(seed))
    c = tapply(tparams, torch.from_numpy(x), torch.from_numpy(seed + 1))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_layer_norm_is_flax_layer_norm():
    """eps 1e-6 and the mean-of-squares variance, not torch's defaults."""
    import flax.linen as nn

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, H)) * 3 + 5).astype(np.float32)
    scale = rng.standard_normal(H).astype(np.float32)
    bias = rng.standard_normal(H).astype(np.float32)
    want = nn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    ln = layers.LayerNorm(H)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x))
    assert layers.LAYER_NORM_EPS == 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        layers.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["ffn", "nop"])
def test_params_round_trip_bitwise(name):
    _, jparams = jax_make_expert(name, H, jax.random.PRNGKey(4))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams, _ = expert_from_jax(np_params, device="cpu")
    back, _ = expert_to_jax(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(np_params),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_make_expert_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_expert("ffn", H, torch.Generator().manual_seed(0))
