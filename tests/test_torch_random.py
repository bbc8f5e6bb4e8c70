"""The port's threefry stream (random.py) against ``jax.random``, bit for
bit: keys, ``fold_in``, raw bits and ``uniform``, for several seeds and
salts, odd shapes and the router's [n, 256]."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_at_home_tpu_torch import random as tr

SEEDS = [0, 1, 0x5EED, 2**31 - 1, 2**32 - 1]
SHAPES = [(1,), (3,), (7, 5), (2, 3, 4), (513, 256)]


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_jax_defaults_the_port_reproduces():
    """The port draws JAX's default stream under these two settings; a JAX
    that changes either fails here rather than drawing other bits."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS + [2**40 + 5, -7])
def test_prng_key_matches_jax(seed):
    got = tr.PRNGKey(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    key, jkey = tr.PRNGKey(seed), jax.random.PRNGKey(seed)
    for data in (0, 1, 3, 255, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(tr.fold_in(key, data).numpy(),
                                      _words(jax.random.fold_in(jkey, data)))
    # an int32 salt as a tensor (the layer index a traced loop carries),
    # negative ones taken mod 2^32 as JAX's cast to uint32 does
    for salt in (2, -2):
        want = jax.jit(lambda s: jax.random.key_data(
            jax.random.fold_in(jkey, s)))(jnp.int32(salt))
        got = tr.fold_in(key, torch.tensor(salt, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    with pytest.raises(ValueError, match="uint32"):
        tr.fold_in(key, -1)
    with pytest.raises(TypeError):
        tr.fold_in(key, torch.tensor([1, 2]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bit_width,jdtype,view", [
    (8, jnp.uint8, np.uint8), (16, jnp.uint16, np.uint16),
    (32, jnp.uint32, np.uint32)])
def test_random_bits_match_jax(shape, bit_width, jdtype, view):
    for seed in (0, 0x5EED):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        key = tr.fold_in(tr.PRNGKey(seed), 7)
        want = np.asarray(jax.random.bits(jkey, shape, dtype=jdtype))
        got = tr.random_bits(key, bit_width, shape).numpy().view(view)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_uniform_matches_jax_bitwise(shape, dtype, jdtype):
    """Every bit, over the unit interval, jitter widths and a wide range;
    the router's U(0.9, 1.1) included."""
    for seed in SEEDS:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        key = tr.fold_in(tr.PRNGKey(seed), 3)
        for lo, hi in ((0.0, 1.0), (0.9, 1.1), (0.7, 1.3), (0.99, 1.01),
                       (-2.0, 5.0)):
            want = np.asarray(jax.random.uniform(
                jkey, shape, dtype=jdtype, minval=lo, maxval=hi))
            got = tr.uniform(key, shape, dtype, lo, hi)
            assert got.dtype == dtype and tuple(got.shape) == shape
            np.testing.assert_array_equal(
                got.view(torch.int32 if dtype == torch.float32
                         else torch.int16).numpy(),
                want.view(np.int32 if dtype == torch.float32 else np.int16),
                err_msg=f"seed {seed} [{lo}, {hi})")
            lo_d, hi_d = (float(torch.tensor(v, dtype=dtype)) for v in (lo, hi))
            assert lo_d <= float(got.min()) and float(got.max()) <= hi_d


def test_uniform_refuses_other_dtypes():
    with pytest.raises(TypeError, match="uniform"):
        tr.uniform(tr.PRNGKey(0), (3,), torch.float16)
    with pytest.raises(ValueError, match="bit_width"):
        tr.random_bits(tr.PRNGKey(0), 64, (3,))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 1, (2, 3)])
def test_split_matches_jax(seed, num):
    key, jkey = tr.PRNGKey(seed), jax.random.PRNGKey(seed)
    got = tr.split(key, num)
    want = _words(jax.random.split(jkey, num))
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_nested_splits_match_jax(seed):
    """The decode loop's chain: ``rng, sub = split(rng)`` every step, and
    the subkeys split again."""
    key, jkey = tr.PRNGKey(seed), jax.random.PRNGKey(seed)
    for _ in range(6):
        key, sub = tr.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(sub.numpy(), _words(jsub))
        np.testing.assert_array_equal(tr.split(sub, 3).numpy(),
                                      _words(jax.random.split(jsub, 3)))
    np.testing.assert_array_equal(key.numpy(), _words(jkey))


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 logarithm on the CPU, jitted as the sampler runs it."""
    return np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 ulps of two arrays of one sign."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", [(7, 5), (4096, 64)])
@pytest.mark.parametrize("seed", [0, 0x5EED])
def test_gumbel_matches_jax_within_an_ulp(seed, shape):
    """f32 noise ``-log(-log(u))``: each of the port's two logarithms is
    within one f32 ulp of XLA's on the same input (the port's is the
    correctly rounded one), so the noise is JAX's up to what one ulp at
    each logarithm makes; and bit for bit wherever XLA's two logarithms
    are the correctly rounded ones."""
    jkey, key = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    want = np.asarray(jax.random.gumbel(jkey, shape, jnp.float32))
    got = tr.gumbel(key, shape, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    got = got.numpy()
    u = np.asarray(jax.random.uniform(jkey, shape, jnp.float32,
                                      minval=np.finfo(np.float32).tiny))
    np.testing.assert_array_equal(
        tr.uniform(key, shape, torch.float32,
                   minval=np.finfo(np.float32).tiny).numpy(), u)
    inner = -_log_f32(u)  # > 0
    port_inner = (-np.log(u.astype(np.float64))).astype(np.float32)
    assert _ulps(port_inner, inner).max() <= 1
    outer = _log_f32(inner)
    port_outer = np.log(inner.astype(np.float64)).astype(np.float32)
    assert (np.sign(outer) == np.sign(port_outer)).all()
    assert _ulps(port_outer, outer).max() <= 1
    # one ulp at each logarithm, carried through the outer one
    limit = 2 * np.spacing(np.abs(want)) + np.spacing(inner) / inner
    assert (np.abs(got - want) <= limit).all()
    exact = (inner == port_inner) & (outer == port_outer)
    assert exact.mean() > 0.5
    np.testing.assert_array_equal(got[exact].view(np.int32),
                                  want[exact].view(np.int32))


def test_gumbel_bf16_matches_jax_bitwise():
    for seed in SEEDS:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                            (513, 17), jnp.bfloat16))
        got = tr.gumbel(tr.PRNGKey(seed), (513, 17), torch.bfloat16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_picks_jax_indices(seed, axis):
    """Logits of one row of a decode step (temperature-scaled model
    logits) and a wide batch: the same index for every distribution."""
    rng = np.random.default_rng(seed % 1000)
    logits = (rng.standard_normal((16, 2048)) / 0.7).astype(np.float32)
    if axis == 0:
        logits = logits.T.copy()
    jkey, key = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits),
                                             axis=axis))
    got = tr.categorical(key, torch.from_numpy(logits), axis=axis)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
