"""The port's expert init against flax's: every parameter leaf of every
block of the expert zoo, drawn for one key, within 2 f32 ulp of what the
JAX package's ``make_expert`` draws for that key (on these draws: bit for
bit), for both of ``Server.create``'s seed paths (``PRNGKey(seed + i)``
and ``PRNGKey(crc32(uid) & 0x7FFFFFFF)``).  The tolerance: XLA's f32
``erf_inv``, ``log1p`` and ``log`` are emulated step by step
(``random.truncated_normal``), and a fused multiply-add emulated through
f64 may round differently at a double-rounding tie."""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static

from learning_at_home_tpu.models.layers import make_expert as jax_make_expert
from learning_at_home_tpu.server.server import Server as JaxServer
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.models.layers import (
    flax_param_key,
    lecun_std,
    make_expert,
    name_to_block,
)
from learning_at_home_tpu_torch.server.server import Server

H = 32
BLOCKS = sorted(name_to_block)
ULP_TOL = 2
SEED_PATHS = {
    "seed+i": lambda i: 11 + i,
    "crc32": lambda i: zlib.crc32(f"ffn.{i}.3".encode()) & 0x7FFFFFFF,
}


def ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in f32 units in the last place (same-sign values)."""
    assert got.dtype == want.dtype == np.float32
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


def compare(jparams, tparams) -> tuple[int, int]:
    """(elements bit for bit, elements) over every leaf; asserts the
    tolerance leaf by leaf."""
    same = total = 0
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for (path, want), got in zip(jleaves, tleaves):
        want = np.asarray(want)
        got = got.numpy()
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        d = ulps(got, want)
        assert d.max() <= ULP_TOL, (jax.tree_util.keystr(path), d.max())
        same += int((d == 0).sum())
        total += d.size
    return same, total


@pytest.mark.parametrize("path_name", sorted(SEED_PATHS))
@pytest.mark.parametrize("name", BLOCKS)
def test_every_leaf_within_2_ulp_of_flax(name, path_name):
    same = total = 0
    for i in range(2):
        seed = SEED_PATHS[path_name](i)
        _, jparams = jax_make_expert(name, H, jax.random.PRNGKey(seed))
        _, tparams = make_expert(name, H, jrandom.PRNGKey(seed),
                                 device="cpu")
        s, t = compare(jparams, tparams)
        same, total = same + s, total + t
    print(f"{name} [{path_name}]: {same}/{total} elements bit for bit "
          f"({same / total:.6f})")


@pytest.mark.parametrize("path_name", sorted(SEED_PATHS))
@pytest.mark.parametrize("name", BLOCKS)
def test_uniform_bits_of_each_kernel_equal_jax(name, path_name):
    """Each kernel's key is flax's (``_fold_in_static`` of its module path
    and counter 1), and the uniform draw under it is JAX's bit for bit."""
    seed = SEED_PATHS[path_name](0)
    _, jparams = jax_make_expert(name, H, jax.random.PRNGKey(seed))
    a = jax.lax.erf(jnp.float32(-2) / jnp.float32(np.sqrt(2)))
    kernels = [
        (tuple(k.key for k in path[1:-1]), leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)
        if path[-1].key == "kernel"
    ]
    assert kernels or name == "nop"
    for module_path, leaf in kernels:
        jkey = _fold_in_static(jax.random.PRNGKey(seed), module_path + (1,))
        tkey = flax_param_key(jrandom.PRNGKey(seed), module_path, 1)
        np.testing.assert_array_equal(
            tkey.numpy().astype(np.uint32),
            np.asarray(jax.random.key_data(jkey)
                       if jnp.issubdtype(jkey.dtype, jax.dtypes.prng_key)
                       else jkey))
        want = np.asarray(jax.random.uniform(jkey, leaf.shape, jnp.float32,
                                             minval=a, maxval=-a))
        got = jrandom.uniform(tkey, tuple(leaf.shape), minval=float(a),
                              maxval=float(-a)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("fan_in", [1, 3, 32, 96, 128, 2048])
def test_lecun_std_is_jax_f32(fan_in):
    variance = jnp.array(1.0 / fan_in, dtype=jnp.float32)
    want = jnp.array(np.sqrt(variance) / .87962566103423978, jnp.float32)
    assert np.float32(lecun_std(fan_in)) == np.asarray(want)


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
def test_truncated_normal_matches_jax(seed):
    shape = (3, 5000)
    want = np.asarray(jax.random.truncated_normal(
        jax.random.PRNGKey(seed), -2.0, 2.0, shape, jnp.float32))
    got = jrandom.truncated_normal(jrandom.PRNGKey(seed), -2.0, 2.0,
                                   shape).numpy()
    d = ulps(got, want)
    assert d.max() <= ULP_TOL
    print(f"seed {seed}: {(d == 0).mean():.6f} bit for bit")
    bound = np.nextafter(np.float32(2), np.float32(0))
    assert np.abs(got).max() <= bound


def test_server_create_matches_the_jax_servers_experts():
    """Both seed paths of Server.create, against the JAX package's."""
    uids = ["ffn.0.1", "ffn.3.2"]
    for kwargs in (dict(num_experts=2, seed=7, expert_prefix="ffn"),
                   dict(expert_uids=uids)):
        jsrv = JaxServer.create(expert_cls="ffn", hidden_dim=H, start=False,
                                **kwargs)
        tsrv = Server.create(expert_cls="ffn", hidden_dim=H, start=False,
                             device="cpu", **kwargs)
        try:
            assert sorted(jsrv.experts) == sorted(tsrv.experts)
            for uid in jsrv.experts:
                compare(jsrv.experts[uid].params, tsrv.experts[uid].params)
        finally:
            jsrv.shutdown()
            tsrv.shutdown()


def test_the_draw_runs_on_the_keys_device():
    key = jrandom.PRNGKey(3)
    out = jrandom.truncated_normal(key, -2.0, 2.0, (4,))
    assert out.device == key.device and out.dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        jrandom.truncated_normal(key, -2.0, 2.0, (4,), torch.bfloat16)
