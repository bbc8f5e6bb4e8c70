"""The port's initialisers against the JAX package's draws for one key.

The experts: every parameter leaf of every
block of the expert zoo, drawn for one key, within 2 f32 ulp of what the
JAX package's ``make_expert`` draws for that key (on these draws: bit for
bit), for both of ``Server.create``'s seed paths (``PRNGKey(seed + i)``
and ``PRNGKey(crc32(uid) & 0x7FFFFFFF)``).  The tolerance: XLA's f32
``erf_inv``, ``log1p`` and ``log`` are emulated step by step
(``random.truncated_normal``), and a fused multiply-add emulated through
f64 may round differently at a double-rounding tie.

The model trunks: every leaf of pod mode's ``init_params`` (stacked and
tuple layouts, f32 and bf16 params), the sharded MoE's, the swarm trunk's
and the swarm gate's, within the same bar (bf16: see the pod test)."""

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
    half = jrandom.truncated_normal(key, -2.0, 2.0, (4,), torch.bfloat16)
    assert half.device == key.device and half.dtype == torch.bfloat16
    # f32 and bf16 only: the two types whose draws are held against JAX's
    with pytest.raises(TypeError, match="float32"):
        jrandom.truncated_normal(key, -2.0, 2.0, (4,), torch.float16)


# ---- the model trunks: pod mode, the sharded MoE, the swarm trunk, its gate


def _bits(a: np.ndarray) -> np.ndarray:
    """The bits of an f32 or bf16 array as int64, ordered like the values
    of one sign."""
    width = {4: np.int32, 2: np.int16}[a.dtype.itemsize]
    return a.view(width).astype(np.int64)


def compare_any(jtree, ttree, bf16_ulps: int = 0) -> tuple[int, int]:
    """Leaf by leaf: f32 leaves within ``ULP_TOL`` f32 ulp, bf16 leaves
    within ``bf16_ulps`` bf16 ulp; (elements bit for bit, elements)."""
    same = total = 0
    jleaves = jax.tree_util.tree_leaves_with_path(jtree)
    tleaves = jax.tree_util.tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for (path, want), got in zip(jleaves, tleaves):
        want = np.asarray(want)
        if isinstance(got, torch.Tensor):
            got = (got.float().numpy().astype(want.dtype)
                   if got.dtype == torch.bfloat16 else got.numpy())
        name = jax.tree_util.keystr(path)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        tol = ULP_TOL if want.dtype == np.float32 else bf16_ulps
        d = np.abs(_bits(got) - _bits(want))
        assert d.max() <= tol, (name, d.max())
        same += int((d == 0).sum())
        total += d.size
    return same, total


def test_normal_is_jax_normal():
    """``random.normal`` against ``jax.random.normal``: f32 within the
    2-ulp bar, bf16 equal."""
    for seed in range(3):
        for shape in ((7,), (33, 65)):
            key = jax.random.PRNGKey(seed)
            want = np.asarray(jax.random.normal(key, shape))
            got = jrandom.normal(jrandom.PRNGKey(seed), shape).numpy()
            assert np.abs(_bits(got) - _bits(want)).max() <= ULP_TOL
            want = np.asarray(jax.random.normal(key, shape, jnp.bfloat16))
            got = jrandom.normal(jrandom.PRNGKey(seed), shape,
                                 torch.bfloat16).float().numpy()
            assert np.array_equal(got.astype(want.dtype), want)


POD_TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                seq_len=16, num_experts=4, k=2)
POD_LAYOUTS = {
    "stacked-f32": dict(),
    "tuple-untied-f32": dict(stack_layers=False, scan_layers=False,
                             tie_embeddings=False),
    # flagship-train's param_dtype
    "stacked-bf16": dict(param_dtype="bf16"),
}


@pytest.mark.parametrize("layout", sorted(POD_LAYOUTS))
def test_pod_trunk_every_leaf_is_jax_draw(layout):
    """Pod mode's ``init_params(key)`` against the JAX package's for the
    same key, every leaf (the sharded MoE's included).  bf16 leaves: XLA
    on the CPU draws them through f32 and may keep a product in f32 where
    the port rounds it to bf16 first, so a leaf may sit 1 bf16 ulp off;
    on these draws it does not."""
    from learning_at_home_tpu.models.transformer import (
        DMoETransformerConfig as JaxConfig,
        DMoETransformerLM as JaxLM,
    )
    from learning_at_home_tpu.parallel.mesh import make_mesh
    from learning_at_home_tpu_torch.convert import params_to_jax
    from learning_at_home_tpu_torch.models.transformer import (
        DMoETransformerConfig,
        DMoETransformerLM,
    )

    over = dict(POD_LAYOUTS[layout])
    pdt = over.pop("param_dtype", "f32")
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if pdt == "bf16"
                else (jnp.float32, torch.float32))
    jcfg = JaxConfig(**POD_TINY, dtype=jnp.float32, param_dtype=jdt, **over)
    mesh = make_mesh({"expert": 1}, devices=jax.devices()[:1])
    jparams = JaxLM(jcfg, mesh).init_params(jax.random.PRNGKey(5))
    tcfg = DMoETransformerConfig(**POD_TINY, dtype=torch.float32,
                                 param_dtype=tdt, **over)
    tparams = DMoETransformerLM(tcfg, device="cpu").init_params(
        jrandom.PRNGKey(5))
    same, total = compare_any(jparams, params_to_jax(tparams, tcfg),
                              bf16_ulps=1)
    print(f"pod {layout}: {same}/{total} elements bit for bit")


def test_sharded_moe_is_jax_draw():
    from learning_at_home_tpu.parallel.mesh import make_mesh
    from learning_at_home_tpu.parallel.sharded_moe import (
        ShardedMixtureOfExperts as JaxMoE,
    )
    from learning_at_home_tpu_torch.parallel.sharded_moe import (
        ShardedMixtureOfExperts,
    )

    mesh = make_mesh({"expert": 1}, devices=jax.devices()[:1])
    jp = JaxMoE(mesh, hidden_dim=16, num_experts=4, k=2).init_params(
        jax.random.PRNGKey(9))
    tp = ShardedMixtureOfExperts(hidden_dim=16, num_experts=4,
                                 k=2).init_params(jrandom.PRNGKey(9))
    compare_any(jp, tp)


def test_swarm_trunk_and_gate_are_jax_draw():
    """The swarm trunk's ``init_params(key)`` (gates included) and a
    ``RemoteMixtureOfExperts``'s ``init_gate_params(key)``."""
    from learning_at_home_tpu.client.moe import (
        RemoteMixtureOfExperts as JaxMoE,
    )
    from learning_at_home_tpu.client.routing import (
        StaticExpertSource as JaxSource,
    )
    from learning_at_home_tpu.models.transformer_swarm import (
        SwarmDMoETransformerLM as JaxSwarmLM,
        SwarmTransformerConfig as JaxSwarmConfig,
    )
    from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
    from learning_at_home_tpu_torch.client.routing import StaticExpertSource
    from learning_at_home_tpu_torch.convert import swarm_params_to_jax
    from learning_at_home_tpu_torch.models.transformer_swarm import (
        SwarmDMoETransformerLM,
        SwarmTransformerConfig,
    )

    kw = dict(vocab_size=40, d_model=16, n_layers=2, n_heads=2, seq_len=8,
              grid_size=(4, 3), uid_prefix="ip")
    jparams = JaxSwarmLM(JaxSwarmConfig(**kw), JaxSource({})).init_params(
        jax.random.PRNGKey(7))
    tcfg = SwarmTransformerConfig(**kw)
    tparams = SwarmDMoETransformerLM(tcfg, StaticExpertSource({})) \
        .init_params(jrandom.PRNGKey(7), device="cpu")
    compare_any(jparams, swarm_params_to_jax(tparams, tcfg))

    mk = dict(in_features=24, grid_size=(5, 3, 2), uid_prefix="g")
    jgate = JaxMoE(**mk, source=JaxSource({})).init_gate_params(
        jax.random.PRNGKey(4))
    tgate = RemoteMixtureOfExperts(**mk, source=StaticExpertSource({})) \
        .init_gate_params(jrandom.PRNGKey(4))
    compare_any(jgate, tgate)
