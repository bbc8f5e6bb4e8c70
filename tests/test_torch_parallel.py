"""The port's pod tier on a mesh against the JAX package's on its virtual
mesh: the sharded MoE, the model's forward and its decoders.

One port test for each test of ``tests/test_parallel.py`` (the training
ones are in ``test_torch_parallel_train.py``).  The JAX side runs on the
first devices of the 8-device virtual CPU mesh of ``tests/conftest.py``;
the port runs the same axes as spawned ``gloo`` ranks on the CPU
(``parallel/launch.RankGroup``, one group of each size per module, reused;
every wait bounded; 4 ranks, the smallest world with two axes of 2, where
the JAX test's mesh has 8 devices), each rank computing what its JAX
shard computes from the same numpy inputs and the JAX params sliced per
rank (``convert.params_from_jax(..., mesh=)``).  A mesh of one rank runs
in this process without a process group.

Tolerances (f32 on both sides, the same math in other summation orders):
outputs and logits within 2e-5 absolute (the single-device model tests'
bar, ``test_torch_transformer.py``); gradients within 2e-5 of the leaf's
largest magnitude plus 1e-4 relative (a gradient sums over every token,
each rank's share then summed over the mesh); greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from torch_mesh_oracle import jax_mesh
from learning_at_home_tpu.parallel import (
    ShardedMixtureOfExperts as JaxMoE,
    batch_sharding as jax_batch_sharding,
    make_mesh as jax_make_mesh,
)
from learning_at_home_tpu_torch.parallel.launch import RankGroup
from learning_at_home_tpu_torch.parallel.sharded_moe import expert_param_specs
from learning_at_home_tpu_torch.parallel.mesh import (
    P,
    batch_sharding,
    make_mesh,
    mesh_layout,
    shard_slices,
)

ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
TIMEOUT_S = 120.0

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def ranks():
    """``ranks(n)``: this module's group of n gloo ranks (made at first
    use, closed at the module's end)."""
    torch.set_num_threads(1)
    # the 4 ranks start while the module's first test builds its JAX side
    groups = {4: RankGroup(4, timeout_s=TIMEOUT_S, wait=False)}

    def get(n):
        if n not in groups:
            groups[n] = RankGroup(n, timeout_s=TIMEOUT_S)
        return groups[n]

    yield get
    for g in groups.values():
        g.close()


def dense_mixture(params, x):
    """The JAX test's reference: a full softmax mixture over all experts."""
    gates = jax.nn.softmax(np.asarray(x) @ params["gate"], axis=-1)
    h = (np.einsum("nd,edf->enf", np.asarray(x), params["w1"])
         + params["b1"][:, None])
    h = np.asarray(jax.nn.gelu(jnp.asarray(h)))
    ye = np.einsum("enf,efd->end", h, params["w2"]) + params["b2"][:, None]
    return np.einsum("ne,end->nd", gates, ye)


def assert_grads_close(got: dict, want: dict):
    for name in want:
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(
            got[name], w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(1.0, float(np.abs(w).max())), err_msg=name)


def run_moe(ranks, axes, jax_kw, port_kw, x, loss=None, params=None,
            key=0):
    """The JAX MoE and the port's ranks on the same params and tokens:
    (jax y, jax aux, jax grads or None, port y assembled, port aux of
    rank 0, port grads assembled)."""
    n = int(np.prod(list(axes.values())))
    jmoe = JaxMoE(jax_mesh(axes), **jax_kw)
    if params is None:
        params = jax.device_get(jmoe.init_params(jax.random.PRNGKey(key)))
    jy, jaux = jax.jit(jmoe.__call__)(params, jnp.asarray(x))
    jgrads = None
    if loss is not None:
        def f(p):
            y, aux = jmoe(p, jnp.asarray(x))
            out = (y ** 2).mean()
            if loss == "sq_mean_aux":
                return out + 0.01 * aux["aux_loss"]
            return out

        jgrads = jax.device_get(jax.jit(jax.grad(f))(params))
    outs = ranks(n).run(R.moe, axes, port_kw, params, np.asarray(x), loss)
    layout = mesh_layout(axes, 0)
    axes_d = tuple(a for a in axes if a in ("data", "expert"))
    # each token shard's rows, from the first rank of the shard
    shards = {}
    for r, (y, _, _) in enumerate(outs):
        lay = mesh_layout(axes, r)
        shards.setdefault(lay.index(axes_d), y)
    py = np.concatenate([shards[i] for i in range(layout.size(axes_d))])
    pgrads = None
    if loss is not None:
        specs = expert_param_specs(layout.size("model"))
        names = list(params)
        full = R.assemble([[o[2][k] for k in names] for o in outs],
                          [specs[k] for k in names], axes)
        pgrads = dict(zip(names, full))
    return (np.asarray(jy), {k: float(v) for k, v in jaux.items()}, jgrads,
            py, outs[0][1], pgrads, params)


def test_sharded_moe_matches_dense_full_routing(ranks):
    """data 2 x expert 2, every token to every expert (k = E, capacity
    factor E): the port's ranks give the JAX output and the dense
    mixture, and drop nothing."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (32, 16)))
    kw = dict(hidden_dim=16, num_experts=8, k=8, capacity_factor=8.0,
              dtype=jnp.float32)
    jy, jaux, _, py, paux, _, params = run_moe(
        ranks, {"data": 2, "expert": 2}, kw, dict(kw, dtype=torch.float32), x)
    np.testing.assert_allclose(py, jy, atol=ATOL)
    np.testing.assert_allclose(py, dense_mixture(params, x), atol=1e-5)
    assert paux["dropped_fraction"] == jaux["dropped_fraction"] == 0.0


def test_sharded_moe_1d_expert_mesh(ranks):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, 8)))
    kw = dict(hidden_dim=8, num_experts=16, k=16, capacity_factor=16.0,
              dtype=jnp.float32)
    jy, _, _, py, _, _, params = run_moe(
        ranks, {"expert": 4}, kw, dict(kw, dtype=torch.float32), x)
    np.testing.assert_allclose(py, jy, atol=ATOL)
    np.testing.assert_allclose(py, dense_mixture(params, x), atol=1e-5)


def test_sharded_moe_grads_flow_to_experts(ranks):
    """Gradients of (y²).mean() + 0.01 aux on data 2 x expert 2: the gate's
    summed over every token shard, the experts' over ``data`` only (the
    all-to-all's backward brings each expert its peers' cotangents) --
    against JAX's, leaf by leaf; each rank holds E/2 experts' slice."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 16)))
    kw = dict(hidden_dim=16, num_experts=8, k=2, dtype=jnp.float32)
    jy, _, jgrads, py, _, pgrads, _ = run_moe(
        ranks, {"data": 2, "expert": 2}, kw, dict(kw, dtype=torch.float32), x,
        loss="sq_mean_aux")
    np.testing.assert_allclose(py, jy, atol=ATOL)
    assert_grads_close(pgrads, jgrads)
    for name in ("gate", "w1", "w2"):
        assert np.abs(pgrads[name]).sum() > 0, name


def test_sharded_moe_tensor_parallel_matches_dense(ranks):
    """expert 2 x model 2: w1 split by columns and w2 by rows
    over ``model``; the ``psum`` of the partial products (b2 added after
    it) gives the JAX output, and Megatron's pair gives its gradients."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (32, 16)))
    kw = dict(hidden_dim=16, num_experts=4, k=4, capacity_factor=8.0,
              dtype=jnp.float32)
    jy, _, jgrads, py, _, pgrads, params = run_moe(
        ranks, {"expert": 2, "model": 2}, kw,
        dict(kw, dtype=torch.float32), x, loss="sq_mean")
    np.testing.assert_allclose(py, jy, atol=ATOL)
    np.testing.assert_allclose(py, dense_mixture(params, x), atol=1e-5)
    assert_grads_close(pgrads, jgrads)
    assert np.abs(pgrads["w2"]).sum() > 0


def test_capacity_drop_under_imbalance(ranks):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 8)))
    jmoe = JaxMoE(jax_mesh({"expert": 4}), hidden_dim=8, num_experts=8,
                  k=1, capacity_factor=1.0, dtype=jnp.float32)
    params = dict(jax.device_get(jmoe.init_params(jax.random.PRNGKey(0))))
    params["gate"] = np.zeros_like(params["gate"])
    params["gate"][:, 0] = 100.0
    kw = dict(hidden_dim=8, num_experts=8, k=1, capacity_factor=1.0)
    jy, jaux, _, py, paux, _, _ = run_moe(
        ranks, {"expert": 4}, dict(kw, dtype=jnp.float32),
        dict(kw, dtype=torch.float32), x, params=params)
    np.testing.assert_allclose(py, jy, atol=ATOL)
    assert paux["dropped_fraction"] == pytest.approx(jaux["dropped_fraction"])
    assert paux["dropped_fraction"] > 0.5
    assert (np.linalg.norm(py, axis=1) == 0).sum() >= 32


def test_host_local_array_to_global(ranks):
    """Each rank's rows are its JAX shard's: the port's slices of a batch
    under ``batch_sharding`` are the JAX sharding's device indices, with
    and without a ``seq`` axis, and under an explicit spec."""
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from learning_at_home_tpu_torch.parallel.multihost import (
        host_local_array_to_global,
    )

    cases = [({"data": 2, "expert": 4}, (16, 2), None),
             ({"data": 2, "expert": 2, "seq": 2}, (8, 4), None),
             ({"data": 2, "expert": 4}, (16, 2), ("data",))]
    for axes, shape, spec in cases:
        jmesh = jax_make_mesh(axes)
        jsh = (jax_batch_sharding(jmesh) if spec is None
               else NamedSharding(jmesh, JP(*spec)))
        index = jsh.devices_indices_map(shape)
        pspec = P(*spec) if spec is not None else None
        x = np.arange(np.prod(shape)).reshape(shape)
        for r, dev in enumerate(jmesh.devices.reshape(-1)):
            lay = mesh_layout(axes, r)
            want = x[index[dev]]
            sl = shard_slices(shape, pspec or batch_sharding(lay), lay)
            got = host_local_array_to_global(x[sl], lay, global_shape=shape,
                                             spec=pspec)
            np.testing.assert_array_equal(got.numpy(), want)
        if spec is None:
            assert batch_sharding(lay) == P(*jax_batch_sharding(jmesh).spec)
    lay = mesh_layout({"data": 2, "expert": 4}, 3)
    with pytest.raises(ValueError, match="shard"):
        host_local_array_to_global(np.zeros((16, 2)), lay,
                                   global_shape=(16, 2))


def test_sharded_moe_expert_choice_balanced_and_trains(ranks):
    """Expert choice on data 2 x expert 2: the JAX output, zero aux loss,
    and every expert's w1 gets a gradient.  (The model's training half is
    ``test_torch_parallel_train.py``'s test of the same name.)"""
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    kw = dict(hidden_dim=32, num_experts=8, k=2, gating="expert_choice")
    jy, jaux, _, py, paux, _, _ = run_moe(
        ranks, {"data": 2, "expert": 2}, dict(kw, dtype=jnp.float32),
        dict(kw, dtype=torch.float32), x)
    np.testing.assert_allclose(py, jy, atol=ATOL)
    assert paux["aux_loss"] == jaux["aux_loss"] == 0.0
    assert paux["dropped_fraction"] == pytest.approx(jaux["dropped_fraction"])
    outs = ranks(4).run(R.moe, {"data": 2, "expert": 2},
                        dict(kw, dtype=torch.float32),
                        jax.device_get(JaxMoE(
                            jax_mesh({"data": 2, "expert": 2}),
                            **dict(kw, dtype=jnp.float32)).init_params(
                                jax.random.PRNGKey(0))), x, "sum")
    for _, _, grads in outs:
        assert (np.abs(grads["w1"]).sum(axis=(1, 2)) > 0).all()


def test_expert_choice_rejects_router_jitter(ranks):
    msgs = ranks(4).run(R.moe_raises, {"expert": 4}, dict(
        hidden_dim=16, num_experts=8, gating="expert_choice",
        router_jitter=0.1))
    assert all(m is not None and "router_jitter" in m for m in msgs)


def test_attn_impl_auto_resolves_to_xla_on_cpu(ranks):
    kw = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, seq_len=16,
              num_experts=8, k=2, dtype=torch.float32)
    assert set(ranks(4).run(R.attn_impl, {"expert": 4},
                            dict(kw, attn_impl="auto"))) == {"xla"}
    assert set(ranks(4).run(R.attn_impl, {"expert": 4},
                            dict(kw, attn_impl="xla"))) == {"xla"}


def test_expert_choice_small_shard_capacity_clamps_through_moe(ranks):
    """8 tokens on expert 2 (two ranks): capacity 10 > 4 local tokens
    clamps to 4 through the all-to-all reshapes; the JAX output."""
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    kw = dict(hidden_dim=16, num_experts=2, k=2, gating="expert_choice")
    jy, _, _, py, paux, _, _ = run_moe(
        ranks, {"expert": 2}, dict(kw, dtype=jnp.float32),
        dict(kw, dtype=torch.float32), x)
    assert py.shape == x.shape
    np.testing.assert_allclose(py, jy, atol=ATOL)
    assert paux["dropped_fraction"] == 0.0


def test_mesh_of_one_rank_needs_no_process_group():
    """A mesh of one rank is the single-device model: no group, the
    collectives are identities."""
    mesh = make_mesh({"data": 1, "expert": 1}, device="cpu")
    assert mesh.world_size == 1 and mesh.group(("data", "expert")) is None
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh({"expert": 2}, device="cpu")
