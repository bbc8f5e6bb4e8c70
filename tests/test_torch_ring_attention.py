"""The port's ring attention against the JAX package's on its virtual mesh.

One port test for each test of ``tests/test_ring_attention.py``.  The JAX
side runs ``make_ring_attention`` on the 8-device virtual CPU mesh; the
port runs its ``make_ring_attention`` on spawned ``gloo`` CPU ranks (one
group of 8 for the module; a ring of n < 8 ranks runs on the mesh
``{"data": 8 // n, "seq": n}``, whose data peers compute the same ring),
every rank holding the global q, k, v as the JAX wrapper's arguments.

Tolerances: the JAX test's own (outputs 2e-5, gradients 3e-4 and, zigzag
against contiguous, 5e-5): both sides run the same online-softmax
recurrence in f32 over the same blocks, in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from learning_at_home_tpu.parallel.mesh import make_mesh as jax_make_mesh
from learning_at_home_tpu.parallel.ring_attention import (
    make_ring_attention as jax_ring,
)
from learning_at_home_tpu_torch.parallel.launch import RankGroup

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def ranks():
    torch.set_num_threads(1)
    group = RankGroup(8, timeout_s=120.0, wait=False)
    yield group
    group.close()


def dense_attention(q, k, v, causal):
    b, s, h, hd = q.shape
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    if causal:
        mask = np.tril(np.ones((s, s), bool))
        scores = np.where(mask, scores, -np.inf)
    p = jax.nn.softmax(jnp.asarray(scores), axis=-1)
    return np.einsum("bhqk,bkhd->bqhd", np.asarray(p), v)


def qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


def jax_out_and_grads(n, q, k, v, causal=True, layout="contiguous"):
    mesh = jax_make_mesh({"seq": n}, devices=jax.devices()[:n])
    ring = jax_ring(mesh, causal=causal, layout=layout)
    out = np.asarray(jax.jit(ring)(*map(jnp.asarray, (q, k, v))))
    grads = jax.jit(jax.grad(lambda a, b, c: (ring(a, b, c) ** 2).sum(),
                             argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_dense(ranks, causal):
    q, k, v = qkv(0, (2, 64, 4, 8))
    mesh = jax_make_mesh({"seq": 8})
    want = np.asarray(jax.jit(jax_ring(mesh, causal=causal))(
        *map(jnp.asarray, (q, k, v))))
    outs = ranks.run(R.ring, {"seq": 8}, q, k, v, causal)
    for out, _ in outs:
        np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(outs[0][0], dense_attention(q, k, v, causal),
                               atol=2e-5, rtol=2e-5)


def test_ring_attention_grads(ranks):
    """The gradient through the ppermute Function's inverse permutation:
    every rank gets the whole q, k, v gradient, the JAX ring's."""
    q, k, v = qkv(1, (1, 32, 2, 4))
    _, want = jax_out_and_grads(8, q, k, v)
    outs = ranks.run(R.ring, {"seq": 8}, q, k, v, True, "contiguous", True)
    for _, grads in outs:
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4)


def test_seq_parallel_transformer_matches_dense(ranks):
    """seq_parallel on data 2 x expert 2 x seq 2 against the plain model
    (no drops) and the JAX model's CE.  The port's row-sharded forward
    needs the 4 rows to divide over the token shards, so its plain model
    runs on data 2 x expert 2 x model 2 (the JAX test's data 2 x expert 4
    has 8): without drops the CE does not depend on the split."""
    from learning_at_home_tpu.models.transformer import (
        DMoETransformerConfig as JaxConfig,
        DMoETransformerLM as JaxLM,
    )

    base = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4,
                seq_len=16, num_experts=4, k=4, capacity_factor=8.0)
    jm = JaxLM(JaxConfig(**base, dtype=jnp.float32, seq_parallel=True),
               jax_make_mesh({"data": 2, "expert": 2, "seq": 2}))
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 64, (4, 16))
    tgt = rs.randint(0, 64, (4, 16))
    want = float(jax.jit(jm.loss_fn)(params, ids, tgt)[1]["ce"])
    kw = dict(base, dtype=torch.float32)
    sp = ranks.run(R.loss_and_grads, {"data": 2, "expert": 2, "seq": 2},
                   dict(kw, seq_parallel=True), params, ids, tgt, False)
    plain = ranks.run(R.loss_and_grads, {"data": 2, "expert": 2, "model": 2},
                      kw, params, ids, tgt, False)
    np.testing.assert_allclose(sp[0][1]["ce"], plain[0][1]["ce"], rtol=1e-5)
    np.testing.assert_allclose(sp[0][1]["ce"], want, rtol=1e-5)


def test_ring_long_sequence_memory_shape(ranks):
    q = np.random.RandomState(2).randn(1, 512, 2, 8).astype(np.float32)
    out, _ = ranks.run(R.ring, {"seq": 8}, q, q, q)[0]
    assert out.shape == (1, 512, 2, 8)
    assert np.isfinite(out).all()


def test_ring_validation_errors(ranks):
    axes = {"seq": 8}
    msgs = ranks.run(R.ring_raises, axes, [(1, 20, 2, 8)] * 3)
    assert all("divide" in m for m in msgs)
    msgs = ranks.run(R.ring_raises, axes, [(1, 8, 2, 8)] * 3,
                     axis_name="nope")
    assert all("no 'nope' axis" in m for m in msgs)
    msgs = ranks.run(R.ring_raises, axes,
                     [(1, 40, 2, 8), (1, 24, 2, 8), (1, 24, 2, 8)])
    assert all("must match" in m for m in msgs)


@pytest.mark.parametrize("n_seq", [1, 2, 4, 8])
def test_zigzag_matches_dense(ranks, n_seq):
    """The zigzag ring at every ring size (1..8 hit every mask branch,
    the single-rank diagonal-only ring included): the JAX zigzag ring's
    output and dense causal attention."""
    q, k, v = qkv(2, (2, 16 * n_seq, 3, 8))
    mesh = jax_make_mesh({"seq": n_seq}, devices=jax.devices()[:n_seq])
    want = np.asarray(jax.jit(jax_ring(mesh, causal=True, layout="zigzag"))(
        *map(jnp.asarray, (q, k, v))))
    outs = ranks.run(R.ring, {"data": 8 // n_seq, "seq": n_seq}, q, k, v,
                     True, "zigzag")
    for out, _ in outs:
        np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(outs[0][0], dense_attention(q, k, v, True),
                               atol=2e-5, rtol=2e-5)


def test_zigzag_matches_contiguous_and_grads(ranks):
    """seq 4: zigzag equals contiguous, and its gradients (both diagonal
    and off-diagonal steps' inverse permutations) the JAX zigzag ring's."""
    q, k, v = qkv(3, (1, 64, 2, 4))
    axes = {"data": 2, "seq": 4}
    zig = ranks.run(R.ring, axes, q, k, v, True, "zigzag", True)[0]
    cont = ranks.run(R.ring, axes, q, k, v, True, "contiguous", True)[0]
    np.testing.assert_allclose(zig[0], cont[0], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(zig[1][0], cont[1][0], atol=5e-5, rtol=5e-5)
    _, want = jax_out_and_grads(4, q, k, v, layout="zigzag")
    for a, b in zip(zig[1], want):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5)


def test_zigzag_rejects_bad_config(ranks):
    axes = {"data": 2, "seq": 4}
    msgs = ranks.run(R.ring_raises, axes, [(1, 8, 2, 4)] * 3, causal=False,
                     layout="zigzag")
    assert all("CAUSAL" in m for m in msgs)
    msgs = ranks.run(R.ring_raises, axes, [(1, 20, 2, 4)] * 3,
                     layout="zigzag")
    assert all(m is not None for m in msgs)
