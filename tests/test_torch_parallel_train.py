"""The port's pod-tier training on a mesh against the JAX package's on its
virtual mesh: train steps, gradient accumulation, the chunked CE, remat,
the zigzag layout and expert choice.

The training tests of ``tests/test_parallel.py``, one port test each (the
gradients, optimizers and conversions are ``test_torch_parallel_grads.py``).
Set up as ``test_torch_parallel.py`` (spawned ``gloo`` CPU ranks, one
group of 4 for the module; the JAX side on the first devices of the
8-device virtual mesh).

Tolerances (f32 on both sides, summation order only): one loss within
1e-5 relative; losses over a few optimizer steps within 1e-4 relative
(the steps carry each step's last-bit differences forward; adamw divides
by sqrt(v) and amplifies them where a gradient is near 0); params after
one SGD step within 2e-5 relative and 2e-6 absolute (the JAX test's bar).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as R
from torch_mesh_oracle import TINY, jax_model, jax_train, jax_value_and_grad
from learning_at_home_tpu_torch.convert import params_from_jax
from learning_at_home_tpu_torch.models.transformer import DMoETransformerConfig
from learning_at_home_tpu_torch.parallel.launch import RankGroup
from learning_at_home_tpu_torch.tree import tree_leaves

TIMEOUT_S = 180.0
LOSS_RTOL = 1e-5
STEPS_RTOL = 1e-4

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

DE = {"data": 2, "expert": 2}


@pytest.fixture(scope="module")
def ranks():
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


def port_kw(**over):
    return {**TINY, "dtype": torch.float32, **over}


def batch(seed, shape=(8, 16)):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 64, shape), rs.randint(0, 64, shape)


def test_transformer_trains_and_keeps_shardings(ranks):
    """data 2 x expert 2, adamw, 4 steps on a fixed batch: the JAX losses;
    each rank keeps its E/2 experts' slice."""
    _, params = jax_model(DE)
    ids, tgt = batch(0)
    want, _, _ = jax_train(DE, optax.adamw(1e-3), [(ids, tgt)] * 4)
    outs = ranks(4).run(R.train, DE, port_kw(), params, "adamw", 1e-3,
                        [(ids, tgt)] * 4)
    losses, _, local = outs[0]
    np.testing.assert_allclose(losses, want, rtol=STEPS_RTOL)
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert all(o[0] == losses for o in outs)
    assert local["layers"]["moe"]["w1"].shape == (2, 4, 32, 128)


def test_grad_accumulation_matches_mean_of_micro_grads(ranks):
    """accum_steps 2 on data 2 x expert 2 with SGD: the JAX model's update
    with the mean of the two microbatches' gradients."""
    _, params = jax_model(DE)
    rs = np.random.RandomState(7)
    ids = rs.randint(0, 64, (2, 8, 16))
    tgt = rs.randint(0, 64, (2, 8, 16))
    g0 = jax_value_and_grad(DE, params, ids[0], tgt[0])[1]
    g1 = jax_value_and_grad(DE, params, ids[1], tgt[1])[1]
    ref = jax.tree_util.tree_map(
        lambda p, a, b: np.asarray(p) - np.float32(1e-2) * (a + b) / 2,
        params, g0, g1)
    outs = ranks(4).run(R.train, DE, port_kw(), params, "sgd", 1e-2,
                        [(ids, tgt)], accum_steps=2)
    specs = ranks(4).run(R.init_slices, DE, port_kw())[0][1]
    got = R.assemble([o[2] for o in outs], specs, DE)
    want = params_from_jax(ref, DMoETransformerConfig(**port_kw()), "cpu")
    for a, b in zip(tree_leaves(want), got):
        np.testing.assert_allclose(b, a.numpy(), rtol=2e-5, atol=2e-6)
    assert 0.0 <= outs[0][1]["dropped_fraction"] <= 1.0


def test_chunked_ce_matches_full_logits(ranks):
    """The chunked CE of each rank's 32 tokens at chunks of 16 (divisible),
    12 (a remainder chunk) and 128 (one chunk): the full-logits loss of
    the JAX model's forward, within 1e-5; finite gradients."""
    jm, params = jax_model(DE)
    ids, tgt = batch(3)
    logits, aux = jax.jit(jm.apply)(params, jnp.asarray(ids))
    ce = optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(tgt)).mean()
    cfg = jm.cfg
    ref = float(ce + cfg.aux_loss_weight * aux["aux_loss"]
                + cfg.router_z_weight * aux["router_z_loss"])
    for chunk in (16, 12, 128):
        outs = ranks(4).run(R.loss_and_grads, DE, port_kw(ce_chunk=chunk),
                            params, ids, tgt)
        assert abs(outs[0][0] - ref) < 1e-5, chunk
        assert all(np.isfinite(l).all() for l in tree_leaves(outs[0][2]))


def test_transformer_remat_matches(ranks):
    _, params = jax_model(DE)
    ids, tgt = batch(1, (8, 16))
    want = jax_value_and_grad(DE, params, ids, tgt)[0]
    plain = ranks(4).run(R.loss_and_grads, DE, port_kw(), params, ids, tgt,
                         False)[0][0]
    remat = ranks(4).run(R.loss_and_grads, DE, port_kw(remat=True), params,
                         ids, tgt, False)[0][0]
    np.testing.assert_allclose(remat, plain, rtol=1e-5)
    np.testing.assert_allclose(plain, want, rtol=LOSS_RTOL)


def test_transformer_zigzag_matches_contiguous(ranks):
    """expert 2 x seq 2, no drops (capacity factor 8: dropping is
    token-order dependent and zigzag reorders tokens): the zigzag ring's
    loss equals the contiguous ring's and the JAX model's; a wrong
    sequence length fails loudly."""
    axes = {"expert": 2, "seq": 2}
    over = dict(seq_parallel=True, capacity_factor=8.0)
    _, params = jax_model(axes, seq_layout="zigzag", **over)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 64, (4, 16))
    tgt = rs.randint(0, 64, (4, 16))
    want = jax_value_and_grad(axes, params, ids, tgt, seq_layout="zigzag",
                              **over)[0]
    g = ranks(4)
    zig = g.run(R.loss_and_grads, axes, port_kw(seq_layout="zigzag", **over),
                params, ids, tgt, False)[0][0]
    cont = g.run(R.loss_and_grads, axes,
                 port_kw(seq_layout="contiguous", **over), params, ids, tgt,
                 False)[0][0]
    np.testing.assert_allclose(zig, cont, rtol=2e-5)
    np.testing.assert_allclose(zig, want, rtol=LOSS_RTOL)
    errs = g.run(R.raises, "apply", axes, port_kw(seq_layout="zigzag", **over),
                 params, rs.randint(0, 64, (4, 8)), replicated=True)
    assert all(e[0] == "ValueError" and "zigzag layout was built" in e[1]
               for e in errs)


def test_sharded_moe_expert_choice_balanced_and_trains(ranks):
    """The training half of the JAX test: the expert-choice model on
    data 2 x expert 2 trains (4 adamw steps), the JAX losses."""
    _, params = jax_model(DE, gating="expert_choice")
    ids, _ = batch(0)
    want, _, _ = jax_train(DE, optax.adamw(1e-3), [(ids, ids)] * 4,
                           gating="expert_choice")
    losses = ranks(4).run(R.train, DE, port_kw(gating="expert_choice"),
                          params, "adamw", 1e-3, [(ids, ids)] * 4)[0][0]
    np.testing.assert_allclose(losses, want, rtol=STEPS_RTOL)
    assert losses[-1] < losses[0]


