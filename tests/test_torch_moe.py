"""The port's routing (ops/moe_dispatch.py) and MoE layer
(parallel/sharded_moe.py) against the JAX package on the same numpy
inputs, on a one-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_at_home_tpu.ops import moe_dispatch as jmd
from learning_at_home_tpu.parallel.mesh import make_mesh
from learning_at_home_tpu.parallel.sharded_moe import (
    ShardedMixtureOfExperts as JaxMoE,
)
from learning_at_home_tpu_torch import random as prng
from learning_at_home_tpu_torch.ops import moe_dispatch as tmd
from learning_at_home_tpu_torch.parallel.sharded_moe import (
    ShardedMixtureOfExperts as TorchMoE,
)


@pytest.fixture(autouse=True)
def _full_precision_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,e,k,cf", [
    (8192, 256, 2, 1.25), (2, 256, 2, 1.25), (24, 8, 2, 1.25), (7, 3, 1, 2.0),
])
def test_capacity_and_dispatch_choice_match_jax(n, e, k, cf):
    cap = tmd.compute_capacity(n, e, k, cf)
    assert cap == jmd.compute_capacity(n, e, k, cf)
    for slots in (e * cap, 256, 20480, 4000, 9000):
        assert tmd.choose_dispatch_impl(n, slots) == jmd.choose_dispatch_impl(
            n, slots)
    # the serving path's two regimes: prefill gathers, decode goes one-hot
    assert tmd.choose_dispatch_impl(8192, 20480) == "gather"
    assert tmd.choose_dispatch_impl(2, 256) == "onehot"


def _routing_inputs(seed, tie, masked, n=24, e=8):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    if tie:
        logits[0, [2, 5]] = 4.0  # top-1 tie between experts 2 and 5
        logits[1, :] = 0.5  # every expert tied
        logits[2, [1, 6, 7]] = 3.0  # three-way tie: top-2 takes 1 and 6
    mask = None
    if masked:
        mask = rng.random(n) > 0.3
        mask[0] = True
    return logits, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("capacity", [2, 4, 9])
def test_gating_forms_match_jax(capacity, tie, masked):
    """Identical slots, drops and aux; weights to 1e-6 (the two CPU exps
    differ in the last bit).  Capacity 2 and 4 drop choices; padding
    claims no slot."""
    logits, mask = _routing_inputs(capacity, tie, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)

    jp = jmd.top_k_gating(jnp.asarray(logits), 2, capacity, token_mask=jmask)
    tp = tmd.top_k_gating(_t(logits), 2, capacity, token_mask=tmask)
    np.testing.assert_array_equal(tp.dispatch.numpy(), _np(jp.dispatch))
    np.testing.assert_allclose(tp.combine.numpy(), _np(jp.combine),
                               atol=1e-6, rtol=1e-6)

    ji = jmd.top_k_gating_indices(jnp.asarray(logits), 2, capacity,
                                  token_mask=jmask)
    ti = tmd.top_k_gating_indices(_t(logits), 2, capacity, token_mask=tmask)
    np.testing.assert_array_equal(ti.token_for_slot.numpy(),
                                  _np(ji.token_for_slot))
    np.testing.assert_array_equal(ti.slot_for_token.numpy(),
                                  _np(ji.slot_for_token))
    np.testing.assert_allclose(ti.weights.numpy(), _np(ji.weights),
                               atol=1e-6, rtol=1e-6)
    for t_plan, j_plan in ((tp, jp), (ti, ji)):
        np.testing.assert_allclose(float(t_plan.aux_loss),
                                   float(j_plan.aux_loss), rtol=1e-6)
        assert float(t_plan.dropped_fraction) == pytest.approx(
            float(j_plan.dropped_fraction), abs=1e-7)
    if capacity == 2:
        assert float(tp.dropped_fraction) > 0


def test_slot_claims_follow_token_order_and_skip_padding():
    # every token picks experts (0, 1); token 1 is padding
    top_i = torch.tensor([[0, 1], [0, 1], [1, 0], [0, 1]], dtype=torch.int32)
    valid = torch.tensor([True, False, True, True])
    pos = tmd._expert_positions(top_i, 2, valid)
    # choice 0 claims first in token order (expert 0: tokens 0, 3; expert
    # 1: token 2), then choice 1 continues the counts
    assert pos.tolist() == [[0, 1], [0, 0], [0, 2], [1, 2]]
    want = jmd._expert_positions(jnp.asarray(top_i.numpy()), 2,
                                 jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(pos.numpy(), _np(want))


@pytest.mark.parametrize("k", [2, 3, 6])
def test_top_k_ties_go_to_the_lower_index(k):
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5, 2.0, 1.0]], np.float32)
    jw, ji = jmd._top_k(jnp.asarray(x), k)
    tw, ti = tmd._top_k(_t(x), k)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(tw.numpy(), _np(jw))
    assert ti[0, :3].tolist()[: min(k, 3)] == [1, 2, 4][: min(k, 3)]


def _moe_params(rng, d, e, f):
    """Random params with non-zero biases, scaled so the expert
    pre-activations are O(1): there the tanh and erf forms of gelu differ
    by ~1e-3, far outside the 1e-5 tolerance."""
    return {
        "gate": rng.standard_normal((d, e)).astype(np.float32),
        "w1": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
        "b1": rng.standard_normal((e, f)).astype(np.float32) * 0.5,
        "w2": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32),
        "b2": rng.standard_normal((e, d)).astype(np.float32) * 0.5,
    }


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_moe_forward_matches_jax(impl, masked):
    d, e, n = 16, 4, 24
    rng = np.random.default_rng(7)
    params = _moe_params(rng, d, e, 4 * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    mask = (rng.random(n) > 0.25) if masked else None
    kw = dict(hidden_dim=d, num_experts=e, k=2, capacity_factor=1.0,
              dtype=jnp.float32, dispatch_impl=impl)
    jmoe = JaxMoE(make_mesh({"expert": 1}, devices=jax.devices()[:1]), **kw)
    kw["dtype"] = torch.float32
    tmoe = TorchMoE(**kw)

    # jit: eager shard_map runs op by op and costs seconds
    jy, jaux = jax.jit(lambda p, x, m: jmoe(p, x, token_mask=m))(
        {n_: jnp.asarray(a) for n_, a in params.items()}, jnp.asarray(x),
        None if mask is None else jnp.asarray(mask))
    ty, taux = tmoe({n_: _t(a) for n_, a in params.items()}, _t(x),
                    token_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    assert set(taux) == set(jaux) == {"aux_loss", "router_z_loss",
                                      "dropped_fraction"}
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   atol=1e-5, rtol=1e-5)
    if masked:  # padding gets no expert output
        assert torch.all(ty[~_t(mask)] == 0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_moe_gradients_match_jax(impl, masked):
    """Autograd through the port's routing gives JAX's gradients for the
    gate, every expert weight and the tokens: through the argmax-pass
    top-k weights, the renormalising clamp and (gather form) the masked
    gather.  Capacity factor 1.0 drops choices, so dropped and kept
    paths both carry gradients."""
    d, e, n = 16, 4, 24
    rng = np.random.default_rng(11)
    params = _moe_params(rng, d, e, 4 * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    mask = (rng.random(n) > 0.25) if masked else None
    w = rng.standard_normal((n, d)).astype(np.float32)  # output cotangent
    kw = dict(hidden_dim=d, num_experts=e, k=2, capacity_factor=1.0,
              dtype=jnp.float32, dispatch_impl=impl)
    jmoe = JaxMoE(make_mesh({"expert": 1}, devices=jax.devices()[:1]), **kw)
    kw["dtype"] = torch.float32
    tmoe = TorchMoE(**kw)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(p, x):
        y, aux = jmoe(p, x, token_mask=jmask)
        return ((y * w).sum() + aux["aux_loss"] + aux["router_z_loss"])

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(a) for k, a in params.items()}, jnp.asarray(x))
    tp = {k: _t(a).requires_grad_(True) for k, a in params.items()}
    tx = _t(x).requires_grad_(True)
    y, aux = tmoe(tp, tx, token_mask=None if mask is None else _t(mask))
    loss = (y * _t(w)).sum() + aux["aux_loss"] + aux["router_z_loss"]
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    assert float(tmoe(tp, tx)[1]["dropped_fraction"]) > 0
    for name, g in zip([*tp, "x"], grads):
        want = _np(jgx) if name == "x" else _np(jgp[name])
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_moe_init_params_layout():
    moe = TorchMoE(hidden_dim=8, num_experts=4, param_dtype=torch.float32)
    p = moe.init_params(prng.PRNGKey(0))
    assert {n: tuple(t.shape) for n, t in p.items()} == {
        "gate": (8, 4), "w1": (4, 8, 32), "b1": (4, 32),
        "w2": (4, 32, 8), "b2": (4, 8)}
    # pod mode's stacked layout: one key a layer, stacked
    stacked = {"w1": torch.stack([moe.init_params(k)["w1"] for k in
                                  prng.split(prng.PRNGKey(0), 3)])}
    assert stacked["w1"].shape == (3, 4, 8, 32)
    # lecun-normal: fan-in over the expert and input dims, truncated at 2 std
    std = (1.0 / (4 * 8)) ** 0.5 / 0.87962566103423978
    assert float(stacked["w1"].abs().max()) <= 2 * std + 1e-6


@pytest.mark.parametrize("kw", [dict(router_jitter=0.1),
                                dict(gating="expert_choice")])
def test_training_routing_is_refused(kw):
    """Training-time routing runs in the layer and gives the JAX layer's
    output and aux scalars (both modes in depth: test_torch_routing.py);
    only expert choice combined with jitter is refused, as in JAX."""
    d, e, n = 8, 4, 16
    rng = np.random.default_rng(3)
    params = _moe_params(rng, d, e, 4 * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    jmoe = JaxMoE(make_mesh({"expert": 1}, devices=jax.devices()[:1]),
                  hidden_dim=d, num_experts=e, dtype=jnp.float32, **kw)
    jy, jaux = jax.jit(lambda p, x: jmoe(p, x, jitter_salt=1))(
        {k: jnp.asarray(a) for k, a in params.items()}, jnp.asarray(x))
    moe = TorchMoE(hidden_dim=d, num_experts=e, dtype=torch.float32, **kw)
    ty, taux = moe({k: _t(a) for k, a in params.items()}, _t(x),
                   jitter_salt=1)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="router_jitter"):
        TorchMoE(hidden_dim=d, num_experts=e, gating="expert_choice",
                 router_jitter=0.1)
