"""The port's pod-tier gradients, optimizers and conversions on a mesh
against the JAX package's on its virtual mesh: every gradient leaf of the
model on data x expert, model and seq meshes, router jitter on the local
shape, optimizer state over shards, the sharded Adafactors against the
single-device ones, and parameter init and conversion per rank.

Set up as ``test_torch_parallel.py`` (spawned ``gloo`` CPU ranks, one
group of each size per module, 4 ranks; the JAX side on the first
devices of the 8-device virtual mesh).

Tolerances (f32 on both sides, summation order only): one loss within
1e-5 relative; losses over a few optimizer steps within 1e-4 relative;
gradients within 2e-5 of the leaf's largest magnitude plus 1e-4
relative.  The sharded Adafactor against the single-device one on the
same global gradients: the sums behind each statistic are taken in
another order (a slice's sum, then the all-reduce), 2^-24 relative per
term over at most 512 terms, which the EMA, rsqrt and the scale then
carry: states within 8 f32 ulp (4 measured), and each param within
2^-16 of its leaf's largest update (4.3e-6 measured; a statistic's error
scales a whole row or column of the update, so it is relative to the
update, not to the param).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as R
from torch_mesh_oracle import (
    TINY,
    jax_mesh,
    jax_model,
    jax_train,
    jax_value_and_grad,
)
from learning_at_home_tpu.parallel import ShardedMixtureOfExperts as JaxMoE
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as prng
from learning_at_home_tpu_torch.convert import (
    opt_state_from_jax,
    params_from_jax,
)
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.parallel.launch import RankGroup
from learning_at_home_tpu_torch.parallel.mesh import P
from learning_at_home_tpu_torch.tree import tree_leaves

TIMEOUT_S = 180.0
LOSS_RTOL = 1e-5
STEPS_RTOL = 1e-4
ULP_TOL = 8
UPDATE_RTOL = 2 ** -16

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


def test_opt_state_shardings_factored_optimizer(ranks):
    """adamw's mu/nu of the expert stacks take the params' specs; the
    Adafactor chain's reduced statistics are replicated (the JAX rule);
    one step of the chain: the JAX loss and the JAX state, assembled."""
    _, params = jax_model(DE)
    ids, _ = batch(2)
    want, _, jstate = jax_train(DE, optax.adafactor(1e-3), [(ids, ids)])
    adam_specs, fact_specs = ranks(4).run(R.opt_state_specs, DE,
                                          port_kw())[0]
    hits = [s for path, s in adam_specs
            if "moe" in path and path.split("/")[-1] != "gate"]
    assert hits and all(s[:2] == (None, "expert") for s in hits)
    for path, s in fact_specs:
        if path.split("/")[1] in ("v_row", "v_col") or "count" in path:
            assert s == (), (path, s)
    outs = ranks(4).run(R.opt_state_after, DE, port_kw(), params,
                        "adafactor", 1e-3, ids, ids)
    np.testing.assert_allclose(outs[0][0], want[0], rtol=LOSS_RTOL)
    got = R.assemble([o[1] for o in outs], outs[0][2], DE)
    want_tree = opt_state_from_jax(jax.device_get(jstate),
                                   DMoETransformerConfig(**port_kw()), "cpu")
    want_leaves = [t.numpy() for t in tree_leaves(want_tree)]
    assert len(got) == len(want_leaves)
    for a, b in zip(got, want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))



def test_router_jitter_draws_the_local_shape(ranks):
    """Router jitter under a mesh draws each shard's [n_local, E] noise
    (the JAX layer's key, inside shard_map): the JAX output with jitter
    0.5 on data 2 x expert 2, layer salt 3."""
    x = np.random.RandomState(4).randn(64, 16).astype(np.float32)
    jmoe = JaxMoE(jax_mesh(DE), hidden_dim=16, num_experts=8, k=2,
                  capacity_factor=1.0, dtype=jnp.float32, router_jitter=0.5)
    params = jax.device_get(jmoe.init_params(jax.random.PRNGKey(0)))
    jy, _ = jax.jit(jmoe.__call__)(params, jnp.asarray(x), 3)
    outs = ranks(4).run(R.moe, DE, dict(
        hidden_dim=16, num_experts=8, k=2, capacity_factor=1.0,
        dtype=torch.float32, router_jitter=0.5), params, x, None, 3)
    py = np.concatenate([outs[r][0] for r in range(4)])
    np.testing.assert_allclose(py, np.asarray(jy), atol=2e-5)


# ---- the sharded optimizers against the single-device ones ----

def ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", ["fused_adafactor", "adafactor"])
def test_sharded_adafactor_matches_single_device(ranks, name):
    """Expert-stack leaves at 128 experts on expert 2 x model 2: ``b1``
    [128, 256] factors over (E, f) so its ``v_col`` is a mean across
    experts spanning the shards; ``w1`` [128, 8, 256] splits f over
    ``model`` so its ``v_row`` sums over the model shards; the second
    step's gradient is 100x larger on one expert shard, so the block-RMS
    clip engages and is the whole leaf's.  Two steps: the states and the
    params against the single-device optimizer on the global gradients."""
    axes = {"expert": 2, "model": 2}
    rs = np.random.RandomState(5)
    params = {"b1": rs.randn(128, 256).astype(np.float32),
              "w1": rs.randn(128, 8, 256).astype(np.float32) * 0.1,
              "gate": rs.randn(8, 128).astype(np.float32)}
    specs = {"b1": P("expert", "model"), "w1": P("expert", None, "model"),
             "gate": P()}
    g1 = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    g2 = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    g2["b1"][:32] *= 100.0
    g2["w1"][:32] *= 100.0
    outs = ranks(4).run(R.optimizer_steps, axes, name, 1e-2, params, specs,
                        [g1, g2])
    single = R.make_optimizer(name, 1e-2)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = single.init(p)
    for g in (g1, g2):
        upd, state = single.update(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, state, p)
        p = optim.applied_updates(p, upd)
    names = list(params)
    got_p = R.assemble([[o[1][k] for k in names] for o in outs],
                       [specs[k] for k in names], axes)
    for k, got in zip(names, got_p):
        want = p[k].numpy()
        step = np.abs(want - params[k]).max()
        assert np.abs(got - want).max() <= UPDATE_RTOL * step, k
    want_state = [t.numpy() for t in tree_leaves(state)]
    # the factored stats are whole on every rank, the unfactored v a slice
    for i, want in enumerate(want_state):
        got = outs[0][0][i]
        if got.shape == want.shape and want.dtype == np.float32:
            assert ulps(got, want).max() <= ULP_TOL, i
    clipped = np.abs(p["b1"].numpy() - params["b1"]).max()
    assert clipped < 0.1  # the update was clipped on the whole leaf


# ---- init and conversion per rank ----

def test_init_params_slices_equal_the_single_device_draw(ranks):
    """Each rank's slices of ``init_params`` (expert 2 x model 2: expert
    stacks split over experts and the FFN dim) assemble to the
    single-device draw bit for bit (which the init parity tests hold
    against the JAX draw)."""
    axes = {"expert": 2, "model": 2}
    kw = port_kw(num_experts=4)
    outs = ranks(4).run(R.init_slices, axes, kw)
    specs = outs[0][1]
    got = R.assemble([o[0] for o in outs], specs, axes)
    single = DMoETransformerLM(DMoETransformerConfig(**kw), device="cpu")
    want = single.init_params(prng.PRNGKey(0))
    for a, b in zip(got, tree_leaves(want)):
        np.testing.assert_array_equal(a, b.numpy())
    assert outs[0][0]["layers"]["moe"]["w1"].shape == (2, 2, 32, 64)


def test_params_from_jax_per_rank_round_trips(ranks):
    """``params_from_jax(tree, cfg, mesh=axes, rank=r)`` for every rank
    assembles to the JAX tree bit for bit, the stacked and the tuple
    layouts; on the ranks, with their own mesh, the same slices."""
    axes = {"expert": 2, "model": 2}
    for stack in (True, False):
        jm, params = jax_model(axes, num_experts=4, stack_layers=stack,
                               scan_layers=stack)
        kw = port_kw(num_experts=4, stack_layers=stack, scan_layers=stack)
        cfg = DMoETransformerConfig(**kw)
        per_rank = [params_from_jax(params, cfg, "cpu", mesh=axes, rank=r)
                    for r in range(4)]
        on_ranks = ranks(4).run(R.convert_slices, axes, kw, params)
        for r in range(4):
            for a, b in zip(tree_leaves(per_rank[r]),
                            tree_leaves(on_ranks[r])):
                np.testing.assert_array_equal(a.numpy(), b)
        slices_specs = ranks(4).run(R.init_slices, axes, kw)[0][1]
        got = R.assemble([R.to_np(t) for t in per_rank], slices_specs, axes)
        for a, b in zip(got, tree_leaves(params_from_jax(params, cfg,
                                                         "cpu"))):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("axes,over", [
    ({"data": 2, "expert": 2}, {}),
    ({"expert": 2, "model": 2}, {"num_experts": 4}),
    ({"expert": 2, "seq": 2},
     {"seq_parallel": True, "capacity_factor": 8.0}),
], ids=["data-expert", "model", "seq-zigzag"])
def test_mesh_gradients_match_jax(ranks, axes, over):
    """Every gradient leaf of ``value_and_grad`` on the mesh against JAX's
    ``jax.grad(loss_fn)`` on the same mesh: the reduction groups (the
    replicated leaves over every token axis, the expert stacks over
    ``data`` and ``seq`` only, the ``model`` splits not at all), the
    Megatron pair and, on ``seq``, the ring's and the MoE gather's
    backward.  The loss within 1e-5; each leaf within 2e-5 of its largest
    magnitude plus 1e-4 relative."""
    _, params = jax_model(axes, **over)
    ids, tgt = batch(6, (4 if "seq" in axes or "model" in axes else 8, 16))
    jloss, jgrads = jax_value_and_grad(axes, params, ids, tgt, **over)
    outs = ranks(4).run(R.loss_and_grads, axes, port_kw(**over), params, ids,
                        tgt)
    np.testing.assert_allclose(outs[0][0], float(jloss), rtol=LOSS_RTOL)
    specs = ranks(4).run(R.init_slices, axes, port_kw(**over))[0][1]
    got = R.assemble([o[2] for o in outs], specs, axes)
    cfg = DMoETransformerConfig(**port_kw(**over))
    want = tree_leaves(params_from_jax(jax.device_get(jgrads), cfg, "cpu"))
    for a, b in zip(got, want):
        b = b.numpy()
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=2e-5 * max(1.0, float(np.abs(b).max())))


def test_opt_state_from_jax_per_rank():
    """``opt_state_from_jax(state, cfg, mesh=axes, rank=r)`` on data 2 x
    expert 2 x model 2: every leaf is rank r's slice, under
    ``opt_state_shardings``' spec, of the single-device conversion, bit for
    bit: adamw's mu and nu of the expert stacks split, the Adafactor
    chain's reduced statistics whole."""
    from learning_at_home_tpu_torch.parallel.mesh import (
        local_shard,
        mesh_layout,
        opt_state_shardings,
    )

    axes = {"data": 2, "expert": 2, "model": 2}
    jm, params = jax_model(axes, num_experts=4)
    cfg = DMoETransformerConfig(**port_kw(num_experts=4))
    whole_params = params_from_jax(params, cfg, "cpu")
    specs = DMoETransformerLM(cfg, device="cpu", mesh=mesh_layout(
        axes, 0)).param_specs(whole_params)
    for opt in (optax.adamw(1e-3), optax.adafactor(1e-3)):
        state = jax.device_get(jm.init_opt_state(opt, params))
        rs = np.random.RandomState(8)
        state = jax.tree_util.tree_map(
            lambda x: (np.asarray(x) + rs.rand(*np.shape(x))).astype(
                np.float32) if np.asarray(x).dtype == np.float32
            else np.asarray(x), state)
        whole = opt_state_from_jax(state, cfg, "cpu")
        state_specs = tree_leaves(opt_state_shardings(whole, specs,
                                                      whole_params))
        assert any("expert" in tuple(sp) for sp in state_specs)
        for r in range(8):
            got = tree_leaves(opt_state_from_jax(state, cfg, "cpu",
                                                 mesh=axes, rank=r))
            lay = mesh_layout(axes, r)
            for g, w, sp in zip(got, tree_leaves(whole), state_specs):
                np.testing.assert_array_equal(
                    g.numpy(), local_shard(w, sp, lay).numpy())


def test_fused_ce_runs_on_each_ranks_rows(ranks):
    """``ce_impl="fused"`` on data 2 x expert 2 (d 128, vocab 1024 and row
    tiles of 16, which the kernels' preconditions need): each rank runs
    the fused CE once on its own 32 tokens (the JAX ``shard_map`` branch;
    its plain versions here, K1-K3 on the card), and the loss and every
    gradient leaf, the tied head's per-rank K3 share summed over the mesh
    among them, equal the JAX chunked CE's on the same mesh (the same
    tolerance as the other gradients); with a ``seq`` axis the chunked CE
    runs."""
    over = dict(d_model=128, vocab_size=1024)
    _, params = jax_model(DE, **over)
    rs = np.random.RandomState(9)
    ids = rs.randint(0, 1024, (8, 16))
    tgt = rs.randint(0, 1024, (8, 16))
    jloss, jgrads = jax_value_and_grad(DE, params, ids, tgt, **over)
    kw = port_kw(ce_impl="fused", ce_block_n=16, **over)
    outs = ranks(4).run(R.loss_and_grads_counting_fused_ce, DE, kw, params,
                        ids, tgt)
    assert all(o[3] == [32] for o in outs), [o[3] for o in outs]
    np.testing.assert_allclose(outs[0][0], jloss, rtol=LOSS_RTOL)
    specs = ranks(4).run(R.init_slices, DE, kw)[0][1]
    got = R.assemble([o[2] for o in outs], specs, DE)
    cfg = DMoETransformerConfig(**kw)
    for a, b in zip(got, tree_leaves(params_from_jax(jgrads, cfg, "cpu"))):
        b = b.numpy()
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=2e-5 * max(1.0, float(np.abs(b).max())))
    seq = {"expert": 2, "seq": 2}
    _, sp_params = jax_model(seq, seq_parallel=True, **over)
    outs = ranks(4).run(R.loss_and_grads_counting_fused_ce, seq,
                        dict(kw, seq_parallel=True), sp_params, ids[:4],
                        tgt[:4])
    assert all(o[3] == [] for o in outs)
