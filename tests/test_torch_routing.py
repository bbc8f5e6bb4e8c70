"""The port's training-time routing against the JAX package on the same
numpy inputs: router jitter (its noise bit for bit), jittered top-k
gating, expert-choice gating with its dispatch and combine, the MoE layer
in both modes, a 2-layer model's ``value_and_grad`` and one
fused-Adafactor train step in both modes, and remat ``"dots"``.

Tolerances: routing decisions (slots, ``token_for_slot``) are compared
exactly; weights and outputs to 1e-6 / 1e-5 (the two CPU softmaxes differ
in the last bit); model losses to 1e-5 relative and gradients to 2e-5
absolute, the bars of ``tests/test_torch_train_step.py``."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from learning_at_home_tpu.models.transformer import (
    DMoETransformerConfig as JaxConfig,
    DMoETransformerLM as JaxLM,
)
from learning_at_home_tpu.ops import moe_dispatch as jmd
from learning_at_home_tpu.ops.fused_adafactor import (
    fused_adafactor as jax_fused_adafactor,
)
from learning_at_home_tpu.parallel.mesh import make_mesh
from learning_at_home_tpu.parallel.sharded_moe import (
    ShardedMixtureOfExperts as JaxMoE,
)
from learning_at_home_tpu_torch.convert import params_from_jax, params_to_jax
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.ops import moe_dispatch as tmd
from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.parallel.sharded_moe import (
    ShardedMixtureOfExperts as TorchMoE,
)
from learning_at_home_tpu_torch.tree import tree_leaves

GRAD_ATOL = 2e-5
# the 2-layer training model: the flagship recipe in miniature (tuple
# layout, remat, fused CE), vocab 2048, d 128, 4 experts, batch 8 x 16
SMALL = dict(vocab_size=2048, d_model=128, n_layers=2, n_heads=4, seq_len=16,
             num_experts=4, k=2, ce_chunk=64, dtype=jnp.float32,
             stack_layers=False, scan_layers=False, remat=True,
             ce_impl="fused")
MODES = {
    # bench.py's balanced-routing recipe
    "jitter": dict(router_jitter=0.1, aux_loss_weight=5e-2),
    "expert_choice": dict(gating="expert_choice"),
}
_TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True)
def _full_precision_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


# ---- router jitter ----


@pytest.mark.parametrize("shape", [(64, 8), (7, 5), (300, 256)])
@pytest.mark.parametrize("salt", [0, 1, 3])
def test_router_jitter_matches_jax_bitwise(shape, salt):
    rs = np.random.RandomState(salt)
    gates = rs.rand(*shape).astype(np.float32)
    want = _np(jmd.router_jitter(jnp.asarray(gates), 0.1, salt))
    got = tmd.router_jitter(_t(gates), 0.1, salt)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # a salt given as an int32 tensor, as JAX's traced layer index
    traced = jax.jit(lambda s: jmd.router_jitter(jnp.asarray(gates), 0.1, s))(
        jnp.int32(salt))
    got_t = tmd.router_jitter(_t(gates), 0.1, torch.tensor(salt, dtype=torch.int32))
    np.testing.assert_array_equal(got_t.numpy().view(np.int32),
                                  _np(traced).view(np.int32))
    assert tmd.router_jitter(_t(gates), 0.0, salt) is not None
    np.testing.assert_array_equal(tmd.router_jitter(_t(gates), 0.0).numpy(),
                                  gates)


def test_router_jitter_salt_decorrelates_layers():
    """Each salt draws its own deterministic pattern (the counterpart of
    the JAX package's test of the same name)."""
    gates = _t(np.random.RandomState(3).rand(64, 8).astype(np.float32))
    a0 = tmd.router_jitter(gates, 0.3, salt=0)
    a0_again = tmd.router_jitter(gates, 0.3, salt=0)
    a1 = tmd.router_jitter(gates, 0.3, salt=1)
    assert torch.equal(a0, a0_again)
    assert not torch.allclose(a0, a1)


def _jitter_logits(seed, n=64, e=16, dup=True):
    rs = np.random.RandomState(seed)
    logits = rs.randn(n, e).astype(np.float32)
    if dup:  # near-identical rows: the ties jitter exists to split
        logits[n // 2:] = rs.randn(1, e).astype(np.float32) * 0.01
    return logits


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capacity", [4, 12])
def test_jittered_gating_matches_jax(capacity, masked):
    """Both gating forms: slots exact, weights to 1e-6; the noise splits
    the duplicate rows' ties (fewer drops than without it)."""
    logits = _jitter_logits(capacity)
    mask = None
    if masked:
        mask = np.random.RandomState(1).rand(64) > 0.2
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    kw = dict(jitter=0.1, jitter_salt=2)
    ji = jmd.top_k_gating_indices(jnp.asarray(logits), 2, capacity,
                                  token_mask=jm, **kw)
    ti = tmd.top_k_gating_indices(_t(logits), 2, capacity, token_mask=tm, **kw)
    np.testing.assert_array_equal(ti.token_for_slot.numpy(),
                                  _np(ji.token_for_slot))
    np.testing.assert_array_equal(ti.slot_for_token.numpy(),
                                  _np(ji.slot_for_token))
    np.testing.assert_allclose(ti.weights.numpy(), _np(ji.weights),
                               atol=1e-6, rtol=1e-6)
    jp = jmd.top_k_gating(jnp.asarray(logits), 2, capacity, token_mask=jm, **kw)
    tp = tmd.top_k_gating(_t(logits), 2, capacity, token_mask=tm, **kw)
    np.testing.assert_array_equal(tp.dispatch.numpy(), _np(jp.dispatch))
    np.testing.assert_allclose(tp.combine.numpy(), _np(jp.combine),
                               atol=1e-6, rtol=1e-6)
    for t_plan, j_plan in ((ti, ji), (tp, jp)):
        np.testing.assert_allclose(float(t_plan.aux_loss),
                                   float(j_plan.aux_loss), rtol=1e-6)
        assert float(t_plan.dropped_fraction) == pytest.approx(
            float(j_plan.dropped_fraction), abs=1e-7)
    clean = tmd.top_k_gating_indices(_t(logits), 2, capacity, token_mask=tm)
    assert float(ti.dropped_fraction) < float(clean.dropped_fraction)
    # the weights are the clean gates at the chosen experts, renormalised
    gates = torch.softmax(_t(logits), dim=-1)
    kept = (ti.slot_for_token >= 0).all(dim=1)
    chosen = torch.gather(gates, 1,
                          (ti.slot_for_token.clamp(min=0) // capacity).long())
    want = chosen / chosen.sum(dim=1, keepdim=True)
    torch.testing.assert_close(ti.weights[kept], want[kept])


# ---- expert choice ----


def _ec_logits(seed, n=24, e=4):
    logits = np.random.RandomState(seed).randn(n, e).astype(np.float32)
    logits[7] = logits[3]  # equal affinities: the lower token goes first
    logits[15] = logits[3]
    return logits


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capacity", [5, 12, 40])
def test_expert_choice_gating_matches_jax(capacity, masked):
    """token_for_slot exact (ties to the lower index, masked padding tied
    at -1 in bulk), weights to 1e-6, the uncovered fraction; capacity 40
    is clamped to the 24 tokens."""
    logits = _ec_logits(capacity)
    mask = None
    if masked:
        mask = np.random.RandomState(2).rand(24) > 0.4
        mask[3] = True
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    jp = jmd.expert_choice_gating(jnp.asarray(logits), capacity, jm)
    tp = tmd.expert_choice_gating(_t(logits), capacity, tm)
    assert tuple(tp.token_for_slot.shape) == (4, min(capacity, 24))
    assert tp.token_for_slot.dtype == torch.int32
    np.testing.assert_array_equal(tp.token_for_slot.numpy(),
                                  _np(jp.token_for_slot))
    np.testing.assert_allclose(tp.weights.numpy(), _np(jp.weights),
                               atol=1e-6, rtol=1e-6)
    assert float(tp.uncovered_fraction) == pytest.approx(
        float(jp.uncovered_fraction), abs=1e-7)
    if masked:  # padding is picked only past the real tokens, at weight 0
        picked_pad = ~_t(mask)[tp.token_for_slot.long()]
        assert (tp.weights[picked_pad] == 0).all()
        assert picked_pad.any() == (capacity > int(mask.sum()))


def test_expert_choice_dispatch_and_combine_match_jax():
    n, e, c, d = 32, 4, 8, 16
    rs = np.random.RandomState(1)
    logits = rs.randn(n, e).astype(np.float32)
    x = rs.randn(n, d).astype(np.float32)
    scale = (np.arange(e, dtype=np.float32) + 1)[:, None, None]
    jp = jmd.expert_choice_gating(jnp.asarray(logits), c)
    jy = jmd.combine_outputs_expert_choice(
        jmd.dispatch_tokens_expert_choice(jnp.asarray(x), jp) * scale, jp, n)
    tx = _t(x).requires_grad_(True)
    tl = _t(logits).requires_grad_(True)
    tp = tmd.expert_choice_gating(tl, c)
    xs = tmd.dispatch_tokens_expert_choice(tx, tp)
    np.testing.assert_array_equal(
        xs.detach().numpy(),
        _np(jmd.dispatch_tokens_expert_choice(jnp.asarray(x), jp)))
    ty = tmd.combine_outputs_expert_choice(xs * _t(scale), tp, n)
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), atol=1e-6,
                               rtol=1e-6)

    w = rs.randn(n, d).astype(np.float32)

    def jloss(lg, xx):
        p = jmd.expert_choice_gating(lg, c)
        ys = jmd.dispatch_tokens_expert_choice(xx, p) * scale
        return (jmd.combine_outputs_expert_choice(ys, p, n) * w).sum()

    jgl, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(logits),
                                               jnp.asarray(x))
    gl, gx = torch.autograd.grad((ty * _t(w)).sum(), [tl, tx])
    np.testing.assert_allclose(gl.numpy(), _np(jgl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), _np(jgx), atol=1e-5, rtol=1e-5)


# ---- the MoE layer ----


def _moe_params(rng, d, e, f):
    return {
        "gate": rng.standard_normal((d, e)).astype(np.float32),
        "w1": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
        "b1": rng.standard_normal((e, f)).astype(np.float32) * 0.5,
        "w2": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32),
        "b2": rng.standard_normal((e, d)).astype(np.float32) * 0.5,
    }


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", [dict(router_jitter=0.1, dispatch_impl="gather"),
                                  dict(router_jitter=0.1, dispatch_impl="onehot"),
                                  dict(gating="expert_choice")],
                         ids=["jitter-gather", "jitter-onehot", "expert_choice"])
def test_moe_layer_new_modes_match_jax(mode, masked):
    """Forward, aux scalars and the gradients of the gate, every expert
    weight and the tokens, with salt 3."""
    d, e, n = 16, 4, 24
    rng = np.random.default_rng(5)
    params = _moe_params(rng, d, e, 4 * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((n, d)).astype(np.float32)
    mask = (rng.random(n) > 0.25) if masked else None
    kw = dict(hidden_dim=d, num_experts=e, k=2, capacity_factor=1.0,
              dtype=jnp.float32, **mode)
    jmoe = JaxMoE(make_mesh({"expert": 1}, devices=jax.devices()[:1]), **kw)
    tmoe = TorchMoE(**{**kw, "dtype": torch.float32})
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(p, xx):
        y, aux = jmoe(p, xx, jitter_salt=3, token_mask=jmask)
        return (y * w).sum() + aux["aux_loss"] + aux["router_z_loss"], (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(a) for k, a in params.items()}, jnp.asarray(x))
    tp = {k: _t(a).requires_grad_(True) for k, a in params.items()}
    tx = _t(x).requires_grad_(True)
    ty, taux = tmoe(tp, tx, jitter_salt=3,
                    token_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), atol=1e-5,
                               rtol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key].detach()), float(jaux[key]),
                                   atol=1e-6, rtol=1e-5, err_msg=key)
    if "gating" in mode:
        assert float(taux["aux_loss"]) == 0.0
    loss = (ty * _t(w)).sum() + taux["aux_loss"] + taux["router_z_loss"]
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    for name, g in zip([*tp, "x"], grads):
        want = _np(jgx) if name == "x" else _np(jgp[name])
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


# ---- the model and its train step ----


def torch_config(jcfg: JaxConfig) -> DMoETransformerConfig:
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = _TORCH_DTYPES[jcfg.dtype]
    fields["param_dtype"] = _TORCH_DTYPES[jcfg.param_dtype]
    return DMoETransformerConfig(**fields)


class Pair:
    def __init__(self, **over):
        self.jcfg = JaxConfig(**{**SMALL, **over})
        mesh = make_mesh({"expert": 1}, devices=jax.devices()[:1])
        self.jmodel = JaxLM(self.jcfg, mesh)
        self.np_params = jax.tree_util.tree_map(
            np.asarray, self.jmodel.init_params(jax.random.PRNGKey(0)))
        self.tcfg = torch_config(self.jcfg)
        self.tmodel = DMoETransformerLM(self.tcfg, device="cpu")

    def jparams(self):
        return jax.tree_util.tree_map(jnp.asarray, self.np_params)

    def tparams(self):
        return params_from_jax(self.np_params, self.tcfg, device="cpu")


def _batch(seed, batch=8):
    rs = np.random.RandomState(seed)
    shape = (batch, SMALL["seq_len"])
    return (rs.randint(0, SMALL["vocab_size"], shape).astype(np.int32),
            rs.randint(0, SMALL["vocab_size"], shape).astype(np.int32))


def _assert_tree_close(got, want, atol, rtol=0.0, what="leaf"):
    flat_g, tdef_g = jax.tree_util.tree_flatten(got)
    flat_w, tdef_w = jax.tree_util.tree_flatten(want)
    assert tdef_g == tdef_w
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {i}")


@contextlib.contextmanager
def _routing_log():
    """Records every top-k expert choice [n, k] in call order."""
    own = tmd._top_k
    chosen = []

    def top_k(x, k):
        w, i = own(x, k)
        chosen.append(i)
        return w, i

    tmd._top_k = top_k
    try:
        yield chosen
    finally:
        tmd._top_k = own


@pytest.mark.parametrize("mode", list(MODES))
def test_model_value_and_grad_and_train_step_match_jax(mode):
    """A 2-layer model: loss, metrics and every gradient leaf, then one
    fused-Adafactor step's loss and parameters, against JAX on converted
    params.  Under jitter each layer routes with its own salt, and remat's
    recompute routes exactly as the forward did."""
    pair = Pair(**MODES[mode])
    ids, tgt = _batch(1)
    fn = jax.jit(jax.value_and_grad(pair.jmodel.loss_fn, has_aux=True))
    (jl, jm), jg = fn(pair.jparams(), jnp.asarray(ids), jnp.asarray(tgt))
    with _routing_log() as chosen:
        (tl, tm), tg = pair.tmodel.value_and_grad(
            pair.tparams(), torch.from_numpy(ids), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    _assert_tree_close(params_to_jax(tg, pair.tcfg),
                       jax.tree_util.tree_map(np.asarray, jg), GRAD_ATOL,
                       what="grad")
    n_layers = SMALL["n_layers"]
    if mode == "jitter":
        # the forward's layers, then their recompute from the last layer
        assert len(chosen) == 2 * n_layers
        for fwd, again in zip(chosen[:n_layers], chosen[:n_layers - 1:-1]):
            assert torch.equal(fwd, again)
        assert not torch.equal(chosen[0], chosen[1])  # salts differ
    else:
        assert float(tm["aux_loss"]) == 0.0 and not chosen

    jstep = pair.jmodel.make_train_step(jax_fused_adafactor(1e-3))
    jp = pair.jparams()
    jp, _, jloss, _ = jstep(jp, pair.jmodel.init_opt_state(
        jax_fused_adafactor(1e-3), jp), jnp.asarray(ids), jnp.asarray(tgt))
    opt = fused_adafactor(1e-3)
    tp = pair.tparams()
    tp, _, tloss, _ = pair.tmodel.make_train_step(opt)(
        tp, pair.tmodel.init_opt_state(opt, tp), torch.from_numpy(ids),
        torch.from_numpy(tgt))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_tree_close(params_to_jax(tp, pair.tcfg),
                       jax.tree_util.tree_map(np.asarray, jp), 1e-6, 1e-5,
                       what="param")


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["plain"] + list(MODES))
def test_remat_dots_gives_the_gradients_of_full_and_of_none(mode):
    """``"dots"`` equals ``"full"`` bit for bit and no remat to the
    existing remat bar, and it really saves the products: it runs exactly
    as many matrix products as no remat, ``"full"`` runs each layer's
    again."""
    over = MODES.get(mode, {})
    pair = Pair(**over)
    ids, tgt = (torch.from_numpy(a) for a in _batch(2))
    params = pair.tparams()
    out = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(pair.tcfg, remat=policy != "none",
                                  remat_policy="full" if policy == "none"
                                  else policy)
        with _CountMM() as counter:
            (loss, metrics), grads = DMoETransformerLM(
                cfg, device="cpu").value_and_grad(params, ids, tgt)
        out[policy] = (loss, metrics, tree_leaves(grads), counter.mm)
    assert torch.equal(out["dots"][0], out["full"][0])
    for key in out["full"][1]:
        assert torch.equal(out["dots"][1][key], out["full"][1][key]), key
    for a, b in zip(out["dots"][2], out["full"][2]):
        assert torch.equal(a, b)
    assert out["dots"][0] == pytest.approx(float(out["none"][0]), rel=1e-6)
    for a, b in zip(out["dots"][2], out["none"][2]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    assert out["dots"][3] == out["none"][3] < out["full"][3]
