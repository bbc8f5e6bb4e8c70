"""The port's training path against the JAX package: ``loss_fn`` (chunked
and fused CE, both layouts, tied and untied heads), per-layer remat, the
optimizers and ``make_train_step`` (with and without gradient
accumulation), and optimizer state carried across the two packages.

The model is the configuration of the JAX package's own fused-CE loss
test (``tests/test_ops.py``): vocab 2048, d 128, 1 layer, 4 heads, seq 16,
4 experts, top-2, batch 8, f32 compute, ``ce_chunk`` 64, on a one-device
mesh.  Inputs come from numpy seeds; parameters are the JAX init,
converted."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from learning_at_home_tpu.models.transformer import (
    DMoETransformerConfig as JaxConfig,
    DMoETransformerLM as JaxLM,
)
from learning_at_home_tpu.ops import fused_ce as jfce
from learning_at_home_tpu.ops.fused_adafactor import (
    FusedAdafactorState as JaxAdafactorState,
    fused_adafactor as jax_fused_adafactor,
)
from learning_at_home_tpu.parallel.mesh import make_mesh
from learning_at_home_tpu_torch.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.ops import fused_ce as tfce
from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.optim import adamw
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map

SMALL = dict(vocab_size=2048, d_model=128, n_layers=1, n_heads=4, seq_len=16,
             num_experts=4, k=2, ce_chunk=64)
LAYOUTS = {
    "stacked": dict(),
    "tuple": dict(stack_layers=False, scan_layers=False),
    "tuple-untied": dict(stack_layers=False, scan_layers=False,
                         tie_embeddings=False),
}
_TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
BATCH = 8
# f32 everywhere: the two packages sum in other orders, so gradients agree
# to ~1e-7 relative; 2e-5 absolute is the JAX package's own bar for the
# fused-vs-chunked gradient comparison
GRAD_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _full_precision_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_config(jcfg: JaxConfig) -> DMoETransformerConfig:
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = _TORCH_DTYPES[jcfg.dtype]
    fields["param_dtype"] = _TORCH_DTYPES[jcfg.param_dtype]
    return DMoETransformerConfig(**fields)


class Pair:
    """One small model in both packages, sharing converted params."""

    def __init__(self, layout="stacked", seed=0, **over):
        over.setdefault("dtype", jnp.float32)
        self.jcfg = JaxConfig(**{**SMALL, **LAYOUTS[layout], **over})
        mesh = make_mesh({"expert": 1}, devices=jax.devices()[:1])
        self.jmodel = JaxLM(self.jcfg, mesh)
        self.np_params = jax.tree_util.tree_map(
            np.asarray, self.jmodel.init_params(jax.random.PRNGKey(seed)))
        self.tcfg = torch_config(self.jcfg)
        self.tmodel = DMoETransformerLM(self.tcfg, device="cpu")

    def jparams(self):
        return jax.tree_util.tree_map(jnp.asarray, self.np_params)

    def tparams(self):
        return params_from_jax(self.np_params, self.tcfg, device="cpu")


def _batch(seed, lead=(BATCH,)):
    rs = np.random.RandomState(seed)
    shape = (*lead, SMALL["seq_len"])
    return (rs.randint(0, SMALL["vocab_size"], shape).astype(np.int32),
            rs.randint(0, SMALL["vocab_size"], shape).astype(np.int32))


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _assert_tree_close(got, want, atol, rtol=0.0, what="leaf"):
    flat_g, tdef_g = jax.tree_util.tree_flatten(got)
    flat_w, tdef_w = jax.tree_util.tree_flatten(want)
    assert tdef_g == tdef_w
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        assert np.asarray(g).shape == np.asarray(w).shape
        np.testing.assert_allclose(_f32(g), _f32(w), atol=atol, rtol=rtol,
                                   err_msg=f"{what} {i}")


def _count_calls(monkeypatch, module, names):
    calls = {name: 0 for name in names}
    for name in names:
        orig = getattr(module, name)

        def counting(*a, _o=orig, _n=name, **k):
            calls[_n] += 1
            return _o(*a, **k)

        monkeypatch.setattr(module, name, counting)
    return calls


def _jax_loss_and_grads(pair, ids, tgt):
    fn = jax.jit(jax.value_and_grad(pair.jmodel.loss_fn, has_aux=True))
    (loss, metrics), grads = fn(pair.jparams(), jnp.asarray(ids),
                                jnp.asarray(tgt))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _torch_loss_and_grads(pair, ids, tgt):
    (loss, metrics), grads = pair.tmodel.value_and_grad(
        pair.tparams(), torch.from_numpy(ids), torch.from_numpy(tgt))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("case", [
    dict(layout="stacked", ce_impl="chunked"),
    dict(layout="stacked", ce_impl="fused"),
    dict(layout="tuple-untied", ce_impl="chunked"),
    dict(layout="tuple-untied", ce_impl="fused"),
    dict(layout="tuple", ce_impl="fused", remat=True),
    # sub-chunk remainder: 128 tokens in chunks of 48 (48 + 48 + 32)
    dict(layout="stacked", ce_impl="chunked", ce_chunk=48),
    # one chunk holds every token
    dict(layout="tuple", ce_impl="chunked", ce_chunk=1024),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_loss_fn_matches_jax(monkeypatch, case):
    case = dict(case)
    pair = Pair(case.pop("layout"), **case)
    ids, tgt = _batch(1)
    jcalls = _count_calls(monkeypatch, jfce, ["fused_softmax_ce"])
    tcalls = _count_calls(monkeypatch, tfce,
                          ["ce_forward", "ce_dx", "ce_dhead"])
    jl, jm, jg = _jax_loss_and_grads(pair, ids, tgt)
    tl, tm, tg = _torch_loss_and_grads(pair, ids, tgt)
    fused = case["ce_impl"] == "fused"
    # the fused path really ran in both packages (or in neither), so the
    # parity is not vacuous
    assert (jcalls["fused_softmax_ce"] > 0) == fused
    untied = pair.tcfg.tie_embeddings is False
    assert tcalls == ({"ce_forward": 1, "ce_dx": 1, "ce_dhead": 1} if fused
                      else {"ce_forward": 0, "ce_dx": 0, "ce_dhead": 0}), \
        (tcalls, untied)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tm) == set(jm) == {"ce", "aux_loss", "router_z_loss",
                                  "dropped_fraction"}
    for key in jm:
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-7)
    _assert_tree_close(params_to_jax(tg, pair.tcfg),
                       jax.tree_util.tree_map(np.asarray, jg), GRAD_ATOL,
                       what="grad")


def test_fused_falls_back_to_chunked_when_the_kernels_refuse(monkeypatch):
    """80 tokens: n % ce_block_n != 0, so both packages run the chunked
    CE and no kernel is called."""
    pair = Pair("stacked", ce_impl="fused")
    ids, tgt = (a[:5] for a in _batch(2))
    tcalls = _count_calls(monkeypatch, tfce, ["ce_forward"])
    jcalls = _count_calls(monkeypatch, jfce, ["fused_softmax_ce"])
    jl, _, jg = _jax_loss_and_grads(pair, ids, tgt)
    tl, _, tg = _torch_loss_and_grads(pair, ids, tgt)
    assert tcalls["ce_forward"] == jcalls["fused_softmax_ce"] == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_tree_close(params_to_jax(tg, pair.tcfg),
                       jax.tree_util.tree_map(np.asarray, jg), GRAD_ATOL)


@pytest.mark.parametrize("ce_impl", ["chunked", "fused"])
def test_remat_gives_the_same_loss_and_grads(ce_impl):
    ids, tgt = _batch(3)
    plain = Pair("tuple", ce_impl=ce_impl)
    remat = DMoETransformerLM(dataclasses.replace(plain.tcfg, remat=True),
                              device="cpu")
    l0, m0, g0 = _torch_loss_and_grads(plain, ids, tgt)
    plain.tmodel = remat
    l1, m1, g1 = _torch_loss_and_grads(plain, ids, tgt)
    assert l0 == pytest.approx(l1, rel=1e-6) and m0 == pytest.approx(m1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_remat_policies():
    """"dots" gives "full"'s loss and gradients bit for bit (more cases in
    test_torch_routing.py); an unknown policy is refused."""
    ids, tgt = (torch.from_numpy(a) for a in _batch(3))
    pair = Pair("tuple", ce_impl="fused", remat=True)
    params = pair.tparams()
    full = pair.tmodel.value_and_grad(params, ids, tgt)
    dots = DMoETransformerLM(dataclasses.replace(pair.tcfg, remat_policy="dots"),
                             device="cpu").value_and_grad(params, ids, tgt)
    assert torch.equal(dots[0][0], full[0][0])
    for a, b in zip(tree_leaves(dots[1]), tree_leaves(full[1])):
        assert torch.equal(a, b)
    base = DMoETransformerConfig(**SMALL, remat=True)
    with pytest.raises(ValueError, match="remat_policy"):
        DMoETransformerLM(dataclasses.replace(base, remat_policy="some"),
                          device="cpu")
    # remat off: the policy is not read, as in the JAX package
    DMoETransformerLM(dataclasses.replace(base, remat=False,
                                          remat_policy="dots"), device="cpu")


# ---- optimizers on their own ----


def _opt_tree(rng, dtype):
    """Leaves that take both Adafactor branches: factored matrices (incl.
    a stacked 3-D one) and unfactored vectors / small matrices."""
    shapes = {"w": (256, 128), "stack": (2, 128, 384), "b": (128,),
              "small": (4, 64)}
    return {k: rng.standard_normal(s).astype(dtype) for k, s in shapes.items()}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return {k: (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("which", ["adamw", "fused_adafactor"])
def test_optimizer_updates_match_jax(which, dtype):
    rng = np.random.default_rng(0)
    params = _opt_tree(rng, dtype)
    grads = [_opt_tree(rng, dtype) for _ in range(3)]
    if which == "adamw":
        jopt, topt = optax.adamw(1e-3), adamw(1e-3)
    else:
        jopt, topt = jax_fused_adafactor(1e-3), fused_adafactor(1e-3)
    jstate, tstate = jopt.init(_j(params)), topt.init(_tt(params))
    jp, tp = _j(params), _tt(params)
    for g in grads:
        ju, jstate = jopt.update(_j(g), jstate, jp)
        tu, tstate = topt.update(_tt(g), tstate, tp)
        jp = optax.apply_updates(jp, ju)
        tp = {k: (tp[k] + tu[k]).to(tp[k].dtype) for k in tp}
        for k in tp:
            assert tu[k].dtype == tp[k].dtype
            # f32: order of the reductions only; bf16: one rounding of
            # the stored update or moment
            tol = dict(atol=1e-7, rtol=1e-5) if dtype == np.float32 else \
                dict(atol=1e-6, rtol=2 ** -7)
            np.testing.assert_allclose(tu[k].float().numpy(), _f32(ju[k]),
                                       err_msg=k, **tol)
    assert int(tstate.count) == 3


# ---- the train step ----


def _run_jax_steps(pair, jopt, batches, accum_steps=1, state=None,
                   params=None):
    step = pair.jmodel.make_train_step(jopt, accum_steps)
    params = pair.jparams() if params is None else params
    state = pair.jmodel.init_opt_state(jopt, params) if state is None else state
    out = []
    for ids, tgt in batches:
        params, state, loss, metrics = step(params, state, jnp.asarray(ids),
                                            jnp.asarray(tgt))
        out.append((float(loss), {k: float(v) for k, v in metrics.items()}))
    return params, state, out


def _run_torch_steps(pair, topt, batches, accum_steps=1, state=None,
                     params=None):
    step = pair.tmodel.make_train_step(topt, accum_steps)
    params = pair.tparams() if params is None else params
    state = pair.tmodel.init_opt_state(topt, params) if state is None else state
    out = []
    for ids, tgt in batches:
        params, state, loss, metrics = step(params, state,
                                            torch.from_numpy(ids),
                                            torch.from_numpy(tgt))
        out.append((float(loss), {k: float(v) for k, v in metrics.items()}))
    return params, state, out


def _jax_state_fields(state):
    if isinstance(state, JaxAdafactorState):
        return tuple(state)
    return tuple(state[0])  # optax.adamw's chain: ScaleByAdamState first


TRAIN_CASES = {
    "adamw": dict(opt="adamw", layout="stacked", over=dict()),
    "adamw-accum2": dict(opt="adamw", layout="stacked", over=dict(),
                         accum=2),
    # the flagship recipe in miniature: tuple layout, remat, fused CE
    "adafactor": dict(opt="adafactor", layout="tuple",
                      over=dict(remat=True, ce_impl="fused")),
    "adafactor-accum2": dict(opt="adafactor", layout="tuple",
                             over=dict(remat=True, ce_impl="fused"), accum=2),
    "adafactor-bf16-params": dict(opt="adafactor", layout="tuple",
                                  over=dict(remat=True, ce_impl="fused",
                                            param_dtype=jnp.bfloat16)),
}


def _step_tolerances(opt, bf16=False):
    """(param, state) tolerances after two steps: ``tight`` for every
    element, or for all but a ``few`` (a fraction of each leaf, at least
    2) that must still be within ``loose``; ``norm`` is an absolute
    tolerance in units of the leaf's largest value.

    f32 Adafactor: summation order only.  bf16 params: the two packages'
    bf16 gradients differ by bf16 rounding, so a parameter may land one
    bf16 step (2^-8 relative) away and the f32 statistics stored in bf16
    a few roundings away.  AdamW divides each gradient by its own RMS
    plus eps = 1e-8: where |g| is near eps, the gradients' f32
    summation-order differences (up to ~2e-9 there) move that element's
    step by up to lr * 2e-9 / eps = 2e-4.  Those elements are a few in
    1e5; every other parameter meets the f32 bar.  Step 2's gradients are
    then taken at parameters that differ at those elements, so AdamW's
    moments agree normwise (measured ~5e-5 of each leaf's largest value;
    the bar is 1e-3), not elementwise."""
    if bf16:
        return (dict(tight=dict(atol=1e-6, rtol=2 ** -7)),
                dict(tight=dict(atol=1e-8, rtol=2 ** -5)))
    if opt == "adamw":
        return (dict(tight=dict(atol=1e-6, rtol=1e-5), few=1e-4,
                     loose=dict(atol=2e-4, rtol=0.0)),
                dict(norm=1e-3))
    return (dict(tight=dict(atol=1e-6, rtol=1e-5)),
            dict(tight=dict(atol=1e-9, rtol=1e-4)))


def _assert_step_close(got, want, tight=None, few=0.0, loose=None, norm=None,
                       what="leaf"):
    flat_g, tdef_g = jax.tree_util.tree_flatten(got)
    flat_w, tdef_w = jax.tree_util.tree_flatten(want)
    assert tdef_g == tdef_w
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape
        msg = f"{what} {i}"
        if norm is not None:
            np.testing.assert_allclose(g, w, atol=norm * np.abs(w).max(),
                                       rtol=0, err_msg=msg)
        elif not few:
            np.testing.assert_allclose(g, w, err_msg=msg, **tight)
        else:
            off = np.abs(g - w) > tight["atol"] + tight["rtol"] * np.abs(w)
            assert off.sum() <= max(few * off.size, 2), \
                f"{msg}: {int(off.sum())} of {off.size}"
            np.testing.assert_allclose(g[off], w[off], err_msg=msg, **loose)


def _optimizers(name):
    if name == "adamw":
        return optax.adamw(1e-3), adamw(1e-3)
    return jax_fused_adafactor(1e-3), fused_adafactor(1e-3)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_two_train_steps_match_jax(name):
    case = TRAIN_CASES[name]
    pair = Pair(case["layout"], **case["over"])
    accum = case.get("accum", 1)
    lead = (accum, BATCH) if accum > 1 else (BATCH,)
    batches = [_batch(10 + i, lead) for i in range(2)]
    jopt, topt = _optimizers(case["opt"])
    jp, js, jout = _run_jax_steps(pair, jopt, batches, accum)
    tp, ts, tout = _run_torch_steps(pair, topt, batches, accum)
    bf16 = case["over"].get("param_dtype") == jnp.bfloat16
    p_tol, s_tol = _step_tolerances(case["opt"], bf16)
    for (jl, jm), (tl, tm) in zip(jout, tout):
        np.testing.assert_allclose(tl, jl, rtol=1e-3 if bf16 else 1e-5)
        for key in jm:
            np.testing.assert_allclose(tm[key], jm[key],
                                       rtol=1e-3 if bf16 else 1e-5, atol=1e-7)
    _assert_step_close(params_to_jax(tp, pair.tcfg),
                       jax.tree_util.tree_map(np.asarray, jp), what="param",
                       **p_tol)
    got = opt_state_to_jax(ts, pair.tcfg)
    want = jax.tree_util.tree_map(np.asarray, _jax_state_fields(js))
    assert int(got[0]) == int(want[0]) == 2
    _assert_step_close(got[1:], want[1:], what="state", **s_tol)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_state_converted_after_one_step_continues_identically(opt):
    """JAX takes step 1; its params and optimizer state are converted and
    step 2 runs in both packages from the same state."""
    layout, over = ("stacked", {}) if opt == "adamw" else (
        "tuple", dict(ce_impl="fused"))
    pair = Pair(layout, **over)
    batches = [_batch(20), _batch(21)]
    jopt, topt = _optimizers(opt)
    jp1, js1, _ = _run_jax_steps(pair, jopt, batches[:1])
    np_p1 = jax.tree_util.tree_map(np.asarray, jp1)
    np_s1 = jax.tree_util.tree_map(np.asarray, js1)
    tp1 = params_from_jax(np_p1, pair.tcfg, device="cpu")
    ts1 = opt_state_from_jax(np_s1, pair.tcfg, device="cpu")
    # the conversion is bitwise both ways
    back = opt_state_to_jax(ts1, pair.tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_jax_state_fields(np_s1))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    jp2, js2, jout = _run_jax_steps(pair, jopt, batches[1:], state=js1,
                                    params=jp1)
    tp2, ts2, tout = _run_torch_steps(pair, topt, batches[1:], state=ts1,
                                      params=tp1)
    np.testing.assert_allclose(tout[0][0], jout[0][0], rtol=1e-5)
    p_tol, s_tol = _step_tolerances(opt)
    _assert_step_close(params_to_jax(tp2, pair.tcfg),
                       jax.tree_util.tree_map(np.asarray, jp2), what="param",
                       **p_tol)
    _assert_step_close(opt_state_to_jax(ts2, pair.tcfg)[1:],
                       jax.tree_util.tree_map(
                           np.asarray, _jax_state_fields(js2))[1:],
                       what="state", **s_tol)


def test_train_step_updates_in_place_and_validates_accum():
    pair = Pair("stacked")
    params = pair.tparams()
    leaf = params["embed"]
    before = leaf.clone()
    step = pair.tmodel.make_train_step(adamw(1e-3))
    opt_state = pair.tmodel.init_opt_state(adamw(1e-3), params)
    ids, tgt = (torch.from_numpy(a) for a in _batch(4))
    out, _, loss, metrics = step(params, opt_state, ids, tgt)
    assert out is params and out["embed"] is leaf
    assert not torch.equal(leaf, before)
    assert not leaf.requires_grad and loss.dim() == 0
    with pytest.raises(ValueError, match="microbatches"):
        pair.tmodel.make_train_step(adamw(1e-3), accum_steps=2)(
            params, opt_state, ids, tgt)
    with pytest.raises(ValueError, match="params"):
        adamw(1e-3).update(tree_map(torch.zeros_like, params), opt_state)
