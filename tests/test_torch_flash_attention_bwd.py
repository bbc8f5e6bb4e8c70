"""K5's backward in the port (``ops/flash_attention.py``: the
``FlashAttention`` autograd function, its plain backward, the dkv / dq
wrappers) against the JAX package's library flash kernel, and the
long-context train step through it against the JAX model.

The oracle is the library Pallas kernel itself, forward and custom-VJP
backward, run on the CPU under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()``.  Two limits
of that mode shape the tests: it does not compose with ``jax.checkpoint``
(interpret mode's callbacks carry an ordered effect that remat refuses),
so the JAX side always runs with ``remat=False``; and the library needs S
to be a multiple of its 128-row blocks, so a ragged S is held against
``impl="xla"`` instead.  Each interpret-mode call takes seconds, so the
file makes four.  On CPU tensors the port's wrappers run their plain
versions; the Hopper kernels themselves are tested on the card by
test_torch_flash_bwd_cuda.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning_at_home_tpu.models import trunk as jtrunk
from learning_at_home_tpu.models.transformer import (
    DMoETransformerConfig as JaxConfig,
    DMoETransformerLM as JaxLM,
)
from learning_at_home_tpu.ops.fused_adafactor import (
    fused_adafactor as jax_fused_adafactor,
)
from learning_at_home_tpu.parallel.mesh import make_mesh
from learning_at_home_tpu_torch.convert import params_from_jax, params_to_jax
from learning_at_home_tpu_torch.models import trunk as ttrunk
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.ops import flash_attention as fa
from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.tree import tree_leaves

SHAPE = (2, 256, 4, 64)  # [B, S, H, hd]: S a multiple of the library's 128


@pytest.fixture(autouse=True)
def _full_precision_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bf16_np(x):
    """numpy f32 values rounded to bf16, as the JAX side sees them."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, shape, dtype):
    """q, k, v and the upstream gradient, numpy f32 (bf16-representable
    for ``dtype == "bf16"``)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    return [_bf16_np(a) for a in arrays] if dtype == "bf16" else arrays


def _jax_vjp(impl, q, k, v, do, jdt):
    """``(o, [dq, dk, dv])`` of ``attention_core(q, k, v, impl)`` and its
    vjp at ``do`` under jit, as numpy f32; the library kernel in interpret
    mode for ``impl="flash"``."""
    def run(q, k, v, do):
        out, vjp = jax.vjp(
            lambda q, k, v: jtrunk.attention_core(q, k, v, impl=impl),
            q, k, v)
        return out, vjp(do)

    fn = jax.jit(run)
    args = [jnp.asarray(a, jdt) for a in (q, k, v, do)]
    if impl == "flash":
        with pltpu.force_tpu_interpret_mode():
            out, grads = fn(*args)
    else:
        out, grads = fn(*args)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@functools.lru_cache(maxsize=None)
def _library_case(dtype):
    """The numpy-seeded inputs at SHAPE and the library kernel's ``o`` and
    gradients for them: one interpret-mode call per dtype, shared by the
    tests that need it."""
    q, k, v, do = _inputs(0, SHAPE, dtype)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return (q, k, v, do), *_jax_vjp("flash", q, k, v, do, jdt)


def _torch_grads(q, k, v, do, tdt):
    """The port's flash_attention gradient on CPU tensors: the Function
    with its plain backward."""
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    out = ttrunk.attention_core(tq, tk, tv, impl="flash")
    assert isinstance(out.grad_fn, fa.FlashAttention._backward_cls)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    assert all(g.dtype == tdt for g in grads)
    return [g.float().numpy() for g in grads]


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


# f32: the two sides differ in the f32 summation order and in how p is
# formed (exp(s - lse) here, exp(s - m) / l in the library), ~4e-6 at
# this shape, so 1e-4.  bf16, end to end: each side's backward starts
# from its own forward's bf16 o, and the two o differ by an ulp here and
# there, which di = rowsum(o * do) carries into every ds of its row.  So
# two bf16 ulps of the gradient's largest value: one for the output's
# rounding, one for di's (the test below holds the backward alone to one).
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_grads_match_the_jax_library_kernel(dtype):
    (q, k, v, do), _, want = _library_case(dtype)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    got = _torch_grads(q, k, v, do, tdt)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        atol = 1e-4 if dtype == "f32" else 2 * _bf16_ulp(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)
        assert np.abs(w).max() > 0.5  # not a vacuous comparison


def test_bf16_backward_from_the_library_output_within_one_ulp():
    """The port's backward (``flash_attention_bwd``, the Function's
    backward) fed the library forward's own bf16 ``o``, so di is the
    library's up to f32 summation order: dq, dk and dv within one bf16 ulp
    of the gradient's largest value.  Both sides round p and ds to bf16
    from f32 values a hair apart (exp(s - lse) here, exp(s - m) / l in the
    library), which moves a sum by far less than an ulp; the outputs'
    rounding to bf16 then differs by at most one ulp."""
    (q, k, v, do), o, want = _library_case("bf16")
    tq, tk, tv, to, tdo = (torch.tensor(a, dtype=torch.bfloat16)
                           for a in (q, k, v, o, do))
    _, lse = fa.attention_fwd_reference(tq, tk, tv)
    got = fa.flash_attention_bwd(tq, tk, tv, to, lse, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=_bf16_ulp(np.abs(w).max()), rtol=0,
                                   err_msg=name)


def test_ragged_flash_grads_match_jax_plain_attention():
    """S = 200 is no multiple of the library's blocks; the port's kernels
    take any S, so its gradient is held against ``impl="xla"`` (f32, the
    same 1e-4 as above)."""
    q, k, v, do = _inputs(1, (1, 200, 2, 64), "f32")
    _, want = _jax_vjp("xla", q, k, v, do, jnp.float32)
    got = _torch_grads(q, k, v, do, torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 37, 3, 16), (1, 64, 2, 64)])
def test_plain_backward_is_the_gradient_of_plain_attention(shape):
    """``attention_bwd_reference`` in f64 against autograd through
    ``attention_reference`` in f64: the formula itself, to 1e-10."""
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape))
                   for _ in range(4))
    o, lse = fa.attention_fwd_reference(q, k, v)
    assert o.dtype == lse.dtype == torch.float64
    got = fa.attention_bwd_reference(q, k, v, o, lse, do)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_reference(*leaves), leaves, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, atol=1e-10, rtol=0)


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 3, 64)))
               for _ in range(3))
    _, lse = fa.attention_fwd_reference(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    causal = torch.ones(40, 40, dtype=torch.bool).tril()
    want = torch.logsumexp(scores.masked_fill(~causal, -torch.inf), -1)
    assert lse.shape == (2, 3, 40)
    torch.testing.assert_close(lse, want, atol=1e-12, rtol=0)


def test_the_function_is_on_the_path(monkeypatch):
    """attention_core(impl="flash") returns the Function's output on
    differentiable inputs: the gradients of q, k and v exist, are non-zero,
    and come from the dkv and dq wrappers (once each); the forward is
    bitwise the plain attention.  Without a gradient to take, no graph."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    wrappers = (fa.flash_attention, fa.flash_attention_dkv,
                fa.flash_attention_dq)
    launches = [fn.launches for fn in wrappers]
    calls = {"flash_attention_dkv": 0, "flash_attention_dq": 0}
    for name in calls:
        def counting(*a, _o=getattr(fa, name), _n=name):
            calls[_n] += 1
            return _o(*a)

        monkeypatch.setattr(fa, name, counting)
    out = ttrunk.attention_core(*leaves, impl="flash")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), fa.attention_reference(q, k, v))
    out.square().sum().backward()
    assert calls == {"flash_attention_dkv": 1, "flash_attention_dq": 1}
    for t in leaves:
        assert t.grad is not None and t.grad.abs().max() > 0
    # CPU tensors take the plain versions: no kernel was launched
    assert launches == [fn.launches for fn in wrappers]
    with torch.no_grad():
        assert ttrunk.attention_core(*leaves, impl="flash").grad_fn is None
    assert ttrunk.attention_core(q, k, v, impl="flash").grad_fn is None


def test_dkv_and_dq_wrappers_on_cpu_are_the_plain_backward():
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 33, 2, 64))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    di = fa._row_dot(o, do)
    want = fa.attention_bwd_reference(q, k, v, o, lse, do)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, di)
    dq = fa.flash_attention_dq(q, k, v, do, lse, di)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert fa.flash_attention_fwd(q, k, v, with_lse=False)[1] is None


# ---- the slice as a whole: long-context training through the Function ----

# The model of the slice in miniature: 2 layers, 4 heads of 64, seq_len
# 256, the fused CE and the per-layer tuple layout of the flagship recipe,
# f32 compute, flash attention, no remat on the JAX side (interpret mode
# refuses it).  Batch 2: 512 tokens, a multiple of the fused CE's blocks.
SLICE = dict(vocab_size=2048, d_model=256, n_layers=2, n_heads=4,
             seq_len=256, num_experts=4, k=2, dtype=jnp.float32,
             attn_impl="flash", remat=False, ce_impl="fused",
             stack_layers=False, scan_layers=False)
BATCH = 2
# f32 everywhere: the packages differ in summation order only (the
# attention gradients by ~4e-6, see above); 2e-5 is the JAX package's own
# bar for fused-vs-chunked gradients and the bar of test_torch_train_step.
GRAD_ATOL = 2e-5


def _torch_config(jcfg: JaxConfig) -> DMoETransformerConfig:
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = torch.float32
    fields["param_dtype"] = torch.float32
    return DMoETransformerConfig(**fields)


@pytest.fixture(scope="module")
def slice_pair():
    """The JAX model and its loss / grads / one fused-Adafactor step in
    interpret mode, on numpy-seeded params and batch (two interpret-mode
    calls)."""
    jcfg = JaxConfig(**SLICE)
    jmodel = JaxLM(jcfg, make_mesh({"expert": 1}, devices=jax.devices()[:1]))
    assert jmodel.cfg.attn_impl == "flash"
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(7)
    ids, tgt = (rs.randint(0, SLICE["vocab_size"], (BATCH, SLICE["seq_len"]))
                .astype(np.int32) for _ in range(2))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    opt = jax_fused_adafactor(1e-3)
    with pltpu.force_tpu_interpret_mode():
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(jparams, jnp.asarray(ids),
                                           jnp.asarray(tgt))
        step = jmodel.make_train_step(opt)
        p1, _, step_loss, _ = step(jparams, jmodel.init_opt_state(opt, jparams),
                                   jnp.asarray(ids), jnp.asarray(tgt))
    return dict(
        jcfg=jcfg, tcfg=_torch_config(jcfg), np_params=np_params, ids=ids,
        tgt=tgt, loss=float(loss),
        metrics={k: float(v) for k, v in metrics.items()},
        grads=jax.tree_util.tree_map(np.asarray, grads),
        step_loss=float(step_loss),
        step_params=jax.tree_util.tree_map(np.asarray, p1))


def _port_value_and_grad(pair, **over):
    model = DMoETransformerLM(dataclasses.replace(pair["tcfg"], **over),
                              device="cpu")
    params = params_from_jax(pair["np_params"], pair["tcfg"], device="cpu")
    return model.value_and_grad(params, torch.from_numpy(pair["ids"]),
                                torch.from_numpy(pair["tgt"]))


def test_long_context_value_and_grad_matches_jax(slice_pair, monkeypatch):
    calls = {"fwd": 0, "dkv": 0, "dq": 0}
    for name, attr in (("fwd", "flash_attention_fwd"),
                       ("dkv", "flash_attention_dkv"),
                       ("dq", "flash_attention_dq")):
        orig = getattr(fa, attr)

        def counting(*a, _o=orig, _n=name, **kw):
            calls[_n] += 1
            return _o(*a, **kw)

        monkeypatch.setattr(fa, attr, counting)
    (loss, metrics), grads = _port_value_and_grad(slice_pair)
    # the Function ran once a layer, forward and backward
    assert calls == {"fwd": 2, "dkv": 2, "dq": 2}
    np.testing.assert_allclose(float(loss), slice_pair["loss"], rtol=1e-5)
    for key, want in slice_pair["metrics"].items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-5,
                                   atol=1e-7)
    got = params_to_jax(grads, slice_pair["tcfg"])
    flat_g, tdef_g = jax.tree_util.tree_flatten(got)
    flat_w, tdef_w = jax.tree_util.tree_flatten(slice_pair["grads"])
    assert tdef_g == tdef_w
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"grad leaf {i}")
    # the attention projections get their gradient through the Function
    for layer in grads["layers"]:
        for name in ("wq", "wk", "wv"):
            assert layer[name].abs().max() > 1e-4, name


def test_long_context_remat_equals_no_remat(slice_pair):
    (l0, m0), g0 = _port_value_and_grad(slice_pair)
    (l1, m1), g1 = _port_value_and_grad(slice_pair, remat=True)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_long_context_train_step_matches_jax(slice_pair):
    """One ``make_train_step`` step with fused Adafactor (the flagship's
    optimizer) from the same params and batch: loss and updated params."""
    pair = slice_pair
    model = DMoETransformerLM(pair["tcfg"], device="cpu")
    params = params_from_jax(pair["np_params"], pair["tcfg"], device="cpu")
    opt = fused_adafactor(1e-3)
    step = model.make_train_step(opt)
    params, _, loss, _ = step(params, model.init_opt_state(opt, params),
                              torch.from_numpy(pair["ids"]),
                              torch.from_numpy(pair["tgt"]))
    np.testing.assert_allclose(float(loss), pair["step_loss"], rtol=1e-5)
    # f32 Adafactor after one step: summation order only, the bar of
    # test_torch_train_step's fused-Adafactor cases
    got = jax.tree_util.tree_leaves(params_to_jax(params, pair["tcfg"]))
    for i, (g, w) in enumerate(zip(got, jax.tree_util.tree_leaves(
            pair["step_params"]))):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5,
                                   err_msg=f"param leaf {i}")


def test_params_convert_at_the_long_context_seq_len():
    """The flagship's long-context config in miniature: seq_len 8192 gives
    an [8192, d] ``pos`` leaf, carried across bitwise."""
    jcfg = JaxConfig(**{**SLICE, "d_model": 64, "n_heads": 1,
                        "seq_len": 8192})
    model = JaxLM(jcfg, make_mesh({"expert": 1}, devices=jax.devices()[:1]))
    tree = jax.tree_util.tree_map(np.asarray,
                                  model.init_params(jax.random.PRNGKey(1)))
    params = params_from_jax(tree, jcfg, device="cpu")
    assert tuple(params["pos"].shape) == (8192, 64)
    assert params["pos"].numpy().tobytes() == tree["pos"].tobytes()
    back = params_to_jax(params, jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
