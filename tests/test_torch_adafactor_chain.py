"""``optim.adafactor`` against ``optax.adafactor``: updates and states of
three steps from the same numpy-seeded params and gradients (each step
from optax's params, each side carrying its own state), in f32 and
bf16, on a leaf of each kind: [256, 512] (factored), [130, 3] (its second
largest dim below ``min_dim_size_to_factor`` = 128: unfactored), [64] and
a scalar.  optax runs under ``jax.jit``, as a train step runs it.

Tolerances.  bf16: bit for bit -- every elementwise op rounds to bf16 in
both (the port casts each Python constant to the storage dtype first, as
JAX does a weakly typed one), and a mean is summed in f32 and rounded to
bf16 on both sides.  f32: within 4 ulp.  The port's CPU means add in
XLA:CPU's order along one dim (its EMA emulates XLA's fused multiply-add),
so the states come out bit for bit; ``x ** -0.5`` goes through f64 where
XLA's f32 ``pow`` is within an ulp of correctly rounded; and a whole-leaf
mean of rank >= 2 (the clip's and the parameter scale's) is summed within
an ulp of XLA's windowed order.  In f32 the port also folds scalars where
XLA does: a mean's reciprocal count into the EMA's factor, and the
learning rate into the parameter scale.  The update's three products and
two block-RMS scales carry those ulps: measured at most 2 on the leaves
above and 4 on the pod model's [1, 4, 512, 128] expert leaf.

A state converted JAX -> port (``convert.opt_state_from_jax``) after one
optax step continues identically, and converts back bit for bit.
"""

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
from learning_at_home_tpu.parallel.mesh import make_mesh
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch.convert import (
    numpy_to_tensor,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    tensor_to_numpy,
)
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
)

SHAPES = {"factored": (256, 512), "below_min_dim": (130, 3),
          "vector": (64,), "scalar": ()}
LR = 1e-2
STEPS = 3
F32_ULPS = 4
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _draws(np_dtype, seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {k: np.asarray(rng.standard_normal(s) * scale,
                              np.float32).astype(np_dtype)
                for k, s in shapes.items()}

    return tree(1.0), [tree(0.1) for _ in range(STEPS)]


def _to_torch(tree):
    return {k: numpy_to_tensor(v, "cpu") for k, v in tree.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32).astype(
        np.int64)


def _assert_leaf(got, want, np_dtype, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    ulps = np.abs(_bits(got) - _bits(want))
    limit = F32_ULPS if np_dtype == np.float32 else 0
    assert ulps.max(initial=0) <= limit, (
        f"{what}: {int(ulps.max())} ulp apart at "
        f"{int((ulps > limit).sum())} of {ulps.size}")


def _assert_states(tstate, jstate, np_dtype, what, shapes=SHAPES):
    assert [type(s).__name__ for s in tstate] == \
        [type(s).__name__ for s in jstate] == \
        ["FactoredState", "EmptyState", "EmptyState", "EmptyState",
         "EmptyState"]
    assert int(tstate[0].count) == int(jstate[0].count)
    assert tstate[0].count.dtype == torch.int32
    for field in ("v_row", "v_col", "v"):
        for k in shapes:
            _assert_leaf(tensor_to_numpy(getattr(tstate[0], field)[k]),
                         getattr(jstate[0], field)[k], np_dtype,
                         f"{what} {field}[{k}]")


def _three_steps(dtype, shapes):
    np_dtype, _ = DTYPES[dtype]
    params, grads = _draws(np_dtype, shapes=shapes)
    jopt, topt = optax.adafactor(LR), optim.adafactor(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    _assert_states(ts, js, np_dtype, "init", shapes)
    update = jax.jit(jopt.update)
    for step, g in enumerate(grads):
        ju, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update(_to_torch(g), ts, tp)
        for k in shapes:
            _assert_leaf(tensor_to_numpy(tu[k]), ju[k], np_dtype,
                         f"step {step} update[{k}]")
        _assert_states(ts, js, np_dtype, f"step {step}", shapes)
        # each side carries its own state; both step from optax's params,
        # so an update's last-bit differences do not compound
        jp = optax.apply_updates(jp, ju)
        tp = _to_torch({k: np.asarray(v) for k, v in jp.items()})


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_three_steps_match_optax(dtype):
    _three_steps(dtype, SHAPES)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_three_steps_match_optax_on_an_uneven_leaf(dtype):
    """A factored leaf whose reduced dims are not powers of two: [300,
    128], the pod model's embedding, where XLA's folding of a mean's
    reciprocal count (1/300) into the EMA's factor and of the learning
    rate into the parameter scale round differently from the products
    taken in the source's order."""
    _three_steps(dtype, {"embed": (300, 128)})


def test_factoring_rule_and_tie_break_are_optax():
    """The factored dims are the two largest, the tie resolved by numpy's
    argsort; a leaf whose second largest dim is below 128 keeps a full
    second moment."""
    shapes = {"tie": (128, 256, 256), "row": (512, 128), "small": (127, 900),
              "one_d": (4096,)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    js = optax.adafactor(LR).init({k: jnp.asarray(v)
                                   for k, v in params.items()})
    ts = optim.adafactor(LR).init(_to_torch(params))
    for field in ("v_row", "v_col", "v"):
        for k in shapes:
            assert tuple(getattr(ts[0], field)[k].shape) == \
                tuple(getattr(js[0], field)[k].shape), (field, k)


def test_update_needs_params():
    opt = optim.adafactor(LR)
    p = {"w": torch.zeros(3)}
    with pytest.raises(ValueError, match="params"):
        opt.update(p, opt.init(p))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_converted_state_continues_identically(dtype):
    """optax takes step 1 of a small pod model's params; its params and
    state are converted (and back, bit for bit) and step 2 runs in both."""
    np_dtype, _ = DTYPES[dtype]
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jcfg = JaxConfig(vocab_size=300, d_model=128, n_layers=1, n_heads=4,
                     seq_len=16, num_experts=4, k=2, param_dtype=jdt,
                     dtype=jnp.float32)
    model = JaxLM(jcfg, make_mesh({"expert": 1}, devices=jax.devices()[:1]))
    jp = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray((rng.standard_normal(p.shape) * 0.05)
                              .astype(np.float32)).astype(p.dtype), jp)
        for _ in range(2)]
    jopt = optax.adafactor(LR)
    js = jopt.init(jp)
    u, js = jopt.update(grads[0], js, jp)
    jp = optax.apply_updates(jp, u)

    tcfg = DMoETransformerConfig(
        vocab_size=300, d_model=128, n_layers=1, n_heads=4, seq_len=16,
        num_experts=4, k=2, dtype=torch.float32,
        param_dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    np_s = jax.tree_util.tree_map(np.asarray, js)
    tp = params_from_jax(np_p, tcfg, device="cpu")
    ts = opt_state_from_jax(np_s, tcfg, device="cpu")
    assert isinstance(ts, tuple) and len(ts) == 5
    assert isinstance(ts[0], optim.FactoredState)
    back = opt_state_to_jax(ts, tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tuple(np_s[0]))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    tg = params_from_jax(jax.tree_util.tree_map(np.asarray, grads[1]), tcfg,
                         device="cpu")
    ju, js2 = jax.jit(jopt.update)(grads[1], js, jp)
    tu, ts2 = optim.adafactor(LR).update(tg, ts, tp)
    for g, w in zip(jax.tree_util.tree_leaves(opt_state_to_jax(ts2, tcfg)),
                    jax.tree_util.tree_leaves(tuple(js2[0]))):
        _assert_leaf(g, w, np_dtype, "state after the converted step")
    tu_np = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, ju))
    from learning_at_home_tpu_torch.convert import params_to_jax

    for g, w in zip(jax.tree_util.tree_leaves(params_to_jax(tu, tcfg)),
                    tu_np):
        _assert_leaf(g, w, np_dtype, "update after the converted step")
