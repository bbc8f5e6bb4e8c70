"""K4's entry points (ops/token_dispatch.py) on CPU tensors against the
JAX package: the Pallas kernel in interpret mode and the XLA gather.

Which comparison is bitwise: the port equals ``dispatch_tokens_indexed``
(JAX's and its own) bit for bit on every input, since both copy rows.
The Pallas kernel picks each row from an 8-row chunk with a masked sum,
which turns -0.0 into +0.0, so the port equals it bit for bit only on
inputs without negative zeros; with them the values are equal and the
sign bits differ."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from learning_at_home_tpu.ops import moe_dispatch as jmd
from learning_at_home_tpu.ops.pallas_dispatch import dispatch_tokens_pallas
from learning_at_home_tpu_torch.ops import moe_dispatch as tmd
from learning_at_home_tpu_torch.ops import token_dispatch as ttd

# the shapes of the JAX package's own kernel test (n, E, k, capacity)
SHAPES = [(32, 8, 2, 6), (16, 4, 1, 2), (64, 16, 4, 8)]
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _inputs(n, e, k, cap, d, dtype, seed):
    """x [n, d] of ``dtype`` without negative zeros, and the same routing
    plan in both packages (its token_for_slot is checked equal)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32).astype(dtype)
    logits = rs.randn(n, e).astype(np.float32)
    jplan = jmd.top_k_gating_indices(jnp.asarray(logits), k=k, capacity=cap)
    tplan = tmd.top_k_gating_indices(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(tplan.token_for_slot.numpy(),
                                  np.asarray(jplan.token_for_slot))
    return x, jplan, tplan


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy array or a tensor, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,e,k,cap", SHAPES)
def test_kernel_entry_point_matches_jax_bitwise(n, e, k, cap, dtype):
    np_dtype, _ = DTYPES[dtype]
    x, jplan, tplan = _inputs(n, e, k, cap, 128, np_dtype, n + e)
    got = ttd.dispatch_tokens_auto(_torch(x), tplan, use_kernel=True)
    pallas = dispatch_tokens_pallas(jnp.asarray(x), jplan, interpret=True)
    gather = jmd.dispatch_tokens_indexed(jnp.asarray(x), jplan)
    assert tuple(got.shape) == (e, cap, 128) and got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    np.testing.assert_array_equal(_bits(got), _bits(gather))
    np.testing.assert_array_equal(
        _bits(got), _bits(tmd.dispatch_tokens_indexed(_torch(x), tplan)))
    empty = np.asarray(jplan.token_for_slot) < 0
    assert (got.float().numpy()[empty] == 0).all()


def test_negative_zero_the_tpu_kernel_flips_and_the_port_keeps():
    """A row of -0.0: the Pallas kernel's masked sum gives +0.0 there,
    equal in value and different in the sign bit; the port copies the
    -0.0 as the gather does."""
    n, e, k, cap, d = 32, 8, 2, 6, 128
    x, jplan, tplan = _inputs(n, e, k, cap, d, np.float32, 40)
    token = int(np.asarray(jplan.token_for_slot)[0, 0])
    x[token] = -0.0
    got = ttd.dispatch_tokens_kernel(_torch(x), tplan)
    pallas = np.asarray(dispatch_tokens_pallas(jnp.asarray(x), jplan,
                                               interpret=True))
    gather = np.asarray(jmd.dispatch_tokens_indexed(jnp.asarray(x), jplan))
    np.testing.assert_array_equal(got.numpy(), pallas)  # values: -0 == +0
    np.testing.assert_array_equal(_bits(got), _bits(gather))
    slots = np.asarray(jplan.token_for_slot) == token
    flipped = _bits(got) != _bits(pallas)
    assert np.signbit(got.numpy()[slots]).all()
    assert not np.signbit(pallas[slots]).any()
    assert flipped.sum() == slots.sum() * d
    assert not flipped[~slots].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unaligned_d_takes_the_kernel_with_the_same_values(dtype):
    """d = 100 is outside the TPU kernel's tiling (the JAX guard falls
    back to the gather); the port's entry point takes its kernel path and
    gives the gather's values."""
    np_dtype, _ = DTYPES[dtype]
    x, jplan, tplan = _inputs(8, 4, 1, 4, 100, np_dtype, 1)
    got = ttd.dispatch_tokens_auto(_torch(x), tplan, use_kernel=True)
    want = jmd.dispatch_tokens_indexed(jnp.asarray(x), jplan)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="128"):
        dispatch_tokens_pallas(jnp.asarray(x), jplan, interpret=True)


def test_gradients_are_refused_not_dropped():
    x, _, plan = _inputs(16, 4, 1, 2, 128, np.float32, 2)
    xt = _torch(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ttd.dispatch_tokens_kernel(xt, plan)
    with pytest.raises(RuntimeError, match="no gradient"):
        ttd.dispatch_tokens_auto(xt, plan, use_kernel=True)
    with torch.no_grad():
        out = ttd.dispatch_tokens_kernel(xt, plan)
    assert out.grad_fn is None and not out.requires_grad
    # the plain path keeps its gradient
    assert ttd.dispatch_tokens_auto(xt, plan).grad_fn is not None


def test_bad_operands_raise():
    x, _, plan = _inputs(16, 4, 1, 2, 128, np.float32, 3)
    xt = _torch(x)
    bad = [
        (xt[None], plan, ValueError),  # x of rank 3
        (xt.double(), plan, TypeError),
        (xt.to(torch.int32), plan, TypeError),
        (xt[:0], plan, ValueError),  # n = 0
        (xt, plan._replace(token_for_slot=plan.token_for_slot.reshape(-1)),
         ValueError),
        (xt, plan._replace(token_for_slot=plan.token_for_slot[:0]),
         ValueError),
        (xt, plan._replace(token_for_slot=plan.token_for_slot.float()),
         TypeError),
    ]
    for x_, plan_, exc in bad:
        with pytest.raises(exc):
            ttd.dispatch_tokens_kernel(x_, plan_)
    assert ttd.dispatch_tokens_kernel.launches == 0  # CPU runs launch nothing
