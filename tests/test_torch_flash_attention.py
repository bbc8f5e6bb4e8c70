"""The port's attention (ops/flash_attention.py, models/trunk.py) against
the JAX package's trunk on the same numpy inputs.

Two oracles: ``jax.nn.dot_product_attention`` (``attention_core(
impl="xla")``) at any S, and the library Pallas flash kernel itself
(``attention_core(impl="flash")``), which runs on the CPU under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()`` for S a
multiple of its 128-row blocks (and without ``jax.checkpoint`` around it,
which interpret mode's ordered effects refuse).  The gradients are held
against the library kernel's backward in test_torch_flash_attention_bwd.py.
The Hopper kernels themselves are tested on the card by
test_torch_flash_kernel_cuda.py and test_torch_flash_bwd_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning_at_home_tpu.models import trunk as jtrunk
from learning_at_home_tpu_torch.models import trunk as ttrunk
from learning_at_home_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True)
def _full_precision_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(rng, shape, scale=1.0):
    return [rng.standard_normal(shape).astype(np.float32) * scale
            for _ in range(3)]


def _bf16_np(x):
    """numpy f32 values rounded to bf16, as the JAX side sees them."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# (shape [B,S,H,hd], dtype, tolerance): f32 agrees to 1e-5; in bf16 both
# sides round the probabilities and the output to bf16 (2^-8 relative)
@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 16, 4, 16), "f32", 1e-5),
    ((1, 37, 2, 64), "f32", 1e-5),
    ((2, 24, 4, 16), "bf16", 2e-2),
])
def test_attention_core_matches_jax(shape, dtype, tol):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, shape, scale=2.0)
    if dtype == "bf16":
        q, k, v = map(_bf16_np, (q, k, v))
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    else:
        jdt, tdt = jnp.float32, torch.float32
    want = np.asarray(jtrunk.attention_core(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), impl="xla"
    ).astype(jnp.float32))
    for impl in ("xla", "flash"):  # flash on CPU tensors = the plain twin
        got = ttrunk.attention_core(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), impl=impl
        )
        assert got.dtype == tdt and got.shape == shape
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


# the library kernel in interpret mode: f32 agrees to summation order; in
# bf16 both round the probabilities and the output to bf16 (2^-8
# relative), the library before normalising, the port after
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_attention_core_matches_the_jax_flash_kernel(dtype, tol):
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, (2, 256, 4, 64), scale=2.0)
    if dtype == "bf16":
        q, k, v = map(_bf16_np, (q, k, v))
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    else:
        jdt, tdt = jnp.float32, torch.float32
    fn = jax.jit(lambda q, k, v: jtrunk.attention_core(q, k, v, impl="flash"))
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    got = ttrunk.attention_core(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), impl="flash")
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_flash_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (1, 9, 2, 64)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before
    assert torch.equal(out, fa.attention_reference(q, k, v))


def test_attention_is_causal():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (1, 12, 2, 8)))
    base = fa.attention_reference(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 7:] += 5.0
    v2[:, 7:] -= 3.0
    moved = fa.attention_reference(q, k2, v2)
    assert torch.equal(base[:, :7], moved[:, :7])
    assert not torch.allclose(base[:, 7:], moved[:, 7:])


@pytest.mark.parametrize("t", [0, 5, 11])
def test_one_query_attention_matches_jax(t):
    rng = np.random.default_rng(3 + t)
    b, s, h, hd = 2, 12, 4, 8
    d = h * hd
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kc, vc, _ = _qkv(rng, (b, s, h, hd))
    wo = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)
    want = jtrunk.one_query_attention(
        {"wo": jnp.asarray(wo)}, jnp.asarray(q), jnp.asarray(kc),
        jnp.asarray(vc), t,
    )
    got = ttrunk.one_query_attention(
        {"wo": torch.from_numpy(wo)}, torch.from_numpy(q),
        torch.from_numpy(kc), torch.from_numpy(vc), t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_layer_norm_matches_jax():
    """f32 statistics, population variance, eps 1e-5: a row whose variance
    is below eps makes eps visible, and 16 columns make the variance's
    divisor (16, not 15) visible."""
    rng = np.random.default_rng(4)
    spread = np.array([[1e-3], [1.0], [10.0], [0.05], [2.0]])
    x = (rng.standard_normal((5, 16)) * spread + np.array([[0.0], [3.0], [-5.0],
                                                          [0.5], [1.0]]))
    x = x.astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    want = np.asarray(jtrunk.layer_norm(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x)))
    got = ttrunk.layer_norm(
        {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # bf16 input: computed in f32, cast back
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = ttrunk.layer_norm({n: torch.from_numpy(a) for n, a in p.items()}, xb)
    assert yb.dtype == torch.bfloat16


def test_projections_and_causal_attention_match_jax():
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 10, 4, 32
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    lp = {n: (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
          for n in ("wq", "wk", "wv", "wo")}
    want = jtrunk.causal_attention(
        {n: jnp.asarray(a) for n, a in lp.items()}, jnp.asarray(x), h)
    got = ttrunk.causal_attention(
        {n: torch.from_numpy(a) for n, a in lp.items()}, torch.from_numpy(x), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bad,err", [
    (dict(dtype=torch.float32), TypeError),
    (dict(hd=32), ValueError),
    (dict(transpose=True), ValueError),
])
def test_kernel_input_checks(bad, err):
    """What the kernel does not take is refused before any launch."""
    hd = bad.get("hd", 64)
    q = torch.zeros((1, 8, 2, hd), dtype=bad.get("dtype", torch.bfloat16))
    if bad.get("transpose"):
        q = q.transpose(1, 3)  # head dim no longer contiguous
    with pytest.raises(err):
        fa._check_cuda_inputs(q, q, q)


def test_impl_is_validated():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError):
        ttrunk.attention_core(q, q, q, impl="pallas")
