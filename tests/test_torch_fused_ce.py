"""The port's fused cross-entropy (ops/fused_ce.py) against the JAX
package's, run as the JAX package's own tests run it on the CPU
(``interpret=True``), on the same numpy inputs.  On CPU tensors the port's
autograd function runs the plain versions of K1-K3, so these tests hold
the custom forward and backward against the JAX kernels' semantics."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from learning_at_home_tpu.ops import fused_ce as jfce
from learning_at_home_tpu_torch.ops import fused_ce as tfce


def _inputs(n=256, d=128, v=2048, dtype=np.float32, seed=0, off_range=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(dtype)
    head = (rs.randn(d, v) * 0.05).astype(dtype)
    t = rs.randint(0, v, n).astype(np.int32)
    if off_range:  # targets outside [0, V): no logit picked, no one-hot
        t[::7] = -1
        t[3::11] = v
    return x, head, t


def _t(a, requires_grad=False):
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.requires_grad_(requires_grad)


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("off_range", [False, True])
def test_forward_ce_and_lse_match_jax_f32(off_range):
    x, head, t = _inputs(off_range=off_range)
    jce, jlse = jfce._fwd(jnp.asarray(x), jnp.asarray(head), jnp.asarray(t),
                          128, 512, True)
    ce, lse = tfce.ce_forward(_t(x), _t(head), _t(t))
    np.testing.assert_allclose(ce.numpy(), np.asarray(jce), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)
    if off_range:  # no picked logit: ce == lse on those rows
        np.testing.assert_array_equal(ce.numpy()[::7], lse.numpy()[::7])


def test_forward_bf16_inputs_match_jax():
    """bf16 operands, f32 statistics in both packages."""
    x, head, t = _inputs(dtype=ml_dtypes.bfloat16)
    jce = jfce.fused_softmax_ce(jnp.asarray(x), jnp.asarray(head),
                                jnp.asarray(t), 128, 512, True)
    ce = tfce.fused_softmax_ce(_t(x), _t(head), _t(t), 128, 512)
    assert ce.dtype == torch.float32
    np.testing.assert_allclose(ce.numpy(), np.asarray(jce), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("off_range", [False, True])
def test_grads_match_jax_f32(off_range):
    x, head, t = _inputs(off_range=off_range)
    rs = np.random.RandomState(1)
    w = rs.rand(len(t)).astype(np.float32)  # a per-row cotangent

    def jloss(x, h):
        return (jfce.fused_softmax_ce(x, h, jnp.asarray(t), 128, 512, True)
                * w).sum()

    jgx, jgh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(head))
    tx, th = _t(x, True), _t(head, True)
    loss = (tfce.fused_softmax_ce(tx, th, _t(t), 128, 512)
            * torch.from_numpy(w)).sum()
    gx, gh = torch.autograd.grad(loss, (tx, th))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=1e-5,
                               rtol=1e-5)


def test_grads_bf16_inputs_match_jax():
    """bf16 x and head: dx and dhead come back in bf16 in both packages,
    from f32 products; they agree to bf16 rounding (2^-8 relative)."""
    x, head, t = _inputs(dtype=ml_dtypes.bfloat16)

    def jloss(x, h):
        return jfce.fused_softmax_ce(x, h, jnp.asarray(t), 128, 512,
                                     True).mean()

    jgx, jgh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(head))
    tx, th = _t(x, True), _t(head, True)
    gx, gh = torch.autograd.grad(
        tfce.fused_softmax_ce(tx, th, _t(t), 128, 512).mean(), (tx, th))
    assert gx.dtype == gh.dtype == torch.bfloat16
    for got, want in ((gx, jgx), (gh, jgh)):
        want = _np32(want)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(want).max())


def test_backward_runs_the_dx_and_dhead_versions(monkeypatch):
    """The autograd function's backward is K2 then K3 (their plain
    versions here), each once, and targets get no gradient."""
    calls = []
    for name in ("ce_forward", "ce_dx", "ce_dhead"):
        orig = getattr(tfce, name)
        monkeypatch.setattr(
            tfce, name,
            lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    x, head, t = _inputs(n=128, v=1024)
    tx, th = _t(x, True), _t(head, True)
    ce = tfce.fused_softmax_ce(tx, th, _t(t))
    assert calls == ["ce_forward"]
    ce.sum().backward()
    assert calls == ["ce_forward", "ce_dx", "ce_dhead"]
    # only x needs a gradient: K3 is skipped
    tx2 = _t(x, True)
    tfce.fused_softmax_ce(tx2, _t(head), _t(t)).sum().backward()
    assert calls[3:] == ["ce_forward", "ce_dx"]


@pytest.mark.parametrize("shape,blocks", [
    ((256, 128, 2048), (128, 512)), ((256, 128, 2048), (128, 1024)),
    ((100, 128, 2048), (128, 1024)), ((256, 96, 2048), (128, 1024)),
    ((256, 128, 777), (128, 1024)), ((256, 128, 2048), (128, 1000)),
    ((256, 128, 2048), (12, 512)), ((256, 128, 2048), (64, 256)),
    ((256, 128, 2048), (8, 128)),
])
def test_check_accepts_and_refuses_like_jax(shape, blocks):
    n, d, v = shape
    x, head, t = np.zeros((n, d), np.float32), np.zeros((d, v), np.float32), \
        np.zeros(n, np.int32)
    want = jfce._check(x, head, t, *blocks)
    got = tfce._check(_t(x), _t(head), _t(t), *blocks)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == want


def test_check_refuses_mismatched_operands_like_jax():
    x, head, t = _inputs(n=128)
    for args in [(x, head[:64], t), (x, head, t[:64])]:
        assert jfce._check(*args, 128, 1024) is not None
        assert tfce._check(*(_t(a) for a in args), 128, 1024) is not None
    with pytest.raises(ValueError, match="fused_softmax_ce"):
        tfce.fused_softmax_ce(_t(x), _t(head), _t(t[:64]))


def test_auto_falls_back_on_bad_shapes():
    x, head, t = _inputs(n=100, d=96, v=777)  # violates everything
    jce = jfce.fused_softmax_ce_auto(jnp.asarray(x), jnp.asarray(head),
                                     jnp.asarray(t), interpret=True)
    tx = _t(x, True)
    ce = tfce.fused_softmax_ce_auto(tx, _t(head), _t(t))
    assert type(ce.grad_fn).__name__ != "FusedSoftmaxCEBackward"
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(jce),
                               atol=1e-5, rtol=1e-5)
    # and the fused path where the default blocks fit
    x, head, t = _inputs(n=128, v=1024)
    ce = tfce.fused_softmax_ce_auto(_t(x, True), _t(head), _t(t))
    assert type(ce.grad_fn).__name__ == "FusedSoftmaxCEBackward"


def test_cpu_wrappers_count_no_launches():
    """The counters count kernel launches only; CPU tensors launch none."""
    before = (tfce.ce_forward.launches, tfce.ce_dx.launches,
              tfce.ce_dhead.launches)
    x, head, t = _inputs(n=128, v=1024)
    ce, lse = tfce.ce_forward(_t(x), _t(head), _t(t))
    tfce.ce_dx(_t(x), _t(head), _t(t), lse, torch.ones(128))
    tfce.ce_dhead(_t(x), _t(head), _t(t), lse, torch.ones(128))
    assert (tfce.ce_forward.launches, tfce.ce_dx.launches,
            tfce.ce_dhead.launches) == before
