"""The Hopper fused cross-entropy kernels K1-K3 on a CUDA card, against
their plain versions.  Every test here needs the card and skips without
one; the file imports torch only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_ce_cuda.py
"""

import pytest
import torch

from learning_at_home_tpu_torch.ops import fused_ce as fce

# Tolerances against the plain versions computed in f32 from the same bf16
# inputs.  ce / lse: only the f32 summation order of the logits differs;
# the worst-case f32 bound d * 2^-24 * sum|x_k h_k| is ~4e-4 per logit at
# d = 512 with unit-scale x and N(0, 1/d) heads, so 1e-3.  dx / dhead: the
# kernels round dl to bf16 (2^-9 relative per term, summed over terms
# whose absolute sum is about twice the largest output) and round the
# output to bf16 (2^-9 relative): |err| <= 2^-8 |ref| + 2^-7 max|ref|.
CE_ATOL = 1e-3
GRAD_RTOL, GRAD_ATOL_SCALE = 2.0 ** -8, 2.0 ** -7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, n, d, v, strided_head=False):
    x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    if strided_head:  # head^T is a column slice of a wider table
        table = (torch.randn((v, d + 64), generator=gen, device="cuda")
                 * d ** -0.5).to(torch.bfloat16)
        head = table[:, :d].t()
    else:  # the tied layout: embed.T
        head = (torch.randn((v, d), generator=gen, device="cuda")
                * d ** -0.5).to(torch.bfloat16).t()
    tgt = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tgt[::17] = -1  # targets outside [0, V) pick nothing
    tgt[5::23] = v
    dce = torch.rand((n,), generator=gen, device="cuda") + 0.5
    return x, head, tgt, dce


def _assert_grad_close(got, want, name):
    err = (got.float() - want.float()).abs()
    limit = GRAD_RTOL * want.float().abs() + GRAD_ATOL_SCALE * float(
        want.float().abs().max())
    bad = int((err > limit).sum())
    assert bad == 0, f"{name}: {bad} elements outside tolerance, " \
                     f"max err {float(err.max()):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,strided", [
    (256, 128, 2048, False), (320, 512, 1024, False), (200, 256, 640, False),
    (128, 384, 1024, True),
])
def test_kernels_match_plain_on_card(card, n, d, v, strided):
    x, head, tgt, dce = _inputs(card, n, d, v, strided)
    counts = (fce.ce_forward.launches, fce.ce_dx.launches,
              fce.ce_dhead.launches)
    ce, lse = fce.ce_forward(x, head, tgt)
    dx = fce.ce_dx(x, head, tgt, lse, dce)
    dhead = fce.ce_dhead(x, head, tgt, lse, dce)
    torch.cuda.synchronize()
    assert (fce.ce_forward.launches, fce.ce_dx.launches,
            fce.ce_dhead.launches) == tuple(c + 1 for c in counts)
    want_ce, want_lse = fce.ce_fwd_reference(x, head, tgt)
    torch.testing.assert_close(ce, want_ce, atol=CE_ATOL, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=CE_ATOL, rtol=0)
    # the backward references start from the kernel's lse, as K2/K3 do
    assert dx.dtype == x.dtype and dhead.dtype == head.dtype
    assert dhead.shape == head.shape
    _assert_grad_close(dx, fce.ce_dx_reference(x, head, tgt, lse, dce), "dx")
    _assert_grad_close(dhead, fce.ce_dhead_reference(x, head, tgt, lse, dce),
                       "dhead")


@pytest.mark.cuda
def test_autograd_runs_k1_then_k2_and_k3(card):
    x, head, tgt, _ = _inputs(card, 256, 128, 1024)
    x.requires_grad_(True)
    head.requires_grad_(True)
    before = (fce.ce_forward.launches, fce.ce_dx.launches,
              fce.ce_dhead.launches)
    loss = fce.fused_softmax_ce(x, head, tgt).mean()
    gx, gh = torch.autograd.grad(loss, (x, head))
    assert (fce.ce_forward.launches, fce.ce_dx.launches,
            fce.ce_dhead.launches) == tuple(c + 1 for c in before)
    xr = x.detach().float().requires_grad_(True)
    hr = head.detach().float().requires_grad_(True)
    want = fce.ce_fwd_reference(xr, hr, tgt)[0].mean()
    rx, rh = torch.autograd.grad(want, (xr, hr))
    torch.testing.assert_close(loss.float(), want, atol=CE_ATOL, rtol=0)
    _assert_grad_close(gx, rx, "dx")
    _assert_grad_close(gh, rh, "dhead")


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    x, head, tgt, dce = _inputs(card, 128, 128, 1024)
    before = (fce.ce_forward.launches, fce.ce_dx.launches,
              fce.ce_dhead.launches)
    with pytest.raises(TypeError, match="float32"):
        fce.ce_forward(x.float(), head.float(), tgt)
    with pytest.raises(TypeError, match="float16"):
        fce.ce_dx(x.half(), head.half(), tgt, dce, dce)
    xw = torch.zeros((128, 640), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="D in"):
        fce.ce_forward(xw, torch.zeros((640, 1024), dtype=torch.bfloat16,
                                       device="cuda"), tgt)
    assert (fce.ce_forward.launches, fce.ce_dx.launches,
            fce.ce_dhead.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,v", [(1000, 1088), (128, 64), (333, 2048)])
@pytest.mark.parametrize("d", fce.KERNEL_D)
def test_forward_kernel_at_every_width(card, d, n, v):
    """K1 at every D it is built for, n not a multiple of its 128-row
    block, V a multiple of 64 that is not one of 128 (its last vocab tile
    half empty), targets outside [0, V) among the rows."""
    x, head, tgt, _ = _inputs(card, n, d, v)
    before = fce.ce_forward.launches
    ce, lse = fce.ce_forward(x, head, tgt)
    torch.cuda.synchronize()
    assert fce.ce_forward.launches == before + 1
    want_ce, want_lse = fce.ce_fwd_reference(x, head, tgt)
    torch.testing.assert_close(lse, want_lse, atol=CE_ATOL, rtol=0)
    torch.testing.assert_close(ce, want_ce, atol=CE_ATOL, rtol=0)
    outside = (tgt < 0) | (tgt >= v)
    assert outside.any()
    torch.testing.assert_close(ce[outside], lse[outside], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,v", [(1000, 1088), (128, 64), (333, 2048)])
@pytest.mark.parametrize("d", fce.KERNEL_D)
def test_backward_kernels_at_every_width(card, d, n, v):
    """K2 and K3 at every D they are built for, n not a multiple of their
    64-row tiles (K2's last block and K3's last streamed tile ragged), V =
    64 * odd, targets outside [0, V) among the rows."""
    x, head, tgt, dce = _inputs(card, n, d, v)
    _, lse = fce.ce_forward(x, head, tgt)
    before = (fce.ce_dx.launches, fce.ce_dhead.launches)
    dx = fce.ce_dx(x, head, tgt, lse, dce)
    dhead = fce.ce_dhead(x, head, tgt, lse, dce)
    torch.cuda.synchronize()
    assert (fce.ce_dx.launches, fce.ce_dhead.launches) == (
        before[0] + 1, before[1] + 1)
    assert dx.shape == x.shape and dhead.shape == head.shape
    _assert_grad_close(dx, fce.ce_dx_reference(x, head, tgt, lse, dce), "dx")
    _assert_grad_close(dhead, fce.ce_dhead_reference(x, head, tgt, lse, dce),
                       "dhead")


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,strided", [
    (1000, 512, 1088, False), (4096, 512, 8192, True), (333, 256, 2048, False),
])
def test_backward_kernels_are_deterministic(card, n, d, v, strided):
    """Two launches of K2 and of K3 on the same inputs give the same bits:
    each output element is summed in a fixed order by one block."""
    x, head, tgt, dce = _inputs(card, n, d, v, strided)
    _, lse = fce.ce_forward(x, head, tgt)
    for fn in (fce.ce_dx, fce.ce_dhead):
        first = fn(x, head, tgt, lse, dce)
        again = fn(x, head, tgt, lse, dce)
        torch.cuda.synchronize()
        assert torch.equal(_bits(first), _bits(again)), fn.__name__
