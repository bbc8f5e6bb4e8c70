"""K5's backward on a CUDA card: the Hopper dkv and dq kernels behind
``FlashAttention``, and the forward's lse output, against their plain
versions.  Every test here needs the card and skips without one; the file
imports torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_bwd_cuda.py
"""

import pytest
import torch

from learning_at_home_tpu_torch.ops import flash_attention as fa

# Against the plain versions computed in f32 from the same bf16 inputs
# (and the kernel's own o and lse).  Gradients: the kernels round p and ds
# to bf16 before the products that consume them (2^-9 relative per term,
# summed over terms whose absolute sum is a few times the largest output)
# and round the outputs to bf16 (2^-9): |err| <= 2^-8 |ref| + 2^-7
# max|ref|, the form of the fused CE's gradient bound.  lse: the kernel's
# f32 scores differ from the plain version's in summation order (<= 64 *
# 2^-24 * sum|q_d k_d| * scale, ~2e-5 for unit-scale inputs) and __expf
# has a relative error of a few 2^-22, against lse values near log(S):
# 1e-3 absolute.
GRAD_RTOL, GRAD_ATOL_SCALE = 2.0 ** -8, 2.0 ** -7
LSE_ATOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _assert_grad_close(got, want, name):
    want = want.float()
    err = (got.float() - want).abs()
    limit = GRAD_RTOL * want.abs() + GRAD_ATOL_SCALE * float(want.abs().max())
    bad = int((err > limit).sum())
    assert torch.isfinite(got).all(), f"{name} is not finite"
    assert bad == 0, f"{name}: {bad} elements outside tolerance, " \
                     f"max err {float(err.max()):.3e}"
    assert float(got.float().abs().max()) > 0, f"{name} is all zeros"


def _grads(q, k, v, do):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    return out.detach(), torch.autograd.grad(out, leaves, do)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 8, 64), (1, 1000, 4, 64),
                                   (3, 70, 2, 64), (1, 65, 1, 64),
                                   (1, 8193, 2, 64)])
def test_gradients_match_plain_on_card(card, shape):
    q, k, v, do = (_randn(shape, card) for _ in range(4))
    before = (fa.flash_attention.launches, fa.flash_attention_dkv.launches,
              fa.flash_attention_dq.launches)
    out, grads = _grads(q, k, v, do)
    torch.cuda.synchronize()
    after = (fa.flash_attention.launches, fa.flash_attention_dkv.launches,
             fa.flash_attention_dq.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    _, lse = fa.flash_attention_fwd(q, k, v)
    want = fa.attention_bwd_reference(q.float(), k.float(), v.float(),
                                      out.float(), lse, do.float())
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == torch.bfloat16 and g.shape == shape
        _assert_grad_close(g, w, name)


@pytest.mark.cuda
def test_gradients_of_one_token_on_card(card):
    """S = 1: every tile but the first row lies past S.  The one
    probability is 1, so dv = do exactly, and ds = dp - di is the
    difference of two f32 sums of the same 64 products: dq and dk are zero
    up to their summation order."""
    shape = (2, 1, 3, 64)
    q, k, v, do = (_randn(shape, card) for _ in range(4))
    out, (dq, dk, dv) = _grads(q, k, v, do)
    torch.cuda.synchronize()
    assert torch.equal(out, v)
    _, lse = fa.flash_attention_fwd(q, k, v)
    want = fa.attention_bwd_reference(q.float(), k.float(), v.float(),
                                      out.float(), lse, do.float())
    torch.testing.assert_close(dv, do, atol=0, rtol=0)
    for name, g, w in (("dq", dq, want[0]), ("dk", dk, want[1])):
        assert torch.isfinite(g).all(), name
        assert float((g.float() - w.float()).abs().max()) <= 1e-4, name


@pytest.mark.cuda
def test_backward_is_deterministic_on_card(card):
    """Two launches give the same bits: each output element is summed by
    one thread in a fixed order, with no atomics."""
    shape = (2, 4096, 8, 64)
    q, k, v, do = (_randn(shape, card) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 8, 64), (1, 1000, 4, 64),
                                   (3, 70, 2, 64)])
def test_lse_matches_plain_on_card(card, shape):
    q, k, v = (_randn(shape, card) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_plain = fa.flash_attention_fwd(q, k, v, with_lse=False)[0]
    torch.cuda.synchronize()
    assert torch.equal(o, o_plain)  # lse is written beside o, o unchanged
    _, want = fa.attention_fwd_reference(q.float(), k.float(), v.float())
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=LSE_ATOL, rtol=0)


@pytest.mark.cuda
def test_backward_reads_strided_inputs(card):
    """q/k/v as slices of one packed [B,S,3,H,hd] tensor and a
    non-contiguous upstream gradient."""
    packed = _randn((2, 300, 3, 4, 64), card)
    q, k, v = packed.unbind(2)
    do = _randn((2, 4, 300, 64), card).transpose(1, 2)
    out, grads = _grads(q, k, v, do)
    _, lse = fa.flash_attention_fwd(q, k, v)
    want = fa.attention_bwd_reference(q.float(), k.float(), v.float(),
                                      out.float(), lse, do.float())
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _assert_grad_close(g, w, name)


@pytest.mark.cuda
def test_backward_kernels_refuse_what_they_do_not_take(card):
    q, k, v, do = (_randn((1, 16, 2, 64), card) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    di = fa._row_dot(o, do)
    before = (fa.flash_attention_dkv.launches, fa.flash_attention_dq.launches)
    for wrapper in (fa.flash_attention_dkv, fa.flash_attention_dq):
        with pytest.raises(TypeError):
            wrapper(q.float(), k.float(), v.float(), do.float(), lse, di)
        with pytest.raises(ValueError):
            wrapper(q[..., :32], k[..., :32], v[..., :32], do[..., :32],
                    lse, di)
        with pytest.raises(ValueError):  # head dim not contiguous
            wrapper(*(t.transpose(1, 3).contiguous().transpose(1, 3)
                      for t in (q, k, v, do)), lse, di)
        with pytest.raises(ValueError):  # statistics of another layout
            wrapper(q, k, v, do, lse.transpose(1, 2), di)
    # f32 leaves on the card are refused by the Function's forward: the
    # plain backward never runs on the card
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    with pytest.raises(TypeError):
        fa.flash_attention(*leaves)
    assert before == (fa.flash_attention_dkv.launches,
                      fa.flash_attention_dq.launches)


@pytest.mark.cuda
def test_serving_forward_builds_no_graph(card):
    q, k, v = (_randn((1, 128, 2, 64), card).requires_grad_(True)
               for _ in range(3))
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
