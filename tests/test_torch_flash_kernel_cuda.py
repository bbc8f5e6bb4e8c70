"""The Hopper flash-attention kernel on a CUDA card, against its plain
version.  Every test here needs the card and skips without one; the file
imports torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel_cuda.py
"""

import pytest
import torch

from learning_at_home_tpu_torch.ops import flash_attention as fa

# bf16 rounding of P and of O (2^-8 relative each) against the plain
# version computed in f32 from the same bf16 inputs
ATOL, RTOL = 1.6e-2, 8e-3
# lse: f32 summation order of the scores and exp2's few-2^-22 relative
# error, against values near log(S) (test_torch_flash_bwd_cuda.py)
LSE_ATOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(shape, gen):
    return [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 8, 64), (1, 1000, 4, 64),
                                   (3, 70, 2, 64), (1, 1, 1, 64)])
def test_kernel_matches_plain_on_card(card, shape):
    q, k, v = _qkv(shape, card)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(card):
    """q/k/v as slices of one packed [B,S,3,H,hd] tensor: strided rows,
    no copies."""
    packed = torch.randn((2, 300, 3, 4, 64), generator=card,
                         device="cuda").to(torch.bfloat16)
    q, k, v = packed.unbind(2)
    out = fa.flash_attention(q, k, v)
    want = fa.attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _qkv((1, 16, 2, 64), card)
    before = fa.flash_attention.launches
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    assert fa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("s", [1, 65, 70, 1000, 8193])
def test_forward_at_ragged_lengths(card, s, with_lse, packed):
    """Lengths one past a tile, inside one, and one row: keys past S come
    in as zeros and must be masked, rows past S must not be written; with
    and without the lse output, contiguous and packed-qkv strides."""
    b, h = (1, 2) if s > 4096 else (2, 3)
    if packed:
        q, k, v = torch.randn((b, s, 3, h, 64), generator=card,
                              device="cuda").to(torch.bfloat16).unbind(2)
    else:
        q, k, v = _qkv((b, s, h, 64), card)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    want_o, want_lse = fa.attention_fwd_reference(q.float(), k.float(),
                                                  v.float())
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), want_o, atol=ATOL, rtol=RTOL)
    if with_lse:
        assert lse.shape == (b, h, s) and lse.dtype == torch.float32
        torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=0)
    else:
        assert lse is None
