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
