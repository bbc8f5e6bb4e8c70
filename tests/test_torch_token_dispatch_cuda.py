"""The Hopper token-dispatch kernel (K4) on a CUDA card, against its plain
version, bit for bit.  Every test here needs the card and skips without
one; the file imports torch only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_token_dispatch_cuda.py
"""

import pytest
import torch

from learning_at_home_tpu_torch.ops import moe_dispatch as md
from learning_at_home_tpu_torch.ops import token_dispatch as td


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _plan(token_for_slot: torch.Tensor) -> md.IndexDispatchPlan:
    z = torch.zeros((), device=token_for_slot.device)
    return md.IndexDispatchPlan(token_for_slot, None, None, z, z)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _check(x, plan):
    before = td.dispatch_tokens_kernel.launches
    out = td.dispatch_tokens_kernel(x, plan)
    torch.cuda.synchronize()
    assert td.dispatch_tokens_kernel.launches == before + 1
    want = md.dispatch_tokens_indexed(x, plan)
    assert out.shape == want.shape and out.dtype == x.dtype
    assert torch.equal(_bits(out), _bits(want))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n,d,e,c", [(4096, 512, 64, 80), (1, 100, 3, 5),
                                     (37, 7, 4, 9), (300, 128, 8, 50)])
def test_kernel_matches_plain_bitwise(card, dtype, n, d, e, c):
    """A routing plan of random slots, a fifth of them empty; ragged d
    (100, 7) and n = 1 included; a row of -0.0 and a NaN are copied as
    they are."""
    x = torch.randn((n, d), generator=card, device="cuda").to(dtype)
    x[0] = -0.0
    x[-1, 0] = float("nan")
    tfs = torch.randint(0, n, (e, c), generator=card, device="cuda",
                        dtype=torch.int32)
    tfs[torch.rand((e, c), generator=card, device="cuda") < 0.2] = -1
    _check(x, _plan(tfs))


@pytest.mark.cuda
def test_empty_and_full_plans_and_strided_rows(card):
    x = torch.randn((64, 256), generator=card, device="cuda").to(torch.bfloat16)
    empty = torch.full((8, 16), -1, dtype=torch.int32, device="cuda")
    assert not _check(x, _plan(empty)).any()
    full = torch.randperm(64, generator=card, device="cuda").reshape(4, 16)
    _check(x, _plan(full))  # int64 indices, every slot filled
    wide = torch.randn((64, 300), generator=card, device="cuda")
    _check(wide[:, 10:110], _plan(full.to(torch.int32)))  # row stride 300


@pytest.mark.cuda
def test_real_routing_plan_through_the_guarded_entry_point(card):
    logits = torch.randn((2048, 64), generator=card, device="cuda")
    plan = md.top_k_gating_indices(logits, 2, md.compute_capacity(2048, 64, 2))
    x = torch.randn((2048, 512), generator=card, device="cuda").to(torch.bfloat16)
    before = td.dispatch_tokens_kernel.launches
    out = td.dispatch_tokens_auto(x, plan, use_kernel=True)
    assert td.dispatch_tokens_kernel.launches == before + 1
    assert torch.equal(_bits(out), _bits(md.dispatch_tokens_indexed(x, plan)))
    td.dispatch_tokens_auto(x, plan)  # the plain path launches nothing
    assert td.dispatch_tokens_kernel.launches == before + 1


@pytest.mark.cuda
def test_gradients_and_bad_operands_are_refused(card):
    x = torch.randn((16, 128), generator=card, device="cuda",
                    requires_grad=True)
    plan = _plan(torch.zeros((2, 4), dtype=torch.int32, device="cuda"))
    before = td.dispatch_tokens_kernel.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        td.dispatch_tokens_kernel(x, plan)
    with pytest.raises(TypeError):
        td.dispatch_tokens_kernel(x.detach().double(), plan)
    with pytest.raises(ValueError):
        td.dispatch_tokens_kernel(x.detach(), _plan(plan.token_for_slot.cpu()))
    assert td.dispatch_tokens_kernel.launches == before
    with torch.no_grad():
        out = td.dispatch_tokens_kernel(x, plan)
    assert out.grad_fn is None
