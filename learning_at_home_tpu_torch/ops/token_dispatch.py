"""MoE token dispatch: the Hopper kernel K4 and its guarded entry point.

The PyTorch counterpart of ``learning_at_home_tpu/ops/pallas_dispatch.py``.
:func:`dispatch_tokens_kernel` (the counterpart of
``dispatch_tokens_pallas``) scatters tokens into their capacity buckets
from an :class:`~learning_at_home_tpu_torch.ops.moe_dispatch.IndexDispatchPlan`:

    x [n, d]  +  token_for_slot [E, C]  →  [E, C, d], empty slots zero

On a CUDA tensor it launches the kernel of ``csrc/token_dispatch.cu``,
which copies each filled slot's row exactly, so its output equals the
plain version, ``moe_dispatch.dispatch_tokens_indexed``, bit for bit.  On
a CPU tensor it runs that plain version.  The TPU kernel selects each row
from an 8-row chunk with a masked sum, which turns a ``-0.0`` into
``+0.0``; there the two differ in those sign bits only.

The JAX kernel has no gradient, and neither has this one: called with
gradients enabled on an ``x`` that requires them, it raises rather than
return an output that autograd would silently cut off.

:func:`dispatch_tokens_auto` is the counterpart of the JAX guard.  The
JAX guard's conditions (``d % 128``, ``n % 8``, ``E*C % 8``) are the TPU's
tiling rules; the Hopper kernel takes any ``d``, ``n >= 1`` and
``E*C >= 1`` in bf16, f16 or f32, so ``use_kernel=True`` always takes the
kernel.  As in the JAX package, no model path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from learning_at_home_tpu_torch.ops.moe_dispatch import (
    IndexDispatchPlan,
    dispatch_tokens_indexed,
)

DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _function():
    from learning_at_home_tpu_torch.ops.build import load_library

    fn = load_library("token_dispatch").lah_token_dispatch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, p, p, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    return fn


def _validate(x: torch.Tensor, token_for_slot: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [n, d], got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"token dispatch takes {DTYPES}, x is {x.dtype}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must have n >= 1 and d >= 1, got "
                         f"{tuple(x.shape)}")
    if token_for_slot.dim() != 2 or token_for_slot.numel() < 1:
        raise ValueError(f"token_for_slot must be [E, C] with E*C >= 1, got "
                         f"shape {tuple(token_for_slot.shape)}")
    if token_for_slot.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"token_for_slot must be int32 or int64, got "
                        f"{token_for_slot.dtype}")
    if token_for_slot.device != x.device:
        raise ValueError(f"token_for_slot is on {token_for_slot.device}, x "
                         f"on {x.device}")


def dispatch_tokens_kernel(x: torch.Tensor,
                           plan: IndexDispatchPlan) -> torch.Tensor:
    """K4: [n, d] → [E, C, d], row ``token_for_slot[e, c]`` of ``x`` in
    each slot and zeros where it is -1.  CPU tensors take
    ``dispatch_tokens_indexed``; CUDA tensors launch the kernel
    (``dispatch_tokens_kernel.launches`` counts them).  Raises when
    gradients are enabled and ``x`` requires them."""
    tfs = plan.token_for_slot
    _validate(x, tfs)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "the token-dispatch kernel has no gradient (nor has the TPU "
            "kernel it ports): call it under torch.no_grad() or on a "
            "tensor that does not require grad, or use "
            "dispatch_tokens_indexed")
    if x.device.type == "cpu":
        return dispatch_tokens_indexed(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"token dispatch runs on cpu or cuda, not {x.device}")
    if x.stride(1) != 1:
        x = x.contiguous()
    num_experts, capacity = tfs.shape
    n, d = x.shape
    idx = tfs.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((num_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    size = x.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _function()(x.data_ptr(), x.stride(0) * size, idx.data_ptr(),
                          out.data_ptr(), n, idx.numel(), d * size, stream)
    if err:
        raise RuntimeError(f"token_dispatch launch failed: CUDA error {err}")
    dispatch_tokens_kernel.launches += 1
    return out


dispatch_tokens_kernel.launches = 0


def dispatch_tokens_auto(x: torch.Tensor, plan: IndexDispatchPlan,
                         use_kernel: bool = False) -> torch.Tensor:
    """The kernel when ``use_kernel`` (on a CPU tensor, its plain
    version), else ``dispatch_tokens_indexed``."""
    if use_kernel:
        return dispatch_tokens_kernel(x, plan)
    return dispatch_tokens_indexed(x, plan)
