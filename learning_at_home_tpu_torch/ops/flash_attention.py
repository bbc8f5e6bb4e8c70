"""Causal multi-head attention forward: the Hopper kernel and its plain twin.

:func:`flash_attention` replaces ``learning_at_home_tpu/models/trunk.py``
lines 64-85, ``attention_core(impl="flash")``, which calls the library's
Pallas TPU kernel ``jax.experimental.pallas.ops.tpu.flash_attention``
(``causal=True``, ``sm_scale=1/sqrt(hd)``).  On a CUDA tensor it launches
``csrc/flash_attn_fwd.cu``; on a CPU tensor it computes
:func:`attention_reference`, the same function written plainly.

What bounds the kernel on the H100: causal work of
``4*B*H*hd*S*(S+1)/2`` operations against ``4*B*S*H*hd*2`` bytes of q, k,
v and o -- about 1000 operations per byte at the serving prefill
(B=2, H=8, S=4096, hd=64), so it is bound by tensor-core throughput, not
memory.  The plain form instead writes ``B*H*S*S*4`` bytes of f32 scores
(1.1 GB at that shape); the kernel keeps scores and probabilities in
registers, runs both products on the tensor cores with f32 accumulators
and skips every K/V tile above the causal diagonal.  See the source for
the tiling.
"""

from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIM = 64  # the one head dim the kernel is specialised for


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Causal attention on [B,S,H,hd] q/k/v, written plainly: scores from
    the inputs in f32 (bf16 products are exact in f32, so this is a bf16
    product with f32 accumulation), scale ``1/sqrt(hd)``, causal mask, f32
    softmax, probabilities cast to v's dtype, then ``@ v``.  The numerics
    of ``jax.nn.dot_product_attention(..., is_causal=True)``."""
    s, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd))
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention needs q, k and v of one shape [B, S, H, hd], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the flash-attention kernel takes bfloat16, {name} is {t.dtype}"
            )
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(
                f"{name} needs a contiguous head dim and other strides that "
                f"are multiples of 8 elements, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"the flash-attention kernel is built for head dim {HEAD_DIM}, "
            f"got {q.shape[-1]}"
        )


def _kernel():
    from learning_at_home_tpu_torch.ops.build import load_library

    fn = load_library("flash_attn_fwd").lah_flash_attn_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 3
            + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Causal attention on [B,S,H,hd] q/k/v, scale ``1/sqrt(hd)``; returns
    [B,S,H,hd] in q's dtype.

    CPU tensors take :func:`attention_reference`.  CUDA tensors launch the
    Hopper kernel (bf16, head dim 64, any S) on the current stream, or
    raise for inputs it does not take; ``flash_attention.launches``
    counts the launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k, v)
    b, s, h, hd = q.shape
    o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 1.0 / math.sqrt(hd), stream,
        )
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
