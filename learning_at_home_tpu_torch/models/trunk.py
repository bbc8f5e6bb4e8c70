"""Transformer trunk pieces shared by the port's models.

The PyTorch counterpart of ``learning_at_home_tpu/models/trunk.py``: the
layer norm, the Q/K/V and output projections, and causal attention over
[B,S,H,hd] tensors, with the JAX package's numerics (f32 norm statistics,
f32 softmax, ``1/sqrt(hd)`` scale).
"""

from __future__ import annotations

import math

import torch

from learning_at_home_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pre-LN in float32 (population variance, eps 1e-5), cast back to the
    input dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def qkv_projections(lp: dict, x: torch.Tensor, n_heads: int):
    """Q/K/V projections: [B,S,d] → three [B,S,H,hd]."""
    b, s, d = x.shape
    hd = d // n_heads
    q = (x @ lp["wq"].to(x.dtype)).reshape(b, s, n_heads, hd)
    k = (x @ lp["wk"].to(x.dtype)).reshape(b, s, n_heads, hd)
    v = (x @ lp["wv"].to(x.dtype)).reshape(b, s, n_heads, hd)
    return q, k, v


def output_projection(lp: dict, out: torch.Tensor) -> torch.Tensor:
    """[B,S,H,hd] → [B,S,d] @ wo."""
    b, s, h, hd = out.shape
    return out.reshape(b, s, h * hd) @ lp["wo"].to(out.dtype)


def causal_attention(
    lp: dict, x: torch.Tensor, n_heads: int, impl: str = "xla"
) -> torch.Tensor:
    """Multi-head causal self-attention of [B,S,d] ``x``; ``impl`` as in
    :func:`attention_core`."""
    q, k, v = qkv_projections(lp, x, n_heads)
    return output_projection(lp, attention_core(q, k, v, impl))


def attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "xla"
) -> torch.Tensor:
    """Causal attention on pre-projected [B,S,H,hd] q/k/v.

    ``impl="xla"`` is the plain version (scores materialised, the numerics
    of ``jax.nn.dot_product_attention``); ``impl="flash"`` is the Hopper
    kernel for CUDA tensors (``ops/flash_attention.py``), which on CPU
    tensors computes the same plain version.  The names follow the JAX
    package's ``attn_impl`` values."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"impl must be 'xla' or 'flash', got {impl!r}")
    if impl == "flash":
        return flash_attention(q, k, v)
    return attention_reference(q, k, v)


def one_query_attention(
    lp: dict, q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, t
) -> torch.Tensor:
    """Attention for the query rows ``q`` [B,Q,H,hd] over a KV cache
    [B,S,H,hd] whose positions after ``t`` are masked; ``t`` is an int or
    anything that broadcasts against the [B,H,Q,S] scores.  f32 softmax,
    ``1/sqrt(hd)`` scale, then the output projection."""
    hd = q.shape[-1]
    scores = torch.einsum(
        "bqhd,bshd->bhqs", q.float(), k_cache.float()
    ) * (1.0 / math.sqrt(hd))
    s = k_cache.shape[1]
    mask = torch.arange(s, device=q.device)[None, None, None, :] <= t
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", w, v_cache)
    return output_projection(lp, out)


def gather_kv_pages(pool: torch.Tensor,
                    page_tables: torch.Tensor) -> torch.Tensor:
    """[num_pages,P,H,hd] pool + [B,n] integer page tables → a
    [B,n*P,H,hd] contiguous per-row KV view.  Unmapped table entries point
    at scratch page 0; its (finite: the pools start zeroed) contents sit at
    positions the caller's ``t`` mask excludes, so the softmax gives them
    weight exactly 0 and the output is bitwise what a dense cache gives."""
    b, n = page_tables.shape
    _, page_len, h, hd = pool.shape
    return pool[page_tables.long()].reshape(b, n * page_len, h, hd)


def paged_one_query_attention(
    lp: dict, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    page_tables: torch.Tensor, t,
) -> torch.Tensor:
    """:func:`one_query_attention` over a paged KV cache: each row's cache
    is gathered from the shared page pool through its page table, then the
    same masked-softmax core runs on the view, so paged decoding equals
    dense decoding bit for bit by construction."""
    k = gather_kv_pages(k_pool, page_tables)
    v = gather_kv_pages(v_pool, page_tables)
    return one_query_attention(lp, q, k, v, t)
