"""Ring attention: sequence parallelism over a mesh's ``seq`` axis.

The counterpart of ``learning_at_home_tpu/parallel/ring_attention.py``.
Each rank holds one chunk of the sequence's queries and passes its K/V
chunk around the ring (``comm.ppermute``),
accumulating the output with the online-softmax recurrence in f32.  Causal
masking across chunks is by chunk index, as in the JAX module.  The JAX
block attention is XLA inside a ``fori_loop``, not a Pallas kernel, so the
port is plain torch; its gradient is autograd's through the ``ppermute``
Function, whose backward sends each cotangent back along the inverse
permutation.  K and V travel as one stacked tensor, one ``ppermute`` a
step, so every rank's backward issues the same collectives in the same
order.

:func:`ring_attention_local` (contiguous chunks, causal or not) and
:func:`ring_attention_local_zigzag` (the balanced causal layout: rank i
holds global chunks i and 2n-1-i) take the rank's own chunk, as the JAX
functions do inside ``shard_map``; :func:`make_ring_attention` wraps them
for global [B, S, H, hd] tensors that every rank holds (the JAX wrapper's
arguments), with its validation errors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from learning_at_home_tpu_torch.parallel import comm


def _online_softmax_update(o, l, m, scores, v_chunk):
    """One flash-attention accumulation step.

    o: [B, Sq, H, hd] running (unnormalized) output; l, m: [B, H, Sq]
    running denominator and max; scores: [B, H, Sq, Sk]; v_chunk:
    [B, Sk, H, hd]."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_chunk)
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return o_new, l_new, m_new


def _scores(q32, k_chunk, scale):
    return torch.einsum("bqhd,bkhd->bhqk", q32, k_chunk.float()) * scale


def _normalise(o, l):
    denom = torch.clamp(l, min=torch.finfo(torch.float32).tiny)
    return o / denom.transpose(1, 2)[..., None]


def _ring_step(kv, mesh, axis_name, r, n):
    """The K/V pair for step r + 1: each rank's goes to its successor."""
    if r == n - 1:
        return kv
    return comm.ppermute(kv, mesh, axis_name,
                         [(i, (i + 1) % n) for i in range(n)])


def ring_attention_local(q, k, v, mesh, axis_name: str = "seq",
                         causal: bool = True) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis_name``: q/k/v
    [B, S_local, H, hd] are this rank's contiguous chunk; returns its
    output chunk in q's dtype."""
    n = mesh.size(axis_name)
    my = mesh.index(axis_name)
    b, s_local, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    q32 = q.float()
    dev = q.device
    o = torch.zeros((b, s_local, h, hd), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=dev)
    m = torch.full((b, h, s_local), -math.inf, dtype=torch.float32, device=dev)
    tri = torch.ones((s_local, s_local), dtype=torch.bool, device=dev).tril()
    kv = torch.stack([k, v])
    for r in range(n):
        src = (my - r) % n  # the global chunk kv holds this step
        scores = _scores(q32, kv[0], scale)
        if causal:
            if src > my:  # a later chunk: nothing to attend to
                scores = scores.masked_fill(
                    torch.ones_like(tri)[None, None], -math.inf)
            elif src == my:  # the own chunk: lower triangle
                scores = scores.masked_fill(~tri[None, None], -math.inf)
        o, l, m = _online_softmax_update(o, l, m, scores, kv[1])
        kv = _ring_step(kv, mesh, axis_name, r, n)
    return _normalise(o, l).to(q.dtype)


def ring_attention_local_zigzag(q, k, v, mesh,
                                axis_name: str = "seq") -> torch.Tensor:
    """Causal ring attention over the ZIGZAG layout: q/k/v [B, 2c, H, hd]
    are this rank's (chunk my, chunk 2n-1-my) pair; every ring step has one
    live half-chunk block per rank (plus the diagonals on step 0), so the
    causal savings are balanced.  Returns the output in the same layout."""
    n = mesh.size(axis_name)
    my = mesh.index(axis_name)
    b, s2, h, hd = q.shape
    c = s2 // 2
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    tri = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    q32 = q.float()
    q_lo, q_hi = q32[:, :c], q32[:, c:]

    def blk(qh, kc, vc, olm, mask=None):
        o, l, m = olm
        scores = _scores(qh, kc, scale)
        if mask is not None:
            scores = scores.masked_fill(~mask[None, None], -math.inf)
        return _online_softmax_update(o, l, m, scores, vc)

    def zeros_olm():
        return (torch.zeros((b, c, h, hd), dtype=torch.float32, device=dev),
                torch.zeros((b, h, c), dtype=torch.float32, device=dev),
                torch.full((b, h, c), -math.inf, dtype=torch.float32,
                           device=dev))

    lo, hi = zeros_olm(), zeros_olm()
    kv = torch.stack([k, v])
    for r in range(n):
        src = (my - r) % n  # the rank whose chunk pair this is
        klo, khi = kv[0][:, :c], kv[0][:, c:]
        vlo, vhi = kv[1][:, :c], kv[1][:, c:]
        # q_hi against klo: chunk src < n <= 2n-1-my, always whole
        hi = blk(q_hi, klo, vlo, hi)
        if src == my:  # step 0: both diagonals
            lo = blk(q_lo, klo, vlo, lo, tri)
            hi = blk(q_hi, khi, vhi, hi, tri)
        elif src < my:  # klo is an earlier chunk than chunk my
            lo = blk(q_lo, klo, vlo, lo)
        else:  # 2n-1-src < 2n-1-my
            hi = blk(q_hi, khi, vhi, hi)
        kv = _ring_step(kv, mesh, axis_name, r, n)
    out = torch.cat([_normalise(lo[0], lo[1]), _normalise(hi[0], hi[1])],
                    dim=1)
    return out.to(q.dtype)


def zigzag_indices(seq_len: int, n_shards: int) -> np.ndarray:
    """Global row order realizing the zigzag layout: rank i's contiguous
    shard = (chunk i, chunk 2n-1-i), chunk size seq_len/(2n)."""
    if seq_len % (2 * n_shards):
        raise ValueError(
            f"zigzag needs seq_len divisible by 2*{n_shards}, got {seq_len}"
        )
    c = seq_len // (2 * n_shards)
    order = []
    for i in range(n_shards):
        order.append(np.arange(i * c, (i + 1) * c))
        j = 2 * n_shards - 1 - i
        order.append(np.arange(j * c, (j + 1) * c))
    return np.concatenate(order)


def local_ring_fn(mesh, axis_name: str = "seq", causal: bool = True,
                  layout: str = "contiguous"):
    """The ring over this rank's own chunk in ``layout``."""
    if layout == "zigzag":
        return functools.partial(ring_attention_local_zigzag, mesh=mesh,
                                 axis_name=axis_name)
    return functools.partial(ring_attention_local, mesh=mesh,
                             axis_name=axis_name, causal=causal)


def make_ring_attention(mesh, axis_name: str = "seq", causal: bool = True,
                        layout: str = "contiguous",
                        pre_permuted: bool = False):
    """Ring attention over global [B, S, H, hd] q/k/v that every rank
    holds alike; returns the global output on every rank.  Each rank takes
    its chunk (in the zigzag order with ``layout="zigzag"``, unless the
    caller's sequence is already permuted: ``pre_permuted=True``), runs the
    ring on it, and the chunks are gathered back.  The gradient reaches
    every rank whole (``comm.shard_replicated``).  ``"zigzag"`` is causal
    only; ``"contiguous"`` computes and masks every block."""
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"mesh has no {axis_name!r} axis (axes: {mesh.axis_names})"
        )
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be contiguous|zigzag, got {layout!r}")
    if layout == "zigzag" and not causal:
        raise ValueError("zigzag layout only balances CAUSAL attention")
    n_shards = mesh.size(axis_name)
    local_fn = local_ring_fn(mesh, axis_name, causal, layout)

    def fn(q, k, v):
        if not (q.shape == k.shape == v.shape):
            raise ValueError(
                f"q/k/v shapes must match, got {tuple(q.shape)}/"
                f"{tuple(k.shape)}/{tuple(v.shape)}"
            )
        if q.shape[1] % n_shards:
            raise ValueError(
                f"sequence length {q.shape[1]} must divide across the "
                f"{n_shards} shards of mesh axis {axis_name!r}"
            )
        if layout == "zigzag" and q.shape[1] % (2 * n_shards):
            raise ValueError(
                f"zigzag needs seq_len divisible by 2*{n_shards} shards, "
                f"got {q.shape[1]}"
            )
        permute = layout == "zigzag" and not pre_permuted
        if permute:
            zig = torch.as_tensor(zigzag_indices(q.shape[1], n_shards),
                                  device=q.device)
            q, k, v = q[:, zig], k[:, zig], v[:, zig]
        chunks = [comm.shard_replicated(t, mesh, axis_name, 1)
                  for t in (q, k, v)]
        out = comm.gather_replicated(local_fn(*chunks), mesh, axis_name, 1)
        if permute:
            out = out[:, torch.argsort(zig)]
        return out

    return fn
