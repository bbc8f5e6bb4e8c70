"""Differentiable collectives over a mesh's process groups.

In the JAX package the pod tier's collectives are ``lax`` primitives inside
``shard_map`` and autodiff transposes them.  Here each one is a
``torch.autograd.Function`` whose backward is that transpose:

- :func:`all_to_all` -- ``lax.all_to_all(x, axis, 0, 0, tiled=False)``
  over the leading dim; its own transpose;
- :func:`psum` and :func:`psum_grad` -- Megatron's conjugate pair: an
  all-reduce forward with an identity backward after a row-split product,
  and an identity forward with an all-reduce backward before a
  column-split one;
- :func:`pmean` -- an all-reduce mean both ways;
- :func:`ppermute` -- ``lax.ppermute(x, axis, perm)``; its backward sends
  the cotangents along the inverse permutation;
- :func:`all_gather` -- the concatenation of the peers' tensors along a
  dim; its backward sums the cotangents over the peers and keeps this
  rank's chunk;
- :func:`shard_replicated` and :func:`gather_replicated` -- a rank's
  chunk of a tensor every peer holds alike, and the gather back into one:
  the boundaries of a sharded step inside a replicated computation (the
  cotangent of a replicated value is replicated too, so neither sums it).

Every function takes the mesh (``parallel.mesh.Mesh``) and the axis or
axes to act over, and is the identity over axes of size 1
(no copy, no communication), so a mesh of one rank computes what the
single-device path computes.  The backend is the one the caller gave the
process group: ``nccl`` (one rank per card) takes card tensors as they are;
over ``gloo`` a card tensor is staged through pinned host buffers, which
the mesh decides from its backend and device (``Mesh.stage``), never by
catching an error.  :func:`all_reduce_` and :func:`all_reduce_tensors_`
are the plain in-place all-reduces of gradient and statistic reductions.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _host(t: torch.Tensor, stage: bool) -> torch.Tensor:
    """The tensor a collective is given: a host copy when the mesh stages
    (``Mesh.stage``: card tensors over gloo; pinned memory from the card,
    which torch's host allocator caches), else ``t`` made contiguous."""
    if stage:
        buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                          pin_memory=t.is_cuda)
        return buf.copy_(t.detach())
    return t.contiguous()


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t if t.device == like.device else t.to(like.device)


def all_reduce_(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``t`` all-reduced in place over ``axes`` (no autograd); returns it."""
    group = mesh.group(_axes(axes))
    if group is None:
        return t
    buf = _host(t, mesh.stage)
    dist.all_reduce(buf, op=op, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def _all_reduce(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A new tensor: ``t`` summed over the group (``t`` untouched)."""
    group = mesh.group(axes)
    buf = _host(t, mesh.stage)
    if buf is t or buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    return _back(buf, t)


def _all_to_all_raw(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    buf = _host(x, mesh.stage)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group((axis,)))
    return _back(out, x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x [n, ...] with n the size of ``axis``: slice j goes to peer j, and
    slice j of the result is what peer j sent this rank."""
    n = mesh.size(axis)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} needs a leading dim of "
                         f"{n}, got {tuple(x.shape)}")
    return _AllToAll.apply(x, mesh, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of each rank's ``x``; the cotangent passes
    through unchanged (the row-split half of Megatron's pair: every peer
    holds the same cotangent of the sum)."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return x
    return _Psum.apply(x, mesh, axes)


def psum_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` unchanged; its cotangent is summed over ``axes`` (the
    column-split half of Megatron's pair: each peer's product sees part of
    the input's cotangent)."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return x
    return _PsumGrad.apply(x, mesh, axes)


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes) / mesh.size(axes)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.mesh, ctx.axes) / ctx.mesh.size(ctx.axes),
                None, None)


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean over ``axes`` of each rank's ``x`` (``lax.pmean``); the
    cotangent is averaged the same way (its transpose)."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return x
    return _Pmean.apply(x, mesh, axes)


def _permute_raw(x: torch.Tensor, mesh, axis: str,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """One all-to-all with uneven splits: this rank's ``x`` goes to its
    destination under ``perm`` and the result is what its source sent
    (zeros where no pair names this rank as a destination)."""
    me = mesh.index(axis)
    n = mesh.size(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    numel = x.numel()
    send_sizes = [0] * n
    recv_sizes = [0] * n
    if dst:
        send_sizes[dst[0]] = numel
    if src:
        recv_sizes[src[0]] = numel
    buf = _host(x, mesh.stage).reshape(-1)
    out = torch.zeros(numel if src else 0, dtype=buf.dtype, device=buf.device)
    dist.all_to_all_single(out, buf if dst else buf[:0], recv_sizes,
                           send_sizes, group=mesh.group((axis,)))
    if not src:
        out = torch.zeros(numel, dtype=buf.dtype, device=buf.device)
    return _back(out.reshape(x.shape), x)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute_raw(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute_raw(g, ctx.mesh, ctx.axis, inverse), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` lists (source, destination) pairs of
    indices along ``axis``; a rank that no pair names as a destination
    gets zeros.  The backward sends each cotangent back from destination
    to source."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute needs a permutation, got {perm}")
    if mesh.size(axis) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Ppermute.apply(x, mesh, axis, perm)


def _gather_raw(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    buf = _host(x, mesh.stage)
    if buf.dim() == 0:
        buf = buf.reshape(1)
    out = torch.empty((n * buf.shape[0], *buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=mesh.group(axes))
    out = torch.cat(out.reshape(n, *buf.shape).unbind(0), dim=dim)
    return _back(out, x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.size = x.shape[dim]
        return _gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g.contiguous(), ctx.mesh, ctx.axes)
        i = ctx.mesh.index(ctx.axes)
        return (total.narrow(ctx.dim, i * ctx.size, ctx.size), None, None,
                None)


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The peers' ``x`` concatenated along ``dim`` in their order over
    ``axes``; the backward sums the cotangents over the peers and returns
    this rank's chunk (the transpose of a gather)."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return x
    dim = dim % x.dim()
    if not x.requires_grad or not torch.is_grad_enabled():
        return _gather_raw(x, mesh, axes, dim)
    return _AllGather.apply(x, mesh, axes, dim)


class _ShardReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n, i = mesh.size(axes), mesh.index(axes)
        size = x.shape[dim] // n
        return x.narrow(dim, i * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.size = mesh, axes, dim, x.shape[dim]
        return _gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axes)
        return (g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(), None,
                None, None)


def shard_replicated(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a tensor every rank holds whole
    (a value computed alike on every peer); the backward gathers the
    chunks' cotangents, so every peer gets the whole gradient.  With
    :func:`gather_replicated` it runs one sharded step inside a computation
    that is replicated over ``axes``, as ``shard_map`` does between two
    replicated specs."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % mesh.size(axes):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over "
                         f"{mesh.size(axes)} ranks of {axes}")
    return _ShardReplicated.apply(x, mesh, axes, dim)


def gather_replicated(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The peers' chunks concatenated along ``dim`` into a tensor every
    rank then holds whole; the backward keeps this rank's chunk of the
    (replicated) cotangent.  See :func:`shard_replicated`."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return x
    return _GatherReplicated.apply(x, mesh, axes, dim % x.dim())


# the largest buffer one all-reduce of all_reduce_tensors_ flattens
# tensors into (a tensor larger than it goes alone): it bounds the extra
# card and (staged) host memory of a gradient reduction
BUCKET_BYTES = 64 << 20


@torch.no_grad()
def all_reduce_tensors_(tensors, mesh, axes) -> None:
    """Sums each tensor of ``tensors`` over ``axes`` in place: tensors of
    one dtype flattened into buckets of at most ``BUCKET_BYTES``, one
    collective a bucket, in the tensors' order."""
    axes = _axes(axes)
    if mesh.size(axes) == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket, size = [], 0
        for t in group + [None]:
            nbytes = 0 if t is None else t.numel() * t.element_size()
            if bucket and (t is None or size + nbytes > BUCKET_BYTES):
                _reduce_bucket(bucket, mesh, axes)
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += nbytes


def _reduce_bucket(bucket, mesh, axes) -> None:
    if len(bucket) == 1 and bucket[0].is_contiguous():
        all_reduce_(bucket[0], mesh, axes)
        return
    flat = torch.cat([t.reshape(-1) for t in bucket])
    all_reduce_(flat, mesh, axes)
    offset = 0
    for t in bucket:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()
