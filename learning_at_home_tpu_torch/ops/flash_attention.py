"""Causal multi-head attention, forward and backward: the Hopper kernels and
their plain twins.

:func:`flash_attention` replaces ``learning_at_home_tpu/models/trunk.py``
lines 64-85, ``attention_core(impl="flash")``, which calls the library's
Pallas TPU kernel ``jax.experimental.pallas.ops.tpu.flash_attention``
(``causal=True``, ``sm_scale=1/sqrt(hd)``) and differentiates it through
the library's ``custom_vjp``.  Here the same pair is
:class:`FlashAttention`, a ``torch.autograd.Function``:

- forward (K5 fwd, :func:`flash_attention_fwd`): ``csrc/flash_attn_fwd.cu``
  writes ``o`` and, when the caller differentiates, the row log-sum-exp
  ``lse`` [B, H, S] f32 of the scaled logits, the one statistic that
  carries what the library saves as its row max ``m`` and sum ``l``;
- backward: ``di = rowsum(o * do)`` as a torch reduction (plain XLA in the
  library too), then the two kernels of ``csrc/flash_attn_bwd.cu``, K5 bwd
  dkv (:func:`flash_attention_dkv`, the library's
  ``_flash_attention_bwd_dkv``) and K5 bwd dq (:func:`flash_attention_dq`,
  ``_flash_attention_bwd_dq``).

Each wrapper launches its kernel on a CUDA tensor, or raises for inputs the
kernel does not take (bf16, head dim 64, contiguous head dim); on a CPU
tensor it computes its plain version (:func:`attention_fwd_reference`,
:func:`attention_bwd_reference`), so the CPU tests run the Function's own
forward and backward.  Nothing computes the plain version on the card.
Without a gradient to take (``torch.no_grad()``, serving) the forward
launches alone, writes no ``lse`` and saves nothing.

What bounds the kernels on the H100: the causal work of one product is
``2*B*H*hd*S*(S+1)/2`` operations against ``B*S*H*hd*2`` bytes an operand,
about 1000 operations per byte at [2, 4096, 8, 64], so tensor-core
throughput bounds them, not memory.  The plain form instead writes
``B*H*S*S*4`` bytes of f32 scores (1.1 GB at that shape, 8.6 GB at the
long-context training shape [4, 8192, 8, 64]); the kernels keep scores,
probabilities and their gradients in registers.  See the sources.

All three kernels are warp-specialised Hopper kernels: a producer thread
feeds 128-byte-swizzled tiles to two consumer warpgroups of 64 rows each
by TMA, and every product is a ``wgmma``.  What they need from the caller
is computed here, so the CPU tests reach it: :func:`tensor_map` (the TMA
tensor map of one input: dims, byte strides, box),
:func:`fwd_launch_geometry` and :func:`bwd_launch_geometry` (grid,
threads, dynamic shared memory).
"""

from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIM = 64  # the one head dim the kernels are specialised for
TILE = 64  # rows of every TMA box, of one 128-byte swizzle row each
# csrc/flash_attn_fwd.cu's launch geometry: a block owns FWD_ROWS queries,
# 64 per consumer warpgroup, and streams K/V tiles of FWD_KEYS keys
# through a ring of FWD_STAGES slots; two consumer warpgroups and one
# producer
FWD_ROWS, FWD_KEYS, FWD_STAGES = 128, 128, 4
FWD_THREADS = 3 * 128
# csrc/flash_attn_bwd.cu's: a block owns BWD_ROWS keys (dkv) or queries
# (dq), 64 per consumer warpgroup; the streamed tiles go through a ring of
# BWD_STAGES slots
BWD_ROWS, BWD_STAGES = 128, 4
BWD_THREADS = 3 * 128
_TMA_STRIDE_ALIGN = 16  # bytes: every TMA global stride and base address
_TMA_STRIDE_LIMIT = 1 << 40


# ---- plain versions ----


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16/f32 inputs (bf16 products are exact in f32); f64 stays
    f64, so the plain versions can be checked at f64."""
    return torch.promote_types(dtype, torch.float32)


def _scaled_scores(q: torch.Tensor, k: torch.Tensor):
    """Causally masked ``q k^T / sqrt(hd)`` [B, H, S, S] in the compute
    dtype, and the causal mask [S, S] (True on and below the diagonal)."""
    s, hd = q.shape[1], q.shape[-1]
    ct = _compute_dtype(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))
    scores = scores * (1.0 / math.sqrt(hd))
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~causal, float("-inf")), causal


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Causal attention on [B,S,H,hd] q/k/v, written plainly: scores from
    the inputs in f32 (bf16 products are exact in f32, so this is a bf16
    product with f32 accumulation), scale ``1/sqrt(hd)``, causal mask, f32
    softmax, probabilities cast to v's dtype, then ``@ v``.  The numerics
    of ``jax.nn.dot_product_attention(..., is_causal=True)``."""
    return attention_fwd_reference(q, k, v, with_lse=False)[0]


def attention_fwd_reference(q, k, v, with_lse: bool = True):
    """K5 fwd's function: ``(o, lse)``, ``o`` exactly
    :func:`attention_reference`'s and ``lse`` [B, H, S] the log-sum-exp of
    the scaled, masked scores in the compute dtype (None unless
    ``with_lse``)."""
    scores, _ = _scaled_scores(q, k)
    lse = torch.logsumexp(scores, dim=-1) if with_lse else None
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o * do)`` [B, H, S] in the compute dtype, as the
    library computes it (``flash_attention.py:273-275``)."""
    ct = _compute_dtype(o.dtype)
    return (o.to(ct) * do.to(ct)).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, do, lse, di, dq: bool = True, dkv: bool = True):
    """``(dq, dk, dv)`` of causal attention from the saved ``lse`` and
    ``di``, with the library's numerics (``flash_attention.py:894-920``):
    compute-dtype scores, ``p = exp(s * scale - lse)`` masked above the
    diagonal, ``p`` and ``ds = p * (dp - di) * scale`` rounded to the input
    dtype before the dV, dK and dQ products, compute-dtype accumulation,
    outputs in q's dtype.  ``dq=False`` leaves out dq and ``dkv=False``
    dk and dv (None in their place), as each kernel computes only its own.
    One batch row at a time, so only one row's [H, S, S] intermediates are
    live."""
    dt, ct = q.dtype, _compute_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    grads = []
    for i in range(q.shape[0]):
        qi, ki, vi, doi = (t[i: i + 1].to(ct) for t in (q, k, v, do))
        scores, causal = _scaled_scores(qi, ki)
        p = torch.exp(scores - lse[i: i + 1].to(ct)[..., None])
        p = p.masked_fill(~causal, 0.0)
        dv = (torch.einsum("bhqk,bqhd->bkhd", p.to(dt).to(ct), doi)
              if dkv else None)
        dp = torch.einsum("bqhd,bkhd->bhqk", doi, vi)
        ds = (p * (dp - di[i: i + 1].to(ct)[..., None]) * scale).to(dt).to(ct)
        del p, dp, scores
        grads.append((
            torch.einsum("bhqk,bkhd->bqhd", ds, ki) if dq else None,
            torch.einsum("bhqk,bqhd->bkhd", ds, qi) if dkv else None,
            dv,
        ))
    return tuple(None if g[0] is None else torch.cat(g).to(dt)
                 for g in zip(*grads))


def attention_bwd_reference(q, k, v, o, lse, do):
    """The whole K5 backward written plainly: ``(dq, dk, dv)`` from the
    forward's inputs, its output ``o`` and ``lse`` and the upstream
    gradient ``do``."""
    return _bwd_plain(q, k, v, do, lse, _row_dot(o, do))


# ---- kernel wrappers ----


def _kernel_layout(t: torch.Tensor) -> bool:
    """A [B,S,H,hd] layout the kernels read: contiguous head dim, other
    strides multiples of 8 elements, 16-byte aligned."""
    return (t.stride(-1) == 1 and not any(st % 8 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_cuda_inputs(*tensors: torch.Tensor) -> None:
    """q, k, v (and do), in that order."""
    q = tensors[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            "flash attention needs q, k, v (and do) of one shape "
            f"[B, S, H, hd], got {[tuple(t.shape) for t in tensors]}"
        )
    for name, t in zip(("q", "k", "v", "do"), tensors):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the flash-attention kernels take bfloat16, {name} is "
                f"{t.dtype}"
            )
        if not _kernel_layout(t):
            raise ValueError(
                f"{name} needs a contiguous head dim, other strides that are "
                f"multiples of 8 elements and 16-byte alignment, got strides "
                f"{t.stride()}"
            )
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"the flash-attention kernels are built for head dim {HEAD_DIM}, "
            f"got {q.shape[-1]}"
        )


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    b, s, h, _ = q.shape
    for t in stats:
        if (t.shape != (b, h, s) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"lse / di must be contiguous f32 [{b}, {h}, {s}] on "
                f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _strides(*tensors):
    """(batch, seq, head) element strides of each tensor, as int64s."""
    return [ctypes.c_int64(st) for t in tensors for st in t.stride()[:3]]


def tensor_map(t: torch.Tensor):
    """The TMA tensor map the kernels read a [B,S,H,hd] bf16 input
    through: ``(dims, byte_strides, box)``, dims innermost first
    ``(hd, S, H, B)``, the byte strides of S, H and B, and the box of one
    [TILE, hd] tile.  Raises ValueError for a layout TMA cannot take: a
    head dim that is not contiguous, a stride that is not a multiple of 16
    bytes (or not below 2^40), a base address that is not 16-byte
    aligned."""
    b, s, h, hd = t.shape
    size = t.element_size()
    strides = tuple(st * size for st in (t.stride(1), t.stride(2), t.stride(0)))
    if (t.stride(3) != 1
            or any(st % _TMA_STRIDE_ALIGN or not 0 <= st < _TMA_STRIDE_LIMIT
                   for st in strides)
            or t.data_ptr() % _TMA_STRIDE_ALIGN):
        raise ValueError(
            f"TMA needs a contiguous head dim, (seq, head, batch) strides "
            f"that are multiples of {_TMA_STRIDE_ALIGN} bytes and a "
            f"{_TMA_STRIDE_ALIGN}-byte aligned base; got element strides "
            f"{t.stride()} of {size}-byte elements at {t.data_ptr():#x}")
    return (hd, s, h, b), strides, (hd, TILE, 1, 1)


def fwd_launch_geometry(b: int, s: int, h: int):
    """``(grid, threads, smem_bytes)`` of the forward kernel on [b, s, h,
    64] inputs: one block per FWD_ROWS queries of each (batch, head);
    dynamic shared memory for the block's Q (FWD_ROWS rows), the ring of
    K/V tile pairs, 2 * FWD_STAGES + 1 mbarriers and 1 KB to align the
    tiles to the 128-byte swizzle's 1024-byte atom."""
    row = HEAD_DIM * 2
    smem = (FWD_ROWS * row + FWD_STAGES * 2 * FWD_KEYS * row
            + (2 * FWD_STAGES + 1) * 8 + 1024)
    return (-(-s // FWD_ROWS), h, b), FWD_THREADS, smem


def bwd_launch_geometry(kernel: str, b: int, s: int, h: int):
    """``(grid, threads, smem_bytes)`` of backward kernel ``kernel`` ("dkv"
    or "dq") on [b, s, h, 64] inputs: one block per BWD_ROWS rows of each
    (batch, head); dynamic shared memory for the owned rows' two operands,
    the ring of streamed tile pairs (and, for dkv, each stage's 64 lse and
    di floats), 2 * BWD_STAGES + 1 mbarriers and 1 KB to align the tiles
    to the 128-byte swizzle's 1024-byte atom."""
    if kernel not in ("dkv", "dq"):
        raise ValueError(f"no backward kernel {kernel!r}")
    tile = TILE * HEAD_DIM * 2
    stats = 2 * TILE * 4 if kernel == "dkv" else 0
    smem = (2 * (BWD_ROWS // TILE) * tile
            + BWD_STAGES * (2 * tile + stats)
            + (2 * BWD_STAGES + 1) * 8 + 1024)
    return (-(-s // BWD_ROWS), h, b), BWD_THREADS, smem


def _launch(library: str, symbol: str, q: torch.Tensor, args) -> None:
    """Call ``symbol`` of kernel library ``library`` (built at first use)
    with ``args`` (ctypes values), the scale and the current stream.
    Raises if the launch was refused."""
    from learning_at_home_tpu_torch.ops.build import load_library

    fn = getattr(load_library(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = [type(a) for a in args] + [ctypes.c_float,
                                                 ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, 1.0 / math.sqrt(q.shape[-1]), stream)
    if err < 0:
        raise RuntimeError(
            f"{symbol}: a TMA tensor map could not be encoded ("
            + ("the driver lacks cuTensorMapEncodeTiled)" if err == -1
               else f"CUresult {-1000 - err})"))
    if err:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def _pointers(*tensors):
    return [ctypes.c_void_p(None if t is None else t.data_ptr())
            for t in tensors]


def _shape_args(q: torch.Tensor):
    return [ctypes.c_int(n) for n in q.shape[:3]]


def _in_strides(*inputs):
    """The inputs' TMA byte strides (3 each), as a C int64 array."""
    st = [x for t in inputs for x in tensor_map(t)[1]]
    return ctypes.cast((ctypes.c_int64 * len(st))(*st),
                       ctypes.POINTER(ctypes.c_int64))


def _fwd_args(q, k, v, o, lse):
    """The forward entry point's arguments before the scale: the
    pointers, B, S, H, the inputs' TMA byte strides, o's element strides,
    grid x and shared-memory bytes."""
    grid, _, smem = fwd_launch_geometry(*q.shape[:3])
    return (_pointers(q, k, v, o, lse) + _shape_args(q)
            + [_in_strides(q, k, v)] + _strides(o)
            + [ctypes.c_int(grid[0]), ctypes.c_int(smem)])


def _bwd_args(kernel: str, q, k, v, do, lse, di, *outs):
    """The backward entry points' arguments before the scale: the
    pointers, B, S, H, the inputs' TMA byte strides, the outputs' element
    strides, grid x and shared-memory bytes."""
    grid, _, smem = bwd_launch_geometry(kernel, *q.shape[:3])
    return (_pointers(q, k, v, do, lse, di, *outs) + _shape_args(q)
            + [_in_strides(q, k, v, do)] + _strides(*outs)
            + [ctypes.c_int(grid[0]), ctypes.c_int(smem)])


def _on_cpu(q: torch.Tensor, name: str) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return False


def flash_attention_fwd(q, k, v, with_lse: bool = True):
    """K5 fwd: ``(o, lse)`` for [B,S,H,hd] q/k/v, ``o`` [B,S,H,hd] in q's
    dtype and ``lse`` [B,H,S] f32 (None unless ``with_lse``: the kernel then
    writes nothing more than ``o``).  CPU tensors take
    :func:`attention_fwd_reference`; CUDA tensors launch the kernel
    (``flash_attention.launches`` counts the launches)."""
    if _on_cpu(q, "flash_attention"):
        with torch.no_grad():
            return attention_fwd_reference(q, k, v, with_lse)
    _check_cuda_inputs(q, k, v)
    b, s, h, hd = q.shape
    o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel():
        _launch("flash_attn_fwd", "lah_flash_attn_fwd_bf16", q,
                _fwd_args(q, k, v, o, lse))
        flash_attention.launches += 1
    return o, lse


def flash_attention_dkv(q, k, v, do, lse, di):
    """K5 bwd dkv: ``(dk, dv)`` [B,S,H,hd] in q's dtype from q, k, v, the
    upstream gradient ``do``, the forward's ``lse`` and ``di`` (both
    [B,H,S] f32).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (``flash_attention_dkv.launches``)."""
    if _on_cpu(q, "flash_attention_dkv"):
        return _bwd_plain(q, k, v, do, lse, di, dq=False)[1:]
    _check_cuda_inputs(q, k, v, do)
    _check_stats(q, lse, di)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if q.numel():
        _launch("flash_attn_bwd", "lah_flash_attn_bwd_dkv_bf16", q,
                _bwd_args("dkv", q, k, v, do, lse, di, dk, dv))
        flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, di):
    """K5 bwd dq: ``dq`` [B,S,H,hd] in q's dtype from the same inputs as
    :func:`flash_attention_dkv`.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``flash_attention_dq.launches``)."""
    if _on_cpu(q, "flash_attention_dq"):
        return _bwd_plain(q, k, v, do, lse, di, dkv=False)[0]
    _check_cuda_inputs(q, k, v, do)
    _check_stats(q, lse, di)
    dq = torch.empty_like(q)
    if q.numel():
        _launch("flash_attn_bwd", "lah_flash_attn_bwd_dq_bf16", q,
                _bwd_args("dq", q, k, v, do, lse, di, dq))
        flash_attention_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do):
    """The K5 backward: ``di`` by a torch reduction, then the dkv and dq
    kernels (their plain versions on CPU tensors).  Returns
    ``(dq, dk, dv)``."""
    if not _on_cpu(q, "flash_attention") and not _kernel_layout(do):
        do = do.contiguous()  # a layout the kernels read; same values
    di = _row_dot(o, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    return flash_attention_dq(q, k, v, do, lse, di), dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention of [B,S,H,hd] q/k/v: forward K5 fwd (saves q, k,
    v, o and lse), backward the dkv and dq kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Causal attention on [B,S,H,hd] q/k/v, scale ``1/sqrt(hd)``; returns
    [B,S,H,hd] in q's dtype, differentiable in q, k and v through
    :class:`FlashAttention`.

    CPU tensors take the plain versions.  CUDA tensors launch the Hopper
    kernels (bf16, head dim 64, any S) on the current stream, or raise for
    inputs they do not take.  With nothing to differentiate only the
    forward kernel runs, without ``lse``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v, with_lse=False)[0]


flash_attention.launches = 0
flash_attention_dkv.launches = 0
flash_attention_dq.launches = 0
