"""Fused softmax cross-entropy: the Hopper kernels K1-K3 and their plain twins.

The PyTorch counterpart of ``learning_at_home_tpu/ops/fused_ce.py``.  The
per-row softmax cross-entropy of ``x @ head`` against integer targets is
computed without ever writing the [n, V] logits to device memory:

- forward (K1, :func:`ce_forward`): one pass over vocab tiles keeps a
  running max, sum of exp and target logit per row and writes only
  ``ce [n]`` and the residual ``lse [n]``;
- backward (K2, :func:`ce_dx`, and K3, :func:`ce_dhead`): each recomputes
  the logits tiles from (x, head, lse) and feeds
  ``dl = (softmax - onehot) * dce`` straight into its product, dx
  accumulating over vocab tiles and dhead over row tiles.

On a CUDA tensor each wrapper launches its kernel (bf16 operands, D in
{128, 256, 384, 512}) or raises: K1 is ``csrc/fused_ce_fwd.cu``, K2 and
K3 are one template in ``csrc/fused_ce.cu``, all warp-specialised
``wgmma`` kernels fed by TMA.  On a CPU tensor each computes its plain version
(:func:`ce_fwd_reference`, :func:`ce_dx_reference`,
:func:`ce_dhead_reference`), the same function written with the logits
materialised.  :class:`FusedSoftmaxCE` ties them into one autograd
function whose forward is K1 and whose backward is K2 then K3, so the
CPU tests exercise the same custom backward the kernels implement.

A target outside ``[0, V)`` picks no logit (``ce = lse``) and adds no
one-hot term, as in the JAX kernels.  ``block_n``/``block_v`` are the
TPU tiles: they only decide, through :func:`_check`, which shapes take
the fused path (the same predicate as the JAX package); the Hopper
kernels tile themselves (K1: 128 rows of x a block, 128 vocab columns a
tile; K2 and K3: 64 fixed rows a block, x rows for K2 and vocab rows for
K3, and 64-row tiles of the other operand streamed past them).  The
kernels read the head as
``head.t()``, [V, D] with D contiguous: the tied head ``embed.T`` is read
in place, any other layout is copied once per call.

What bounds the kernels on the H100 and how they are built: see the
sources' header comments.  What the kernels need from their caller is
computed here, so the CPU tests reach it: :func:`matrix_tensor_map` (the
TMA tensor map of x and of head^T), :func:`ce_fwd_launch_geometry` (K1)
and :func:`ce_bwd_launch_geometry` (K2, K3).
"""

from __future__ import annotations

import ctypes

import torch

DEFAULT_BLOCK_N = 128
DEFAULT_BLOCK_V = 1024
KERNEL_D = (128, 256, 384, 512)  # the hidden sizes the kernels are built for
KERNEL_TILE = 64  # V's multiple: K2 and K3's fixed rows and streamed tile
# csrc/fused_ce_fwd.cu's geometry: a block owns FWD_ROWS rows of x, 64 per
# consumer warpgroup, held in shared memory as D/64 chunks of [FWD_ROWS,
# 64]; head^T streams in chunks of [FWD_COLS vocab rows, 64] through a
# ring of FWD_STAGES slots; two consumer warpgroups and one producer
FWD_ROWS, FWD_COLS, FWD_CHUNK, FWD_STAGES = 128, 128, 64, 6
FWD_THREADS = 3 * 128
# csrc/fused_ce.cu's geometry: a block owns BWD_ROWS fixed rows (x rows for
# K2, vocab rows of head^T for K3), held in shared memory as D/64 boxes of
# [BWD_ROWS, 64]; [BWD_TILE, D] tiles of the other operand stream through
# BWD_STAGES[D] stages; two consumer warpgroups split the accumulator's D
# columns, the first warp also loading; two [BWD_ROWS, BWD_TILE] bf16 dl
# slots; no clusters
BWD_ROWS, BWD_TILE = 64, 64
BWD_STAGES = {128: 4, 256: 4, 384: 3, 512: 2}
BWD_THREADS = 2 * 128
BWD_MODES = ("dx", "dhead")
_TMA_ALIGN = 16  # bytes: every TMA global stride and base address
_TMA_STRIDE_LIMIT = 1 << 40


def _check(x, head, targets, block_n, block_v) -> str | None:
    """The fused path's preconditions, as in the JAX package: None when
    they hold, else the reason (and callers fall back)."""
    n, d = x.shape
    d2, v = head.shape
    if d != d2:
        return f"x d={d} vs head d={d2}"
    if tuple(targets.shape) != (n,):
        return f"targets shape {tuple(targets.shape)} != ({n},)"
    if n % block_n or v % block_v:
        return f"n={n} % {block_n} or V={v} % {block_v} != 0"
    if d % 128:
        return f"d={d} % 128 != 0 (lane dim)"
    if block_v % 128:
        return f"block_v={block_v} % 128 != 0 (lane dim of the logits tile)"
    if block_n % 8:
        return f"block_n={block_n} % 8 != 0 (sublane dim)"
    return None


# ---- plain versions ----


def ce_fwd_reference(x: torch.Tensor, head: torch.Tensor,
                     targets: torch.Tensor):
    """K1's function written plainly: f32 logits of the operands as given,
    ``lse`` by ``logsumexp``, ``ce = lse - logits[target]`` (0 picked for a
    target outside [0, V)).  Returns ``(ce, lse)``, both f32 [n];
    differentiable in x and head."""
    logits = x.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    v = head.shape[1]
    valid = (targets >= 0) & (targets < v)
    picked = torch.gather(
        logits, 1, targets.long().clamp(0, v - 1)[:, None])[:, 0]
    return lse - torch.where(valid, picked, torch.zeros_like(picked)), lse


def _dlogits(x, head, targets, lse, dce) -> torch.Tensor:
    """``(exp(x @ head - lse) - onehot) * dce`` in f32, [n, V]; a target
    outside [0, V) adds no one-hot term."""
    dl = torch.exp(x.float() @ head.float() - lse.float()[:, None])
    valid = (targets >= 0) & (targets < head.shape[1])
    rows = torch.arange(x.shape[0], device=x.device)[valid]
    dl[rows, targets.long()[valid]] -= 1.0
    return dl * dce.float()[:, None]


def ce_dx_reference(x, head, targets, lse, dce) -> torch.Tensor:
    """K2's function: ``((exp(x@head - lse) - onehot) * dce) @ head^T`` in
    f32, cast to x's dtype."""
    return (_dlogits(x, head, targets, lse, dce) @ head.float().T).to(x.dtype)


def ce_dhead_reference(x, head, targets, lse, dce) -> torch.Tensor:
    """K3's function: ``x^T @ ((exp(x@head - lse) - onehot) * dce)`` in
    f32, cast to head's dtype."""
    return (x.float().T @ _dlogits(x, head, targets, lse, dce)).to(head.dtype)


# ---- kernel wrappers ----


def matrix_tensor_map(t: torch.Tensor, box_rows: int = FWD_ROWS):
    """The TMA tensor map K1 reads a row-major [rows, D] bf16 matrix (x,
    or head^T) through: ``(dims, byte_strides, box)``, dims innermost first
    ``(D, rows)``, the byte stride of a row, and the box of [box_rows, 64]
    (one 128-byte swizzle row of 64 values).  Raises ValueError for a
    layout TMA cannot take: a D that is not contiguous, a row stride that
    is not a multiple of 16 bytes (or not below 2^40), a base address that
    is not 16-byte aligned."""
    rows, d = t.shape
    stride = t.stride(0) * t.element_size()
    if (t.stride(1) != 1 or stride % _TMA_ALIGN
            or not 0 <= stride < _TMA_STRIDE_LIMIT
            or t.data_ptr() % _TMA_ALIGN):
        raise ValueError(
            f"TMA needs a contiguous last dim, a row stride that is a "
            f"multiple of {_TMA_ALIGN} bytes and a {_TMA_ALIGN}-byte "
            f"aligned base; got element strides {t.stride()} of "
            f"{t.element_size()}-byte elements at {t.data_ptr():#x}")
    return (d, rows), (stride,), (FWD_CHUNK, box_rows)


def ce_fwd_launch_geometry(n: int, d: int):
    """``(grid, threads, smem_bytes)`` of K1 on x [n, d]: one block per
    FWD_ROWS rows; dynamic shared memory for the block's x rows, the ring
    of head^T chunks, 2 * FWD_STAGES + 1 mbarriers and 1 KB to align the
    tiles to the 128-byte swizzle's 1024-byte atom."""
    chunk = FWD_ROWS * FWD_CHUNK * 2
    smem = ((d // FWD_CHUNK) * chunk + FWD_STAGES * FWD_COLS * FWD_CHUNK * 2
            + (2 * FWD_STAGES + 1) * 8 + 1024)
    return (-(-n // FWD_ROWS),), FWD_THREADS, smem


def ce_bwd_launch_geometry(n: int, v: int, d: int, mode: str):
    """``(grid, cluster, threads, smem_bytes)`` of K2 (``mode`` "dx") or
    K3 ("dhead") on x [n, d] and head [d, v]: one block per BWD_ROWS fixed
    rows (of x for K2, of head^T for K3), clusters of 1; dynamic shared
    memory for the fixed rows, BWD_STAGES[d] streamed tiles, two bf16 dl
    tiles, the lse, dce and targets of each stage's streamed rows (K3)
    and of the fixed rows (K2), the 2 * stages + 1 mbarriers and 1 KB to
    align the tiles to the 128-byte swizzle's 1024-byte atom."""
    if mode not in BWD_MODES:
        raise ValueError(f"mode is one of {BWD_MODES}, got {mode!r}")
    stages = BWD_STAGES[d]
    tile = BWD_TILE * d * 2
    smem = (BWD_ROWS * d * 2 + stages * tile + 2 * BWD_ROWS * BWD_TILE * 2
            + (stages + 1) * 3 * BWD_TILE * 4 + (2 * stages + 1) * 8 + 1024)
    return (-(-(n if mode == "dx" else v) // BWD_ROWS),), 1, BWD_THREADS, smem


def _fwd_function():
    from learning_at_home_tpu_torch.ops.build import load_library

    fn = load_library("fused_ce_fwd").lah_fused_ce_fwd_bf16
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, i64, p, i64, p, p, p, i32, i32, i32, i32, i32, p]
        fn.restype = ctypes.c_int
    return fn


def _functions():
    from learning_at_home_tpu_torch.ops.build import load_library

    lib = load_library("fused_ce")
    dx, dhead = lib.lah_fused_ce_dx_bf16, lib.lah_fused_ce_dhead_bf16
    if dx.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        dx.argtypes = [p, i64, p, i64, p, p, p, p, i64, i32, i32, i32, i32,
                       i32, p]
        dhead.argtypes = dx.argtypes
        for fn in (dx, dhead):
            fn.restype = ctypes.c_int
    return dx, dhead


def _cuda_operands(x, head, targets, *rows):
    """Validate the kernels' inputs (their layouts: :func:`matrix_tensor_map`);
    returns (w = head^T [V, D] with D contiguous, int32 targets,
    contiguous f32 row vectors)."""
    if x.dim() != 2 or head.dim() != 2 or x.shape[1] != head.shape[0]:
        raise ValueError(f"x [n, D] and head [D, V] expected, got "
                         f"{tuple(x.shape)} and {tuple(head.shape)}")
    for name, t in (("x", x), ("head", head)):
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the fused-CE kernels take bfloat16, {name} is {t.dtype}")
    for name, t in (("head", head), ("targets", targets),
                    *(("row vector", r) for r in rows)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    n, d = x.shape
    v = head.shape[1]
    if d not in KERNEL_D:
        raise ValueError(
            f"the fused-CE kernels are built for D in {KERNEL_D}, got {d}")
    if v % KERNEL_TILE or v == 0:
        raise ValueError(
            f"the fused-CE kernels need V % {KERNEL_TILE} == 0, got {v}")
    if tuple(targets.shape) != (n,):
        raise ValueError(f"targets must be [{n}], got {tuple(targets.shape)}")
    w = head.t()
    if w.stride(1) != 1:  # an untied [D, V] head: one copy, [V, D]
        w = w.contiguous()
    targets = targets.to(torch.int32).contiguous()
    rows = [r.float().contiguous() for r in rows]
    return w, targets, rows


def _raise_on(err: int, name: str) -> None:
    if err < 0:
        raise RuntimeError(
            f"{name}: a TMA tensor map could not be encoded ("
            + ("the driver lacks cuTensorMapEncodeTiled)" if err == -1
               else f"CUresult {-1000 - err})"))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return False


def ce_forward(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor):
    """K1: ``(ce, lse)`` f32 [n] of ``x [n, D] @ head [D, V]`` against
    ``targets [n]``.  CPU tensors take :func:`ce_fwd_reference`; CUDA
    tensors launch the kernel (``ce_forward.launches`` counts them)."""
    if _on_cpu(x, "ce_forward"):
        with torch.no_grad():
            return ce_fwd_reference(x, head, targets)
    w, tgt, _ = _cuda_operands(x, head, targets)
    n, d = x.shape
    ce = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(ce)
    if n:
        (x_stride,), (w_stride,) = (matrix_tensor_map(x)[1],
                                    matrix_tensor_map(w, FWD_COLS)[1])
        (grid,), _, smem = ce_fwd_launch_geometry(n, d)
        fwd = _fwd_function()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _raise_on(fwd(x.data_ptr(), x_stride, w.data_ptr(), w_stride,
                          tgt.data_ptr(), ce.data_ptr(), lse.data_ptr(), n,
                          w.shape[0], d, grid, smem, stream), "fused_ce_fwd")
        ce_forward.launches += 1
    return ce, lse


def _ce_bwd(mode, x, head, targets, lse, dce) -> torch.Tensor:
    """Launch K2 (``mode`` "dx": dx [n, D]) or K3 ("dhead": dw = dhead^T
    [V, D]) on CUDA tensors."""
    w, tgt, (lse, dce) = _cuda_operands(x, head, targets, lse, dce)
    n, d = x.shape
    v = w.shape[0]
    dtype = x.dtype if mode == "dx" else head.dtype
    out = torch.empty((n, d) if mode == "dx" else (v, d), dtype=dtype,
                      device=x.device)
    if not n:
        return out.zero_()
    (x_stride,), (w_stride,) = (matrix_tensor_map(x, BWD_ROWS)[1],
                                matrix_tensor_map(w, BWD_TILE)[1])
    (grid,), _, _, smem = ce_bwd_launch_geometry(n, v, d, mode)
    fn = _functions()[BWD_MODES.index(mode)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(fn(x.data_ptr(), x_stride, w.data_ptr(), w_stride,
                     tgt.data_ptr(), lse.data_ptr(), dce.data_ptr(),
                     out.data_ptr(), out.stride(0), n, v, d, grid, smem,
                     stream), f"fused_ce_{mode}")
    (ce_dx if mode == "dx" else ce_dhead).launches += 1
    return out


def ce_dx(x, head, targets, lse, dce) -> torch.Tensor:
    """K2: dx [n, D] in x's dtype.  CPU tensors take
    :func:`ce_dx_reference`; CUDA tensors launch the kernel
    (``ce_dx.launches``)."""
    if _on_cpu(x, "ce_dx"):
        return ce_dx_reference(x, head, targets, lse, dce)
    return _ce_bwd("dx", x, head, targets, lse, dce)


def ce_dhead(x, head, targets, lse, dce) -> torch.Tensor:
    """K3: dhead [D, V] in head's dtype (on CUDA, the transpose of a
    contiguous [V, D] tensor).  CPU tensors take
    :func:`ce_dhead_reference`; CUDA tensors launch the kernel
    (``ce_dhead.launches``)."""
    if _on_cpu(x, "ce_dhead"):
        return ce_dhead_reference(x, head, targets, lse, dce)
    return _ce_bwd("dhead", x, head, targets, lse, dce).t()


ce_forward.launches = 0
ce_dx.launches = 0
ce_dhead.launches = 0


# ---- autograd ----


class FusedSoftmaxCE(torch.autograd.Function):
    """ce [n] f32 of ``x @ head`` against ``targets``: forward K1 (saves
    ``lse``), backward K2 then K3.  Targets get no gradient."""

    @staticmethod
    def forward(ctx, x, head, targets):
        ce, lse = ce_forward(x, head, targets)
        ctx.save_for_backward(x, head, targets, lse)
        return ce

    @staticmethod
    def backward(ctx, dce):
        x, head, targets, lse = ctx.saved_tensors
        dce = dce.float().contiguous()
        dx = dhead = None
        if ctx.needs_input_grad[0]:
            dx = ce_dx(x, head, targets, lse, dce)
        if ctx.needs_input_grad[1]:
            dhead = ce_dhead(x, head, targets, lse, dce)
        return dx, dhead, None


def fused_softmax_ce(x: torch.Tensor, head: torch.Tensor,
                     targets: torch.Tensor, block_n: int = DEFAULT_BLOCK_N,
                     block_v: int = DEFAULT_BLOCK_V) -> torch.Tensor:
    """Per-row softmax CE of ``x [n, D] @ head [D, V]`` against integer
    ``targets [n]`` → ce [n] f32, differentiable in x and head.  Raises
    ValueError when :func:`_check` refuses the shapes."""
    err = _check(x, head, targets, block_n, block_v)
    if err:
        raise ValueError(f"fused_softmax_ce: {err}")
    return FusedSoftmaxCE.apply(x, head, targets)


def fused_softmax_ce_auto(x: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """The fused path when its preconditions hold at the default blocks,
    else one materialised f32-logits CE with the same semantics."""
    if _check(x, head, targets, DEFAULT_BLOCK_N, DEFAULT_BLOCK_V) is None:
        return fused_softmax_ce(x, head, targets)
    return ce_fwd_reference(x, head, targets)[0]
