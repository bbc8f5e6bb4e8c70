"""What the Hopper forward kernels need from their caller, computed on the
CPU: K5's forward (``csrc/flash_attn_fwd.cu``) and K1, the fused-CE
forward (``csrc/fused_ce_fwd.cu``).  Their launch geometry and shared
memory against the constants of the kernel sources, the TMA tensor maps
of their inputs (K5's 4-D map of q, k, v; K1's 2-D map of x and head^T
for each D, and for a strided x), the arguments that reach the C entry
points, and the layouts TMA cannot take, refused before any launch.  The
kernels themselves run only on the card (``test_torch_flash_kernel_cuda``
and ``test_torch_fused_ce_cuda``)."""

import contextlib
import re
from pathlib import Path

import pytest
import torch

from learning_at_home_tpu_torch.ops import flash_attention as fa
from learning_at_home_tpu_torch.ops import fused_ce as fce

SEQ_LENS = [1, 65, 70, 1000, 4096, 8192, 8193]
B, H, HD = 2, 3, 64
SMEM_LIMIT = 232448  # bytes a Hopper block can use (227 KB)
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"


def _const(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# ---- K5 forward ----


def test_flash_geometry_matches_the_kernel_source():
    src = "flash_attn_fwd.cu"
    assert _const(src, "kRows") == fa.FWD_ROWS
    assert _const(src, "kConsumers") * 64 == fa.FWD_ROWS
    assert _const(src, "kKeys") == fa.FWD_KEYS
    assert _const(src, "kStages") == fa.FWD_STAGES
    assert _const(src, "kThreads") == fa.FWD_THREADS
    assert _const(src, "kTile") == fa.TILE
    assert _const(src, "kHeadDim") == fa.HEAD_DIM


@pytest.mark.parametrize("s", SEQ_LENS)
def test_flash_launch_geometry(s):
    grid, threads, smem = fa.fwd_launch_geometry(B, s, H)
    assert grid == (-(-s // fa.FWD_ROWS), H, B)
    assert grid[0] * fa.FWD_ROWS >= s > (grid[0] - 1) * fa.FWD_ROWS
    # a consumer warpgroup per 64 rows and one producer warpgroup
    assert threads == (fa.FWD_ROWS // 64 + 1) * 128
    q_bytes = fa.FWD_ROWS * HD * 2
    ring = fa.FWD_STAGES * 2 * fa.FWD_KEYS * HD * 2  # a K and a V tile each
    barriers = (2 * fa.FWD_STAGES + 1) * 8  # full, empty per stage; Q
    assert smem == q_bytes + ring + barriers + 1024
    assert 48 * 1024 < smem <= SMEM_LIMIT  # needs the opt-in attribute


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("s", [1, 70, 8193])
@pytest.mark.parametrize("packed", [False, True])
def test_flash_arguments_reach_the_entry_point(s, packed):
    """The entry point's arguments, in its order: pointers, B, S, H, the
    TMA byte strides of q, k, v, o's element strides, grid x, smem."""
    if packed:
        q, k, v = _bf16(B, s, 3, H, HD).unbind(2)
    else:
        q, k, v = _bf16(B, s, H, HD), _bf16(B, s, H, HD), _bf16(B, s, H, HD)
    o, lse = torch.empty_like(q, memory_format=torch.contiguous_format), \
        torch.empty(B, H, s)
    args = fa._fwd_args(q, k, v, o, lse)
    assert [a.value for a in args[:5]] == [t.data_ptr()
                                           for t in (q, k, v, o, lse)]
    assert [a.value for a in args[5:8]] == [B, s, H]
    strides = [args[8][i] for i in range(9)]
    assert strides == [x for t in (q, k, v) for x in fa.tensor_map(t)[1]]
    row = (3 if packed else 1) * H * HD * 2
    assert strides[:3] == [row, HD * 2, s * row]
    assert [a.value for a in args[9:12]] == [o.stride(0), o.stride(1),
                                             o.stride(2)]
    grid, _, smem = fa.fwd_launch_geometry(B, s, H)
    assert [a.value for a in args[12:]] == [grid[0], smem]
    assert fa._fwd_args(q, k, v, o, None)[4].value is None  # no lse


def _odd_head_stride():
    """Head stride of 68 elements (136 bytes): not a multiple of 16."""
    return torch.zeros(1, 10, 2, 68, dtype=torch.bfloat16)[..., :HD]


def _misaligned():
    flat = torch.zeros(10 * 2 * HD + 8, dtype=torch.bfloat16)
    return flat[1: 1 + 10 * 2 * HD].view(1, 10, 2, HD)


@pytest.mark.parametrize("make", [_odd_head_stride, _misaligned])
def test_flash_layouts_tma_cannot_take_are_refused(make, monkeypatch):
    bad = make()
    launched = []
    monkeypatch.setattr(fa, "_launch", lambda *a: launched.append(a))
    good = torch.zeros(bad.shape, dtype=torch.bfloat16)
    for i in range(3):  # the bad tensor as each of q, k, v
        inputs = [good] * 3
        inputs[i] = bad
        with pytest.raises(ValueError, match="TMA"):
            fa._fwd_args(*inputs, good, None)
    assert launched == []


# ---- K1: the fused-CE forward ----


def test_ce_geometry_matches_the_kernel_source():
    src = "fused_ce_fwd.cu"
    assert _const(src, "kRows") == fce.FWD_ROWS
    assert _const(src, "kCols") == fce.FWD_COLS
    assert _const(src, "kChunk") == fce.FWD_CHUNK
    assert _const(src, "kStages") == fce.FWD_STAGES
    assert _const(src, "kThreads") == fce.FWD_THREADS
    for d in fce.KERNEL_D:  # the entry point's cases
        assert f"LAH_FUSED_CE_FWD_CASE({d})" in (CSRC / src).read_text()


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 32768, 45056])
@pytest.mark.parametrize("d", fce.KERNEL_D)
def test_ce_launch_geometry(d, n):
    grid, threads, smem = fce.ce_fwd_launch_geometry(n, d)
    assert grid == (-(-n // 128),)
    assert threads == 384
    x_bytes = d // 64 * 128 * 64 * 2  # the block's rows, D/64 chunks
    ring = fce.FWD_STAGES * 128 * 64 * 2
    barriers = (2 * fce.FWD_STAGES + 1) * 8  # full, empty per stage; x
    assert smem == x_bytes + ring + barriers + 1024
    assert 48 * 1024 < smem <= SMEM_LIMIT


@pytest.mark.parametrize("d", fce.KERNEL_D)
def test_ce_tensor_maps_of_x_and_the_head(d):
    n, v = 1000, 1088
    x = _bf16(n, d)
    assert fce.matrix_tensor_map(x) == ((d, n), (d * 2,), (64, 128))
    wide = _bf16(n, d + 64)  # x as a column slice of a wider matrix
    assert fce.matrix_tensor_map(wide[:, :d]) == ((d, n), ((d + 64) * 2,),
                                                  (64, 128))
    embed = _bf16(v, d)  # the tied head embed.T, read as head^T = embed
    head = embed.t()
    assert fce.matrix_tensor_map(head.t(), fce.FWD_COLS) == (
        (d, v), (d * 2,), (64, 128))


def _cpu_launch(monkeypatch):
    """ce_forward's CUDA path on CPU tensors, its entry point replaced by
    a recorder: what would reach the kernel, or nothing."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fce, "_on_cpu", lambda x, name: False)
    monkeypatch.setattr(fce, "_fwd_function", lambda: entry)
    monkeypatch.setattr(fce.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fce.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    return calls


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("d", [128, 512])
def test_ce_arguments_reach_the_entry_point(d, strided, monkeypatch):
    calls = _cpu_launch(monkeypatch)
    n, v = 300, 1088
    x = _bf16(n, d + 64)[:, :d] if strided else _bf16(n, d)
    head = _bf16(v, d).t()
    tgt = torch.zeros(n, dtype=torch.int32)
    before = fce.ce_forward.launches
    ce, lse = fce.ce_forward(x, head, tgt)
    assert fce.ce_forward.launches == before + 1
    (args,) = calls
    grid, _, smem = fce.ce_fwd_launch_geometry(n, d)
    assert args[0] == x.data_ptr() and args[2] == head.data_ptr()
    assert args[1] == x.stride(0) * 2 and args[3] == d * 2
    assert args[5:7] == (ce.data_ptr(), lse.data_ptr())
    assert args[7:] == (n, v, d, grid[0], smem, 7)


def _ce_odd_stride(rows):
    """Row stride of 516 elements at D = 512: 1032 bytes, not a multiple
    of 16."""
    return _bf16(rows, 516)[:, :512]


def _ce_misaligned(rows):
    return _bf16(rows * 512 + 8).narrow(0, 1, rows * 512).view(rows, 512)


def _ce_strided_d(rows):
    return _bf16(512, rows).t()


@pytest.mark.parametrize("make", [_ce_odd_stride, _ce_misaligned,
                                  _ce_strided_d])
def test_ce_layouts_tma_cannot_take_are_refused(make, monkeypatch):
    """As x, and (but for a strided D, which the wrapper copies once) as
    head^T: refused before any launch."""
    with pytest.raises(ValueError, match="TMA"):
        fce.matrix_tensor_map(make(100))
    calls = _cpu_launch(monkeypatch)
    with pytest.raises(ValueError):
        fce.ce_forward(make(100), _bf16(1088, 512).t(),
                       torch.zeros(100, dtype=torch.int32))
    if make is not _ce_strided_d:
        with pytest.raises(ValueError):
            fce.ce_forward(_bf16(100, 512), make(1088).t(),
                           torch.zeros(100, dtype=torch.int32))
    assert calls == []
