"""What the Hopper fused-CE backward kernels K2 (dx) and K3 (dhead) of
``csrc/fused_ce.cu`` need from their caller, computed on the CPU: their
launch geometry and shared memory against the constants of the kernel
source, for every width and both modes; the TMA tensor maps of x and of
head^T (tied, and a column slice of a wider table); the arguments that
reach the C entry points; and the layouts TMA cannot take, refused before
any launch.  The kernels themselves run only on the card
(``test_torch_fused_ce_cuda``)."""

import contextlib
import re
from pathlib import Path

import pytest
import torch

from learning_at_home_tpu_torch.ops import fused_ce as fce

SMEM_LIMIT = 232448  # bytes a Hopper block can use (227 KB)
SOURCE = Path(fce.__file__).resolve().parents[1] / "csrc" / "fused_ce.cu"
N_ROWS = [1, 63, 64, 65, 200, 320, 1000, 32768, 45056]
VOCAB = [64, 1088, 2048, 32768]


def _const(name: str) -> int:
    text = SOURCE.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_geometry_matches_the_kernel_source():
    text = SOURCE.read_text()
    assert _const("kRows") == fce.BWD_ROWS
    assert _const("kTile") == fce.BWD_TILE == fce.KERNEL_TILE
    assert _const("kChunk") == 64
    assert _const("kThreads") == fce.BWD_THREADS == 2 * 128
    stages = re.search(r"constexpr int kStagesByD\[4\] = \{([\d, ]+)\};", text)
    assert [int(s) for s in stages.group(1).split(",")] == [
        fce.BWD_STAGES[d] for d in fce.KERNEL_D]
    assert sorted(fce.BWD_STAGES) == list(fce.KERNEL_D)
    for d in fce.KERNEL_D:  # the entry points' cases
        assert f"LAH_FUSED_CE_CASE({d})" in text
    assert "mma.sync" not in text and "wgmma" in text


@pytest.mark.parametrize("mode", fce.BWD_MODES)
@pytest.mark.parametrize("d", fce.KERNEL_D)
@pytest.mark.parametrize("n", N_ROWS)
def test_launch_geometry(mode, d, n):
    v = 1088
    (grid,), cluster, threads, smem = fce.ce_bwd_launch_geometry(n, v, d, mode)
    fixed = n if mode == "dx" else v  # rows of x (K2) or of head^T (K3)
    assert cluster == 1
    assert grid * fce.BWD_ROWS >= fixed > (grid - 1) * fce.BWD_ROWS
    assert threads == 2 * 128  # two consumer warpgroups, no producer
    stages = fce.BWD_STAGES[d]
    fixed_rows = 64 * d * 2  # the block's 64 rows, D/64 boxes of [64, 64]
    ring = stages * 64 * d * 2  # whole [64, D] streamed tiles
    dl = 2 * 64 * 64 * 2  # two bf16 dl slots
    # lse, dce and targets: of each stage's rows (K3), of the fixed (K2)
    stats = (stages + 1) * 3 * 64 * 4
    barriers = (2 * stages + 1) * 8  # full, empty per stage; fixed rows
    assert smem == fixed_rows + ring + dl + stats + barriers + 1024
    assert 48 * 1024 < smem <= SMEM_LIMIT  # needs the opt-in attribute


@pytest.mark.parametrize("v", VOCAB)
def test_vocab_grid_covers_v(v):
    (grid,), *_ = fce.ce_bwd_launch_geometry(1000, v, 512, "dhead")
    assert grid == v // 64


def test_unknown_mode_is_refused():
    with pytest.raises(ValueError, match="mode"):
        fce.ce_bwd_launch_geometry(100, 1088, 512, "dw")


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("d", fce.KERNEL_D)
def test_tensor_maps_of_x_and_the_head(d):
    """64-row boxes for both operands; the strided head reaches its map
    through the row stride."""
    n, v = 1000, 1088
    x = _bf16(n, d)
    assert fce.matrix_tensor_map(x, fce.BWD_ROWS) == ((d, n), (d * 2,),
                                                      (64, 64))
    embed = _bf16(v, d)  # the tied head embed.T, read as head^T = embed
    assert fce.matrix_tensor_map(embed.t().t(), fce.BWD_TILE) == (
        (d, v), (d * 2,), (64, 64))
    table = _bf16(v, d + 64)  # head^T as a column slice of a wider table
    assert fce.matrix_tensor_map(table[:, :d], fce.BWD_TILE) == (
        (d, v), ((d + 64) * 2,), (64, 64))


def _cpu_launch(monkeypatch):
    """ce_dx's and ce_dhead's CUDA path on CPU tensors, their entry points
    replaced by recorders: what would reach each kernel, or nothing."""
    calls = {"dx": [], "dhead": []}

    def recorder(mode):
        def entry(*args):
            calls[mode].append(args)
            return 0
        return entry

    monkeypatch.setattr(fce, "_on_cpu", lambda x, name: False)
    monkeypatch.setattr(fce, "_functions",
                        lambda: (recorder("dx"), recorder("dhead")))
    monkeypatch.setattr(fce.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fce.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    return calls


def _operands(n, d, v, strided_x=False, strided_head=False):
    x = _bf16(n, d + 64)[:, :d] if strided_x else _bf16(n, d)
    head = (_bf16(v, d + 64)[:, :d] if strided_head else _bf16(v, d)).t()
    tgt = torch.zeros(n, dtype=torch.int32)
    rows = torch.zeros(n), torch.ones(n)
    return x, head, tgt, *rows


@pytest.mark.parametrize("strided_head", [False, True])
@pytest.mark.parametrize("strided_x", [False, True])
@pytest.mark.parametrize("d", [128, 384, 512])
def test_arguments_reach_the_entry_points(d, strided_x, strided_head,
                                          monkeypatch):
    """x, its byte stride, head^T, its byte stride, targets, lse, dce, the
    output and its element stride, n, V, D, grid x, smem, stream."""
    calls = _cpu_launch(monkeypatch)
    n, v = 300, 1088
    x, head, tgt, lse, dce = _operands(n, d, v, strided_x, strided_head)
    before = (fce.ce_dx.launches, fce.ce_dhead.launches)
    dx = fce.ce_dx(x, head, tgt, lse, dce)
    dhead = fce.ce_dhead(x, head, tgt, lse, dce)
    assert (fce.ce_dx.launches, fce.ce_dhead.launches) == (
        before[0] + 1, before[1] + 1)
    assert dx.shape == (n, d) and dhead.shape == (d, v)
    for mode, out in (("dx", dx), ("dhead", dhead.t())):
        (args,) = calls[mode]
        grid, _, _, smem = fce.ce_bwd_launch_geometry(n, v, d, mode)
        assert args[0] == x.data_ptr() and args[1] == x.stride(0) * 2
        assert args[2] == head.data_ptr() and args[3] == head.stride(1) * 2
        assert args[4:7] == (tgt.data_ptr(), lse.data_ptr(), dce.data_ptr())
        assert args[7:9] == (out.data_ptr(), d)
        assert args[9:] == (n, v, d, grid[0], smem, 7)


def test_no_rows_launch_nothing(monkeypatch):
    calls = _cpu_launch(monkeypatch)
    x, head, tgt, lse, dce = _operands(0, 512, 1088)
    assert not fce.ce_dx(x, head, tgt, lse, dce).numel()
    dhead = fce.ce_dhead(x, head, tgt, lse, dce)
    assert dhead.shape == (512, 1088) and not dhead.any()
    assert calls == {"dx": [], "dhead": []}


def _odd_stride(rows):
    """Row stride of 516 elements at D = 512: 1032 bytes, not a multiple
    of 16."""
    return _bf16(rows, 516)[:, :512]


def _misaligned(rows):
    return _bf16(rows * 512 + 8).narrow(0, 1, rows * 512).view(rows, 512)


def _strided_d(rows):
    return _bf16(512, rows).t()


@pytest.mark.parametrize("fn", [fce.ce_dx, fce.ce_dhead])
@pytest.mark.parametrize("make", [_odd_stride, _misaligned, _strided_d])
def test_layouts_tma_cannot_take_are_refused(make, fn, monkeypatch):
    """As x, and (but for a strided D, which the wrapper copies once) as
    head^T: refused before any launch, and counted as none."""
    calls = _cpu_launch(monkeypatch)
    before = fn.launches
    tgt, rows = torch.zeros(100, dtype=torch.int32), torch.zeros(100)
    with pytest.raises(ValueError):
        fn(make(100), _bf16(1088, 512).t(), tgt, rows, rows)
    if make is not _strided_d:
        with pytest.raises(ValueError):
            fn(_bf16(100, 512), make(1088).t(), tgt, rows, rows)
    assert calls == {"dx": [], "dhead": []} and fn.launches == before


@pytest.mark.parametrize("fn", [fce.ce_dx, fce.ce_dhead])
def test_shapes_the_kernels_do_not_take_are_refused(fn, monkeypatch):
    calls = _cpu_launch(monkeypatch)
    x, head, tgt, lse, dce = _operands(100, 512, 1088)
    with pytest.raises(ValueError, match="D in"):
        fn(_bf16(100, 640), _bf16(1088, 640).t(), tgt, lse, dce)
    with pytest.raises(ValueError, match="V %"):
        fn(x, _bf16(1000, 512).t(), tgt, lse, dce)
    with pytest.raises(TypeError, match="bfloat16"):
        fn(x.float(), head.float(), tgt, lse, dce)
    assert calls == {"dx": [], "dhead": []}
