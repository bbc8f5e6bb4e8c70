"""What the Hopper backward kernels (``csrc/flash_attn_bwd.cu``) need from
their caller, computed on the CPU: the TMA tensor map of each input (dims,
byte strides, box) and the launch geometry (grid, threads, dynamic shared
memory).  The kernels themselves run only on the card
(``test_torch_flash_bwd_cuda.py``); here the arithmetic around them is
held for the layouts the training path gives them."""

import re
from pathlib import Path

import pytest
import torch

from learning_at_home_tpu_torch.ops import flash_attention as fa

SEQ_LENS = [1, 65, 70, 1000, 8192, 8193]
B, H, HD = 2, 3, 64
ROW = HD * 2  # bytes of one head's 64 bf16 values
SMEM_LIMIT = 232448  # bytes a Hopper block can use (227 KB)
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attn_bwd.cu"


def _contiguous(s):
    return torch.zeros(B, s, H, HD, dtype=torch.bfloat16)


def _packed(s, which):
    """q, k or v as a slice of one packed [B, S, 3, H, hd] projection."""
    return torch.zeros(B, s, 3, H, HD, dtype=torch.bfloat16).unbind(2)[which]


def _transposed(s):
    """An upstream gradient laid out [B, H, S, hd], seen as [B, S, H, hd]."""
    return torch.zeros(B, H, s, HD, dtype=torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("s", SEQ_LENS)
@pytest.mark.parametrize("layout", ["contiguous", "packed q", "packed v",
                                    "transposed do", "transposed do, contiguous"])
def test_tensor_map_of_each_layout(layout, s):
    t, strides = {
        "contiguous": (_contiguous(s), (H * ROW, ROW, s * H * ROW)),
        "packed q": (_packed(s, 0), (3 * H * ROW, ROW, s * 3 * H * ROW)),
        "packed v": (_packed(s, 2), (3 * H * ROW, ROW, s * 3 * H * ROW)),
        "transposed do": (_transposed(s), (ROW, s * ROW, H * s * ROW)),
        "transposed do, contiguous": (_transposed(s).contiguous(),
                                      (H * ROW, ROW, s * H * ROW)),
    }[layout]
    dims, byte_strides, box = fa.tensor_map(t)
    assert dims == (HD, s, H, B)  # innermost first
    if s == 1:  # a size-1 dim's stride is whatever torch left: never read
        byte_strides, strides = byte_strides[1:], strides[1:]
    assert byte_strides == strides
    assert all(st % 16 == 0 for st in byte_strides)
    assert box == (HD, fa.TILE, 1, 1)
    assert box[0] * t.element_size() == 128  # one 128-byte swizzle row


@pytest.mark.parametrize("s", SEQ_LENS)
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_launch_geometry(kernel, s):
    grid, threads, smem = fa.bwd_launch_geometry(kernel, B, s, H)
    assert grid == (-(-s // 128), H, B)
    assert grid[0] * fa.BWD_ROWS >= s > (grid[0] - 1) * fa.BWD_ROWS
    assert threads == 384  # two consumer warpgroups and one producer
    tiles = 4 + 2 * fa.BWD_STAGES  # owned pair of 128 rows + the ring
    stats = fa.BWD_STAGES * 2 * 64 * 4 if kernel == "dkv" else 0
    barriers = (2 * fa.BWD_STAGES + 1) * 8  # full, empty per stage; owned
    assert smem == tiles * 8192 + stats + barriers + 1024
    assert 48 * 1024 < smem <= SMEM_LIMIT  # needs the opt-in attribute


def test_geometry_matches_the_kernel_source():
    """The constants the C entry points check the geometry against."""
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRows") == fa.BWD_ROWS
    assert const("kTile") == fa.TILE
    assert const("kStages") == fa.BWD_STAGES
    assert const("kThreads") == fa.BWD_THREADS
    assert const("kHeadDim") == fa.HEAD_DIM


def test_geometry_refuses_unknown_kernels():
    with pytest.raises(ValueError, match="no backward kernel"):
        fa.bwd_launch_geometry("dv", B, 64, H)


def _odd_head_stride():
    """Head stride of 68 elements (136 bytes): not a multiple of 16."""
    return torch.zeros(1, 10, 2, 68, dtype=torch.bfloat16)[..., :HD]


def _misaligned():
    """Strides fine, base address 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(10 * 2 * HD + 8, dtype=torch.bfloat16)
    return flat[1: 1 + 10 * 2 * HD].view(1, 10, 2, HD)


def _strided_head_dim():
    return torch.zeros(1, 10, 2, HD, dtype=torch.bfloat16).transpose(
        1, 3).contiguous().transpose(1, 3)


@pytest.mark.parametrize("make", [_odd_head_stride, _misaligned,
                                  _strided_head_dim])
def test_layouts_tma_cannot_take_are_refused_before_any_launch(make,
                                                               monkeypatch):
    bad = make()
    with pytest.raises(ValueError, match="TMA"):
        fa.tensor_map(bad)
    launched = []
    monkeypatch.setattr(fa, "_launch", lambda *a: launched.append(a))
    good = torch.zeros(bad.shape, dtype=torch.bfloat16)
    stats = torch.zeros(bad.shape[0], bad.shape[2], bad.shape[1])
    for kernel, outs in (("dkv", (good, good)), ("dq", (good,))):
        for i in range(4):  # the bad tensor as each of q, k, v, do
            inputs = [good] * 4
            inputs[i] = bad
            with pytest.raises(ValueError, match="TMA"):
                fa._bwd_args(kernel, *inputs, stats, stats, *outs)
    assert launched == []
