"""The frozen FLOP and byte counts."""

import pytest

from perfbench.lib import flops, spec


DMOE = spec.load_family("dmoe")


def cfg(name):
    return spec.load_json(spec.ROOT / "configs" / f"{name}.json")


def test_train_flops_match_bench_py_at_batch_176():
    # bench.py / utils/sizing.py: 232.8 MFLOP a token, 10.49 TF a step
    step = flops.train_flops_per_step(DMOE, cfg("dmoe256-s256"), 176)
    assert step == pytest.approx(10.49e12, rel=5e-4)
    assert DMOE.train_flops_per_token(cfg("dmoe256-s256")) == pytest.approx(
        232.8e6, rel=5e-4)


def test_train_flops_at_8192():
    assert DMOE.train_flops_per_token(cfg("dmoe256-s8192")) == pytest.approx(
        427.8e6, rel=5e-4)


@pytest.mark.parametrize("mode,ratio", [("fwd", 1.0), ("dx", 2.0), ("dhead", 2.0)])
def test_fused_ce_counts(mode, ratio):
    ops, nbytes = flops.fused_ce(mode, 45056, 512, 32768)
    assert ops == pytest.approx(ratio * 2 * 45056 * 512 * 32768)
    assert nbytes > 512 * 32768 * 2  # the head is read
    # the K1 bound matches the kernel table's 1.5286 ms
    if mode == "fwd":
        assert flops.bound_s(ops, nbytes) * 1e3 == pytest.approx(1.5286, rel=1e-3)


@pytest.mark.parametrize("mode,per_pair", [("fwd", 4), ("dkv", 8), ("dq", 6)])
def test_flash_counts(mode, per_pair):
    ops, _ = flops.flash_attn(mode, 4, 8192, 8, 64)
    assert ops == pytest.approx(per_pair * 64 * 4 * 8 * 8192 * 8193 / 2)
