"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the checkout (the card's tests: add ``-m cuda``)."""

import dataclasses
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.lib import spec  # noqa: E402

TINY = dict(vocab_size=1024, d_model=128, n_heads=2, head_dim=64, n_layers=2,
            num_experts=8, expert_ffn_dim=512)


def tiny_cell(name: str, seq: int = 16, compute: str = "float32", **traffic):
    """The cell ``name`` cut to a CPU's size: 2 layers of d 128, 8
    experts, vocab 1024; the traffic's fields overridden by ``traffic``."""
    cell = spec.load_cell(name)
    cfg = dict(cell.config, **TINY, seq_len=seq, compute_dtype=compute)
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, **traffic))


def tiny_train(**kw):
    """The first cell of ``BENCHMARK.json`` at a tiny size."""
    first = spec.load_json(spec.REPO / "BENCHMARK.json")["workloads"][0]
    kw = {"batch": 8, "pool_batches": 4, **kw}
    return tiny_cell(first["name"], **kw)


@pytest.fixture
def card():
    """The CUDA device, or a skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
