"""The pod tier's collectives (``parallel/comm.py``) on card tensors.

The ``cuda``-marked tests need the card and skip without one: the
collectives and their backwards on card tensors over ``nccl`` (a job of
one rank: one card) and over ``gloo`` with two ranks sharing the card
(staged through host copies, ``Mesh.stage``), against the same calls on
CPU tensors.  The staging path itself also runs on the CPU here.  The
file imports torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Tolerance: bit for bit.  The inputs are small integers in f32 and every
collective sums at most two of them, exactly, on any device.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from learning_at_home_tpu_torch.parallel.launch import RankGroup

needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card")


def cpu_results(n: int) -> list:
    with RankGroup(n, timeout_s=120.0) as group:
        return group.run(R.collectives, {"expert": n})


def assert_same(got: list, want: list) -> None:
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_staged_collectives_equal_unstaged_on_the_cpu():
    """The host staging that gloo needs for card tensors, taken on CPU
    tensors: the same results as without it."""
    torch.set_num_threads(1)
    with RankGroup(2, timeout_s=120.0) as group:
        plain = group.run(R.collectives, {"expert": 2})
        staged = group.run(R.staged_collectives, {"expert": 2})
    assert_same(staged, plain)
    # rank 1 received rank 0's rows through the ring permutation
    np.testing.assert_array_equal(plain[1]["ppermute"],
                                  np.arange(12.0).reshape(2, 6))


@pytest.mark.parametrize("bucket_bytes", [64, 1 << 20])
def test_gradient_reduction_in_buckets(bucket_bytes):
    """``all_reduce_tensors_`` bounds its staging memory by buckets: with
    buckets smaller than one tensor (each alone, a strided one copied) and
    larger than all (one per dtype), every tensor is the sum of the two
    ranks' in place."""
    torch.set_num_threads(1)
    with RankGroup(2, timeout_s=120.0) as group:
        out = group.run(R.bucketed_reduce, bucket_bytes)
    want = [np.full(5, 3.0), np.full((4, 3), 6.0), np.full(40, 3.0),
            np.arange(6.0) * 3]
    for got in out:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@needs_cuda
def test_collectives_over_nccl_on_the_card():
    with RankGroup(1, backend="nccl", timeout_s=120.0) as group:
        backend, reduced = group.run(R.nccl_all_reduce, "cuda:0")[0]
        card = group.run(R.collectives, {"expert": 1}, "cuda:0")
    assert backend == "nccl"
    np.testing.assert_array_equal(reduced, np.arange(8.0))
    assert_same(card, cpu_results(1))


@pytest.mark.cuda
@needs_cuda
def test_collectives_over_gloo_with_two_ranks_sharing_the_card():
    with RankGroup(2, backend="gloo", timeout_s=120.0) as group:
        card = group.run(R.collectives, {"expert": 2}, "cuda:0")
    assert_same(card, cpu_results(2))
