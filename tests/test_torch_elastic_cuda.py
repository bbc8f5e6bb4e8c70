"""The port's elastic tier on a CUDA card: a handoff between two card
servers is bit for bit (params, adam state, update_count; the receiver
verifies the state re-read from the card), averaging card-resident trees
leaves them equal (bf16 leaves rounded once from the reduced f32), and an
expert drawn on the card holds the CPU draw's bits.  The ``cuda``-marked
tests need the card and skip without one.  The file imports torch only,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_elastic_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch.averaging import (
    AveragingConfig,
    DecentralizedAverager,
)
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.models.layers import make_expert
from learning_at_home_tpu_torch.server import lifecycle
from learning_at_home_tpu_torch.server.server import Server, uid_key
from learning_at_home_tpu_torch.tree import jax_tree_leaves

H = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean_client():
    yield
    reset_client_rpc()


def _leaves(state):
    return [np.asarray(leaf) for leaf in jax_tree_leaves(
        {"params": state["params"], "opt_state": state["opt_state"]})]


@pytest.mark.cuda
def test_card_to_card_handoff_is_bitwise(card):
    src = Server.create(expert_uids=["cm.0", "cm.1"], hidden_dim=H,
                        host="127.0.0.1", optimizer=optim.adam(1e-3),
                        device="cuda")
    dst = Server.create(num_experts=0, hidden_dim=H, host="127.0.0.1",
                        optimizer=optim.adam(1e-3), device="cuda")
    try:
        rs = np.random.RandomState(0)
        for _ in range(2):
            src.experts["cm.0"].backward(
                [rs.randn(8, H).astype(np.float32)],
                [rs.randn(8, H).astype(np.float32)])
        want = {u: b.state_dict() for u, b in src.experts.items()}
        summary = src.drain(successor=dst.endpoint, grace=0.0,
                            quiesce_timeout=3.0)
        assert summary["handed_off"] == ["cm.0", "cm.1"]
        assert summary["failed"] == [] and summary["checkpointed"] == []
        for uid, state in want.items():
            backend = dst.experts[uid]
            assert all(t.is_cuda for t in jax_tree_leaves(backend.params))
            got = backend.state_dict()
            assert got["update_count"] == state["update_count"]
            for a, b in zip(_leaves(state), _leaves(got), strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert dst.handoff.received == 2
        assert lifecycle.flatten_state(want["cm.0"])[1] == \
            lifecycle.flatten_state(dst.experts["cm.0"].state_dict())[1]
    finally:
        src.shutdown()
        dst.shutdown()


@pytest.mark.cuda
def test_averaging_card_resident_trees_makes_them_equal(card):
    boot = DHT()
    nodes = [DHT(initial_peers=[boot.endpoint]) for _ in range(2)]
    cfg = AveragingConfig(min_group_size=2, max_group_size=2,
                          part_timeout=3.0, chunk_elems=1000)
    avgs = [DecentralizedAverager(n, config=cfg, peer_id=f"c{i}")
            for i, n in enumerate(nodes)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    trees = [{"w": torch.randn(37, 11, generator=gen, device="cuda"),
              "h": torch.randn(301, generator=gen, device="cuda").to(
                  torch.bfloat16)} for _ in range(2)]
    out = [None, None]
    try:
        ts = [threading.Thread(target=lambda i: out.__setitem__(
            i, avgs[i].step_round(trees[i], matchmaking_timeout=20.0)[0]),
            args=(i,), daemon=True) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        for key in ("w", "h"):
            a, b = out[0][key], out[1][key]
            assert a.is_cuda and a.dtype == trees[0][key].dtype
            assert torch.equal(a, b)
        mean = (trees[0]["w"] + trees[1]["w"]) / 2
        torch.testing.assert_close(out[0]["w"], mean, rtol=0, atol=1e-6)
        want_h = ((trees[0]["h"].float() + trees[1]["h"].float()) / 2).to(
            torch.bfloat16)
        assert torch.equal(out[0]["h"], want_h)
    finally:
        for av in avgs:
            av.shutdown()
        for n in (*nodes, boot):
            n.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("expert_cls", ["ffn", "transformer", "swiglu"])
def test_an_expert_drawn_on_the_card_holds_the_cpu_draws_bits(card,
                                                              expert_cls):
    _, on_card = make_expert(expert_cls, H, uid_key("cd.1"), device="cuda")
    _, on_cpu = make_expert(expert_cls, H, uid_key("cd.1"), device="cpu")
    for a, b in zip(jax_tree_leaves(on_card), jax_tree_leaves(on_cpu),
                    strict=True):
        assert a.is_cuda
        assert torch.equal(a.cpu(), b)
