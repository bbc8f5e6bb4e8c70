"""The port's swarm DMoE-Transformer on a CUDA card, through a port DHT.

A port server in this process hosts a 2-layer grid (2, 2) swarm at hidden
32 and heartbeats it into a port DHT; a trainer on the card finds the
experts through its own DHT node and trains 3 steps; the same swarm with
its server and trainer on the CPU (the same crc32-seeded experts, the same
params) gives step 1's loss and gradients within ``atol = rtol = 2e-5``
(f32, TF32 off: cuBLAS and the CPU sum in other orders).  The tests need
the card and skip without one; the file imports torch only:

    python -m pytest --noconftest -m cuda tests/test_torch_swarm_transformer_cuda.py
"""

import asyncio
import contextlib
import time

import numpy as np
import pytest
import torch

from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.models.transformer_swarm import (
    SwarmDMoETransformerLM,
    SwarmTransformerConfig,
)
from learning_at_home_tpu_torch.server.server import background_server
from learning_at_home_tpu_torch.tree import tree_leaves

D, GRID, LAYERS = 32, (2, 2), 2
CFG = dict(vocab_size=258, d_model=D, n_layers=LAYERS, n_heads=4,
           seq_len=16, grid_size=GRID, k_best=2, timeout_after_k_min=60.0,
           wire_codec="none")  # every reply awaited, exact f32 on the wire
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.fixture(autouse=True)
def _clean_client():
    yield
    reset_client_rpc()


@contextlib.contextmanager
def _swarm(device, prefix):
    """A bootstrap DHT, a heartbeating server on ``device`` and the
    trainer's own DHT node, once every expert is visible through it."""
    uids = [f"{prefix}{layer}.{a}.{b}" for layer in range(LAYERS)
            for a in range(GRID[0]) for b in range(GRID[1])]
    boot = DHT(cache_ttl=0.0)
    server_dht = DHT(initial_peers=[boot.endpoint])
    client = DHT(initial_peers=[boot.endpoint])
    try:
        with background_server(num_experts=0, expert_uids=uids, hidden_dim=D,
                               optimizer=optim.adam(1e-3), dht=server_dht,
                               update_period=2.0, device=device) as (_, srv):
            deadline = time.monotonic() + 30
            while True:
                alive = [asyncio.run(client.get_alive_experts_fresh(
                    f"{prefix}{i}")) for i in range(LAYERS)]
                found = sum(map(len, alive))
                if found == len(uids) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            assert found == len(uids), f"{found} of {len(uids)} experts alive"
            yield client, srv
    finally:
        for n in (client, server_dht, boot):
            n.shutdown()


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 258, (4, 16)), rs.randint(0, 258, (4, 16)))


@pytest.mark.cuda
def test_trains_on_the_card_through_a_dht(card):
    with _swarm("cuda", "cd") as (dht, srv):
        model = SwarmDMoETransformerLM(
            SwarmTransformerConfig(**CFG, uid_prefix="cd"), dht)
        params = model.init_params(jrandom.PRNGKey(0))
        assert {t.device.type for t in tree_leaves(params)} == {"cuda"}
        opt = optim.adamw(3e-3)
        step = model.make_train_step(opt)
        state = opt.init(params)
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state, *_batch())
            losses.append(float(loss))
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        updates = sum(b.update_count for b in srv.experts.values())
        sent = sum(m.backward_rpcs_sent for m in model.moes)
        acked = sum(m.backward_rpcs_ok for m in model.moes)
        assert 0 < acked <= updates <= sent


@pytest.mark.cuda
def test_first_step_on_the_card_matches_the_cpu(card):
    got = {}
    for device in ("cuda", "cpu"):
        with _swarm(device, "cc") as (dht, _):
            model = SwarmDMoETransformerLM(
                SwarmTransformerConfig(**CFG, uid_prefix="cc"), dht)
            params = model.init_params(jrandom.PRNGKey(1),
                                       device=device)
            loss, grads = optim.value_and_grad(model.loss_fn)(
                params, *_batch(1))
            got[device] = [loss] + tree_leaves(grads)
        reset_client_rpc()
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **TOL)
