"""The port's serving gateway on a CUDA card.

- The card decoder against the CPU decoder: twin port servers (the same
  uid-keyed experts, one on the card and one on the CPU) and one key's
  params; greedy tokens equal on both KV layouts (``page_len`` 5 does not
  divide the sequence), prefill logits within 2e-4 + 2e-4·|ref| (cuBLAS
  and the CPU sum in other orders; TF32 off).
- Row invariance on the card: one row through a card server alone and
  inside batches that fill buckets of 2..16 and two row tiles comes back
  with the same bits, so coalesced and solo gateways give the same tokens.
The tests need the card and skip without one; the file imports torch
only:

    python -m pytest --noconftest -m cuda tests/test_torch_gateway_cuda.py
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client.expert import RemoteExpert
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.gateway import Gateway, GatewayClient
from learning_at_home_tpu_torch.models import swarm_decoder
from learning_at_home_tpu_torch.models.swarm_decoder import SwarmKVDecoder
from learning_at_home_tpu_torch.models.transformer_swarm import (
    SwarmDMoETransformerLM,
    SwarmTransformerConfig,
)
from learning_at_home_tpu_torch.server.expert_backend import ROW_TILE
from learning_at_home_tpu_torch.server.server import background_server

D, LAYERS, SEQ = 64, 2, 32
UIDS = [f"gc{layer}.{e}" for layer in range(LAYERS) for e in range(4)]
CFG = dict(vocab_size=258, d_model=D, n_layers=LAYERS, n_heads=4,
           seq_len=SEQ, grid_size=(4,), k_best=2, k_min=2, uid_prefix="gc",
           timeout_after_k_min=30.0, forward_timeout=60.0,
           backward_timeout=60.0, wire_codec="none", routing_cost_weight=0)
PROMPTS = [[1, 2, 3, 4, 5], [40, 41], [7, 8, 9, 10, 11, 12, 13, 14, 15]]


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
def _model(device):
    with background_server(expert_uids=UIDS, hidden_dim=D, seed=0,
                           device=device, max_batch_size=1024) as (ep, srv):
        model = SwarmDMoETransformerLM(
            SwarmTransformerConfig(**CFG),
            StaticExpertSource({u: ep for u in UIDS}))
        yield model, model.init_params(jrandom.PRNGKey(0),
                                       device=device), srv


def _run(device, monkeypatch, **kw):
    seen = []
    inner = swarm_decoder.sample_token

    def record(logits, params, position):
        seen.append(torch.as_tensor(logits).float().cpu())
        return inner(logits, params, position)

    monkeypatch.setattr(swarm_decoder, "sample_token", record)
    with _model(device) as (model, params, _):
        dec = SwarmKVDecoder(model, params, max_slots=3, device=device, **kw)
        toks = dec.generate(PROMPTS, 12)
    monkeypatch.setattr(swarm_decoder, "sample_token", inner)
    return toks, seen[:len(PROMPTS)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_card_decoder_matches_the_cpu_decoder(card, monkeypatch, layout):
    kw = dict(kv_layout="paged", page_len=5) if layout == "paged" else {}
    got, got_logits = _run("cuda", monkeypatch, **kw)
    want, want_logits = _run("cpu", monkeypatch, **kw)
    assert got == want
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.cuda
def test_a_row_has_the_same_bits_in_every_bucket_on_the_card(card):
    with _model("cuda") as (_, _, srv):
        expert = RemoteExpert(UIDS[1], srv.endpoint)
        rs = np.random.RandomState(0)
        row = rs.randn(1, D).astype(np.float32)
        solo = expert.forward_blocking([row])[0][0]
        for m in list(range(2, 17)) + [ROW_TILE["cuda"] + 3]:
            for pos in sorted({0, m // 2, m - 1}):
                batch = rs.randn(m, D).astype(np.float32)
                batch[pos] = row[0]
                out = expert.forward_blocking([batch])[0]
                assert np.array_equal(out[pos], solo), (m, pos)


def _submit(client, prompt, max_new, **kw) -> str:
    """Submit until admitted: a shed (page headroom or the pending bound,
    depending on what the decode thread has admitted meanwhile) is
    retried after its ``retry_after_s``; returns the stream id."""
    for _ in range(100):
        sub = client.submit(prompt, max_new, **kw)
        if sub.get("accepted"):
            return sub["sid"]
        assert sub.get("shed"), sub
        time.sleep(float(sub["retry_after_s"]))
    raise AssertionError(f"never admitted: {sub}")


def _finish(client, sid, deadline_s=120.0):
    deadline = time.monotonic() + deadline_s
    cursor, tokens = 0, []
    while time.monotonic() < deadline:
        out = client.poll(sid, cursor)
        tokens.extend(out.get("tokens") or [])
        cursor = int(out.get("cursor") or cursor)
        if out.get("done"):
            assert out.get("error") is None, out
            return tokens
        time.sleep(0.01)
    raise AssertionError(f"stream {sid} did not finish in {deadline_s} s")


@pytest.mark.cuda
def test_coalesced_gateway_on_the_card_equals_solo(card):
    """Greedy and sampled streams submitted together, so their rows share
    decode steps: the same tokens with and without coalescing."""
    with _model("cuda") as (model, params, _):
        results = {}
        for coalesce in (True, False):
            with Gateway(model, params, max_slots=8, coalesce=coalesce,
                         device="cuda") as gw:
                client = GatewayClient(gw.endpoint)
                sids = [_submit(client, p, 8) for p in PROMPTS] + [
                    _submit(client, p, 8, seed=i, temperature=0.8, top_p=0.9)
                    for i, p in enumerate(PROMPTS)]
                results[coalesce] = [_finish(client, sid) for sid in sids]
                assert gw.scheduler.audit() == []
                if coalesce:
                    assert gw.coalescer.coalesced_dispatches_total > 0
        assert results[True] == results[False]
