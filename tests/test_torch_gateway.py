"""The port's serving gateway (``gateway/``) against the JAX package's.

- The coalescer: grouping counts equal the JAX coalescer's on the same
  gate logits; one grouped dispatch gives the bits of per-stream
  dispatches, and so does a failed preview; coalesced and solo gateways,
  greedy and sampled, give the same tokens.
- The expert forward's row invariance, which that contract rests on: a
  row sent to a port server alone and inside batches that fill buckets
  of 2..16 (and across a row tile) comes back with the same bits.
- Admission sheds instead of queueing; 100 churned streams leak no slot,
  page or stream record (``audit()`` empty); hostile submits get error
  frames.
- Speculative decoding through the gateway equals plain decoding.
- The mixed wire: a JAX ``GatewayClient`` drives a port ``Gateway`` and
  a port ``GatewayClient`` a JAX ``Gateway``; tokens equal each package's
  bare decoder and ``stats`` have the JAX gateway's keys.
Tolerances: none (bits and token ids equal)."""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np
import pytest
import torch

from learning_at_home_tpu.client import reset_client_rpc as jax_reset
from learning_at_home_tpu.client.routing import (
    StaticExpertSource as JaxSource,
)
from learning_at_home_tpu.gateway import (
    ExpertCoalescer as JaxCoalescer,
    Gateway as JaxGateway,
    GatewayClient as JaxGatewayClient,
)
from learning_at_home_tpu.client.moe import (
    RemoteMixtureOfExperts as JaxMoE,
)
from learning_at_home_tpu.models.swarm_decoder import (
    SwarmKVDecoder as JaxDecoder,
)
from learning_at_home_tpu.models.transformer_swarm import (
    SwarmDMoETransformerLM as JaxLM,
    SwarmTransformerConfig as JaxConfig,
)
from learning_at_home_tpu.server.server import (
    background_server as jax_background_server,
)
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client import reset_client_rpc
from learning_at_home_tpu_torch.client.expert import RemoteExpert
from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.gateway import (
    AdmissionController,
    ExpertCoalescer,
    Gateway,
    GatewayClient,
)
from learning_at_home_tpu_torch.models.swarm_decoder import SwarmKVDecoder
from learning_at_home_tpu_torch.models.transformer_swarm import (
    SwarmDMoETransformerLM,
    SwarmTransformerConfig,
)
from learning_at_home_tpu_torch.server.expert_backend import ROW_TILE
from learning_at_home_tpu_torch.server.server import background_server
from learning_at_home_tpu_torch.utils.connection import RemoteCallError

D = 16
VOCAB = 32
SEQ = 16
LAYERS = 2
UIDS = [f"ffn{layer}.{e}" for layer in range(LAYERS) for e in range(2)]
CFG = dict(
    vocab_size=VOCAB, d_model=D, n_layers=LAYERS, n_heads=4, seq_len=SEQ,
    grid_size=(2,), k_best=2, k_min=2, uid_prefix="ffn",
    timeout_after_k_min=30.0, forward_timeout=60.0, backward_timeout=60.0,
    wire_codec="none", routing_cost_weight=0,
)
REPETITIVE = [5, 6, 7, 5, 6, 7, 5, 6]


@pytest.fixture(scope="module")
def swarm():
    """One in-process port server hosting all experts + a port model."""
    with contextlib.ExitStack() as stack:
        endpoint, srv = stack.enter_context(background_server(
            expert_uids=UIDS, hidden_dim=D, seed=0, device="cpu"))
        model = SwarmDMoETransformerLM(
            SwarmTransformerConfig(**CFG),
            StaticExpertSource({u: endpoint for u in UIDS}))
        yield model, model.init_params(jrandom.PRNGKey(0), device="cpu"), srv
    reset_client_rpc()


def _poll_done(client, sid, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    cursor, tokens = 0, []
    while time.monotonic() < deadline:
        out = client.poll(sid, cursor)
        tokens.extend(out.get("tokens") or [])
        cursor = int(out.get("cursor") or cursor)
        if out.get("done"):
            out["tokens"] = tokens
            return out
        time.sleep(0.01)
    raise AssertionError(f"stream {sid} did not finish in {deadline_s} s")


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


def _wait(cond, what, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not within {deadline_s} s")
        time.sleep(0.02)


# ---- row invariance of the expert forward ----


def test_a_row_has_the_same_bits_in_every_bucket(swarm):
    """One row through the port server alone, then at every position of
    batches of 2..16 rows (buckets 2, 4, 8, 16) and of batches spanning
    two row tiles: its output bits never change."""
    _, _, srv = swarm
    expert = RemoteExpert("ffn0.1", srv.endpoint)
    rs = np.random.RandomState(0)
    row = rs.randn(1, D).astype(np.float32)
    solo = expert.forward_blocking([row])[0][0]
    sizes = list(range(2, 17)) + [ROW_TILE["cpu"] + 3]
    for m in sizes:
        for pos in sorted({0, m // 2, m - 1}):
            batch = rs.randn(m, D).astype(np.float32)
            batch[pos] = row[0]
            out = expert.forward_blocking([batch])[0]
            assert np.array_equal(out[pos], solo), (m, pos)


# ---- the coalescer ----


def test_grouping_counts_equal_jax():
    """The union-find grouping over previewed expert sets, on one grid of
    16 experts (k_best 2) and the same seeded gate logits: the same
    groups in the same order as the JAX coalescer's."""
    uids = {f"g.{i}.{j}": ("127.0.0.1", 1) for i in range(4)
            for j in range(4)}
    kw = dict(in_features=D, grid_size=(4, 4), uid_prefix="g", k_best=2)
    tmoe = RemoteMixtureOfExperts(**kw, source=StaticExpertSource(uids))
    jmoe = JaxMoE(**kw, source=JaxSource(uids))
    rs = np.random.RandomState(4)
    for trial in range(6):
        rows = 10
        logits = rs.randn(rows, 8).astype(np.float32)
        streams = [f"s{r % (3 + trial)}" for r in range(rows)]
        stream_rows: dict = {}
        for r, s in enumerate(streams):
            stream_rows.setdefault(s, []).append(r)
        want = JaxCoalescer()._group(jmoe, logits, stream_rows)
        got = ExpertCoalescer()._group(tmoe, logits, stream_rows)
        assert got == want


def test_coalesced_dispatch_bitwise_equals_ungrouped(swarm):
    model, params, _ = swarm
    moe, gate = model.moes[0], params["layers"][0]["gate"]
    x = torch.from_numpy(np.random.RandomState(0).randn(4, D)).float()
    streams = ["a", "b", "c", "d"]
    grouped, ungrouped = ExpertCoalescer(True), ExpertCoalescer(False)
    y_g = grouped.dispatch(0, moe, gate, x, streams)
    y_u = ungrouped.dispatch(0, moe, gate, x, streams)
    assert np.array_equal(y_g, y_u)
    assert (grouped.group_dispatches_total,
            grouped.coalesced_dispatches_total) == (1, 3)
    assert (ungrouped.group_dispatches_total,
            ungrouped.coalesced_dispatches_total) == (4, 0)


def test_preview_failure_falls_back_to_singletons(swarm, monkeypatch):
    model, params, _ = swarm
    moe, gate = model.moes[0], params["layers"][0]["gate"]
    x = torch.from_numpy(np.random.RandomState(1).randn(2, D)).float()
    y_ref = ExpertCoalescer(False).dispatch(0, moe, gate, x, ["a", "b"])
    co = ExpertCoalescer(True)

    def down(*_a, **_k):
        raise RuntimeError("preview down")

    monkeypatch.setattr(moe, "preview_expert_sets", down)
    y = co.dispatch(0, moe, gate, x, ["a", "b"])
    assert np.array_equal(y, y_ref)
    assert co.preview_failures_total == 1
    assert co.coalesced_dispatches_total == 0


@pytest.mark.parametrize("sampled", [False, True])
def test_coalesced_gateway_tokens_equal_solo(swarm, sampled):
    model, params, _ = swarm
    prompts = [[1, 2, 3], [4, 5, 6, 7], [7, 8]]
    results = {}
    for coalesce in (True, False):
        with Gateway(model, params, max_slots=4, coalesce=coalesce,
                     device="cpu") as gw:
            client = GatewayClient(gw.endpoint)
            sids = [_submit(client, p, 5, **(dict(
                seed=19 + i, temperature=0.9, top_p=0.95, top_k=8)
                if sampled else {})) for i, p in enumerate(prompts)]
            outs = [_poll_done(client, sid) for sid in sids]
            assert all(o.get("error") is None for o in outs)
            results[coalesce] = [o["tokens"] for o in outs]
            assert gw.scheduler.audit() == []
    assert results[True] == results[False]


# ---- admission, churn, hostile submits ----


def test_saturated_gateway_sheds_not_queues(swarm):
    model, params, _ = swarm
    with Gateway(model, params, max_slots=1, max_pending=2,
                 device="cpu") as gw:
        client = GatewayClient(gw.endpoint)
        replies = [client.submit([1, 2], SEQ - 3) for _ in range(12)]
        shed = [r for r in replies if r.get("shed")]
        assert shed, "12 submits into 1 slot + 2 pending never shed"
        for r in shed:
            assert r["accepted"] is False and r["retry_after_s"] > 0
            assert ("saturated" in r["message"]
                    or "page pressure" in r["message"])
        assert gw.scheduler.pending_count() <= 2
        assert gw.admission.shed_total == len(shed)
        for r in replies:
            if r.get("accepted"):
                client.cancel(r["sid"])


def test_admission_server_queue_signal():
    class _StubSched:
        def pending_count(self):
            return 0

        def estimate_retry_after_s(self):
            return 1.5

    ctrl = AdmissionController(
        _StubSched(), max_pending=4, max_server_queue=8.0,
        load_fn=lambda: {"srv": {"q": 99.0}, "junk": "not-a-dict"})
    assert ctrl.admit() == (True, None, None)
    ctrl._refresh_once()
    ok, retry, reason = ctrl.admit()
    assert not ok and retry == 1.5 and "servers saturated" in reason


def test_stream_churn_no_slot_leak(swarm):
    """100 streams with long budgets, cancelled in flight: every slot,
    page and stream record comes back (deadlines, not sleeps, bound each
    wait)."""
    model, params, _ = swarm
    # admission keeps a page in reserve for every active stream: 8 pages
    # (and scratch page 0) admit a batch of 4 one-page streams whatever
    # the decode thread has admitted when each submit arrives
    with Gateway(model, params, max_slots=4, max_pending=400,
                 stream_ttl_s=0.5, num_pages=9, device="cpu") as gw:
        client = GatewayClient(gw.endpoint)

        def idle():
            s = gw.scheduler.stats()
            return s["streams_active"] == 0 and s["pending"] == 0

        sids = []
        for i in range(100):
            r = client.submit([1 + (i % 8), 2], SEQ - 3)
            assert r.get("accepted"), r
            sids.append(r["sid"])
            if i % 4 == 3:
                # cancel in flight, once one of the four has a token; the
                # next four come once these have given their pages back
                batch = sids[-4:]
                _wait(lambda: any(client.poll(s, 0).get("tokens")
                                  for s in batch), "a token of the batch")
                for sid in batch:
                    client.cancel(sid)
                _wait(idle, "the gateway idle after a batch of cancels")
        s = gw.scheduler.stats()
        assert s["slots_in_use"] == 0
        assert gw.decoder.free_slots() == [0, 1, 2, 3]
        assert (s["streams_cancelled_total"] + s["streams_finished_total"]
                + s["streams_errored_total"]) == 100
        assert s["streams_errored_total"] == 0
        assert gw.scheduler.audit() == [] and gw.decoder.kv.audit() == []

        def drained():
            with gw.scheduler._lock:
                return not gw.scheduler._streams

        _wait(drained, "the stream table GC'd")


def test_gen_submit_rejects_hostile_fields(swarm):
    model, params, _ = swarm
    with Gateway(model, params, max_slots=2, device="cpu") as gw:
        client = GatewayClient(gw.endpoint)
        for bad in ({"temperature": float("nan")}, {"temperature": True},
                    {"top_p": 2.0}, {"top_k": 1.5}, {"seed": "abc"},
                    {"prompt": []}, {"prompt": [VOCAB]},
                    {"prompt": list(range(SEQ))}, {"max_new_tokens": 0}):
            meta = {"prompt": [1, 2, 3], "max_new_tokens": 2, **bad}
            with pytest.raises(RemoteCallError):
                client._rpc("gen_submit", meta)
        out = client.generate([1, 2, 3], 3, seed=5, temperature=0.7)
        assert not out.get("error") and len(out["tokens"]) == 3
        assert gw.scheduler.streams_errored_total == 0


# ---- speculative decoding through the gateway ----


@pytest.mark.parametrize("drafter", ["ngram", "trunk"])
def test_gateway_spec_decode_token_identical(swarm, drafter):
    model, params, _ = swarm
    prompts = [REPETITIVE, [1, 2, 1, 2, 1], [9, 8, 9, 8]]
    results = {}
    for k in (4, 0):
        with Gateway(model, params, max_slots=4, spec_k=k,
                     spec_drafter=drafter, device="cpu") as gw:
            client = GatewayClient(gw.endpoint)
            outs = [client.generate(p, 6, seed=3 + i, temperature=0.8,
                                    top_k=6) if i == 1
                    else client.generate(p, 6)
                    for i, p in enumerate(prompts)]
            assert all(not o.get("shed") and not o.get("error")
                       for o in outs)
            results[k] = [o["tokens"] for o in outs]
            if k:
                s = gw.scheduler.stats()
                assert s["spec_rounds_total"] >= 1
                assert gw.scheduler.audit() == []
    assert results[4] == results[0]


# ---- the mixed wire ----


@pytest.fixture(scope="module")
def jax_swarm():
    with contextlib.ExitStack() as stack:
        jep, _ = stack.enter_context(jax_background_server(
            expert_uids=UIDS, hidden_dim=D, seed=0))
        jmodel = JaxLM(JaxConfig(**CFG), JaxSource({u: jep for u in UIDS}))
        yield jmodel, jmodel.init_params(jax.random.PRNGKey(0))
    jax_reset()


def test_jax_client_drives_port_gateway(swarm):
    model, params, _ = swarm
    prompt = [1, 2, 3]
    ref = SwarmKVDecoder(model, params, max_slots=1,
                         device="cpu").generate([prompt], 5)[0]
    with Gateway(model, params, max_slots=4, device="cpu") as gw:
        client = JaxGatewayClient(gw.endpoint)
        out = client.generate(prompt, 5)
        assert not out.get("shed") and not out.get("error")
        assert out["tokens"] == ref
        sampled = client.generate(prompt, 5, seed=11, temperature=0.8,
                                  top_p=0.9, top_k=6)
        assert not sampled.get("error") and len(sampled["tokens"]) == 5
        st = client.stats()
        assert st["gateway"]["streams_finished_total"] >= 2
        assert st["metrics"]["collected"]["lah_gateway_tokens_total"] >= 10


def test_port_client_drives_jax_gateway_and_stats_agree(swarm, jax_swarm):
    """A port client against a JAX gateway: the JAX bare decoder's
    tokens, and the port's tokens too (same key, same experts); the two
    gateways' ``stats`` carry the same keys."""
    jmodel, jparams = jax_swarm
    model, params, _ = swarm
    prompt = [1, 2, 3]
    ref = JaxDecoder(jmodel, jparams, max_slots=1).generate([prompt], 5)[0]
    port_ref = SwarmKVDecoder(model, params, max_slots=1,
                              device="cpu").generate([prompt], 5)[0]
    assert port_ref == ref
    with JaxGateway(jmodel, jparams, max_slots=2) as jgw:
        client = GatewayClient(jgw.endpoint)
        out = client.generate(prompt, 5)
        assert not out.get("shed") and not out.get("error")
        assert out["tokens"] == ref
        jstats = client.stats()
    with Gateway(model, params, max_slots=2, device="cpu") as gw:
        tstats = GatewayClient(gw.endpoint).stats()
    ignore = {"uptime_s"}
    assert set(tstats["gateway"]) - ignore == set(jstats["gateway"]) - ignore
    assert set(tstats) == set(jstats)
