"""The port's swarm KV decoder (``models/swarm_decoder.py``,
``models/drafter.py``) against the JAX package's ``SwarmKVDecoder``.

Twin swarms in one process: a JAX expert server and a port expert
server with the same experts (``expert_uids`` draw each expert from its
uid's key in both packages), a JAX swarm model and a port swarm model
initialised from the same key, unconverted.  Tolerances: tokens equal
(greedy and sampled, both KV layouts); the prefill logits behind each
first token within 2e-5; the decoder's tokens equal the re-forward
argmax chain through the port's ``model.apply``; speculative decoding
with either drafter equals plain decoding token for token, with the
rolled-back pages refcount-clean."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
import torch

from learning_at_home_tpu.client import reset_client_rpc as jax_reset
from learning_at_home_tpu.client.routing import (
    StaticExpertSource as JaxSource,
)
from learning_at_home_tpu.models import swarm_decoder as jax_decoder_module
from learning_at_home_tpu.models.sampling import SamplingParams as JaxSP
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
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.models import swarm_decoder
from learning_at_home_tpu_torch.models.drafter import (
    NGramDrafter,
    TruncatedTrunkDrafter,
)
from learning_at_home_tpu_torch.models.sampling import SamplingParams
from learning_at_home_tpu_torch.models.swarm_decoder import SwarmKVDecoder
from learning_at_home_tpu_torch.models.transformer_swarm import (
    SwarmDMoETransformerLM,
    SwarmTransformerConfig,
)
from learning_at_home_tpu_torch.server.server import background_server

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
PROMPTS = [[1, 2, 3], [4, 5], [7, 8, 9, 10, 11]]
NEW = 6
SAMPLING = [dict(seed=7 + i, temperature=0.9, top_p=0.95, top_k=8)
            for i in range(len(PROMPTS))]
LOGITS_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def twins():
    with contextlib.ExitStack() as stack:
        jep, _ = stack.enter_context(jax_background_server(
            expert_uids=UIDS, hidden_dim=D, seed=0))
        tep, _ = stack.enter_context(background_server(
            expert_uids=UIDS, hidden_dim=D, seed=0, device="cpu"))
        jmodel = JaxLM(JaxConfig(**CFG), JaxSource({u: jep for u in UIDS}))
        tmodel = SwarmDMoETransformerLM(
            SwarmTransformerConfig(**CFG),
            StaticExpertSource({u: tep for u in UIDS}))
        yield (jmodel, jmodel.init_params(jax.random.PRNGKey(0)), tmodel,
               tmodel.init_params(jrandom.PRNGKey(0), device="cpu"))
    reset_client_rpc()
    jax_reset()


def _recording(module, monkeypatch):
    """Record the logits every ``sample_token`` call of ``module`` sees."""
    seen = []
    inner = module.sample_token

    def record(logits, params, position):
        seen.append(np.asarray(logits, np.float32).copy())
        return inner(logits, params, position)

    monkeypatch.setattr(module, "sample_token", record)
    return seen


@pytest.fixture(scope="module")
def jax_streams(twins):
    """The JAX decoder's greedy streams (with the logits behind each
    prefill token) and sampled streams, computed once."""
    jmodel, jparams, _, _ = twins
    with pytest.MonkeyPatch.context() as mp:
        seen = _recording(jax_decoder_module, mp)
        greedy = JaxDecoder(jmodel, jparams, max_slots=3).generate(
            PROMPTS, NEW)
        prefill_logits = seen[:len(PROMPTS)]
    sampled = JaxDecoder(jmodel, jparams, max_slots=3).generate(
        PROMPTS, NEW, sampling=[JaxSP(**s) for s in SAMPLING])
    return greedy, prefill_logits, sampled


LAYOUTS = {"dense": dict(), "paged-4": dict(kv_layout="paged", page_len=4),
           "paged-5": dict(kv_layout="paged", page_len=5)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_equal_jax(twins, jax_streams, layout, monkeypatch):
    _, _, tmodel, tparams = twins
    greedy, prefill_logits, _ = jax_streams
    seen = _recording(swarm_decoder, monkeypatch)
    dec = SwarmKVDecoder(tmodel, tparams, max_slots=3, device="cpu",
                         **LAYOUTS[layout])
    assert dec.generate(PROMPTS, NEW) == greedy
    for got, want in zip(seen[:len(PROMPTS)], prefill_logits):
        np.testing.assert_allclose(got, want, **LOGITS_TOL)
    assert dec.free_slots() == [0, 1, 2]
    if dec.kv is not None:
        assert dec.kv.audit() == []


@pytest.mark.parametrize("layout", ["dense", "paged-5"])
def test_sampled_streams_equal_jax(twins, jax_streams, layout):
    _, _, tmodel, tparams = twins
    dec = SwarmKVDecoder(tmodel, tparams, max_slots=3, device="cpu",
                         **LAYOUTS[layout])
    out = dec.generate(PROMPTS, NEW,
                       sampling=[SamplingParams(**s) for s in SAMPLING])
    assert out == jax_streams[2]


def test_decoder_matches_reforward_argmax_chain(twins):
    """Greedy tokens of the KV decoder == the argmax chain of full
    re-forwards through ``model.apply``."""
    _, _, tmodel, tparams = twins
    outs = SwarmKVDecoder(tmodel, tparams, max_slots=3,
                          device="cpu").generate(PROMPTS, 4)
    for prompt, toks in zip(PROMPTS, outs):
        seq, ref = list(prompt), []
        for _ in range(4):
            with torch.no_grad():
                logits = tmodel.apply(tparams, torch.tensor([seq]))
            ref.append(int(logits[0, -1].argmax()))
            seq.append(ref[-1])
        assert toks == ref


def _reference(twins, prompt, n, sampling=None):
    _, _, tmodel, tparams = twins
    return SwarmKVDecoder(tmodel, tparams, max_slots=1,
                          device="cpu").generate([prompt], n,
                                                 sampling=[sampling])[0]


@pytest.mark.parametrize("drafter", ["ngram", "trunk"])
@pytest.mark.parametrize("sampled", [False, True])
def test_verify_step_equals_plain_decoding(twins, drafter, sampled):
    """Rounds of drafts from each drafter, verified in one trunk pass a
    round, commit exactly the plain decoder's tokens; every rollback
    leaves the pool refcount-clean."""
    _, _, tmodel, tparams = twins
    sp = SamplingParams(**SAMPLING[1]) if sampled else None
    prompt = [5, 6, 7, 5, 6, 7, 5, 6]
    n = SEQ - len(prompt)
    ref = _reference(twins, prompt, n, sp)
    dec = SwarmKVDecoder(tmodel, tparams, max_slots=1, device="cpu",
                         kv_layout="paged", page_len=2, prefix_cache=False)
    d = (NGramDrafter() if drafter == "ngram"
         else TruncatedTrunkDrafter(tmodel, dec.params, draft_layers=1))
    toks = [dec.prefill_into_slot(0, prompt, stream_id="s", sampling=sp)]
    proposed = 0
    while len(toks) < n:
        assert dec.ensure_decode_pages() == []
        room = min(3, n - len(toks) - 1, SEQ - 1 - int(dec.pos[0]))
        drafts = d.propose(prompt + toks, max(room, 0), sp) if room > 0 else []
        k = dec.ensure_lookahead_pages(0, len(drafts))
        res = dec.verify_step({0: drafts[:k]})[0]
        proposed += res["proposed"]
        toks.extend(res["tokens"])
        assert dec.kv.audit() == []
    assert toks[:n] == ref
    assert proposed > 0
    dec.evict(0)
    assert dec.kv.pages_used() == 0 and dec.kv.audit() == []


def test_verify_step_accepts_the_longest_prefix(twins):
    """A true continuation with one poisoned draft: accepted up to the
    poison plus the bonus token, the rejected lookahead pages freed."""
    _, _, tmodel, tparams = twins
    prompt = [3, 1, 4, 1, 5]
    ref = _reference(twins, prompt, 6)
    dec = SwarmKVDecoder(tmodel, tparams, max_slots=2, device="cpu",
                         kv_layout="paged", page_len=2, prefix_cache=False)
    assert dec.prefill_into_slot(0, prompt, stream_id="s") == ref[0]
    drafts = [ref[1], ref[2], (ref[3] + 1) % VOCAB, ref[4]]
    assert dec.ensure_decode_pages() == []
    assert dec.ensure_lookahead_pages(0, len(drafts)) == len(drafts)
    res = dec.verify_step({0: drafts})[0]
    assert (res["accepted"], res["proposed"]) == (2, 4)
    assert res["tokens"] == ref[1:4]
    assert int(dec.pos[0]) == len(prompt) + 3
    assert dec.kv.audit() == [] and dec.kv.rollback_pages_total >= 1


def test_decoder_without_a_card_raises(twins, monkeypatch):
    _, _, tmodel, tparams = twins
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SwarmKVDecoder(tmodel, tparams)
