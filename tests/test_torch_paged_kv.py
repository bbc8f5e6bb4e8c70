"""The port's paged KV cache (``models/kv_pages.py``, the paged
attention of ``models/trunk.py``) against the JAX package's, and the JAX
tests' paged-decoding contracts on the port.

- ``gather_kv_pages`` equals JAX's bit for bit and
  ``paged_one_query_attention`` JAX's within 2 f32 ulp of the largest
  output (the products sum in each library's order) on the same pools,
  tables and positions;
- a port ``PagedKVCache`` and a JAX one under the same calls (alloc,
  release, map_shared, copy-on-write, write, truncate, reclaim, prefix
  register and lookup, exhaustion) hold equal page tables, refcounts,
  free lists, ``audit()`` and ``stats()``, and pools of the same bits;
- on a port swarm: paged and dense decoding give the same tokens at a
  dividing and a non-dividing ``page_len``; chunked prefill gives the
  same tokens at any chunk size; a prefix hit equals a cold prefill and
  its copy-on-write page never aliases the writer; preemption and
  recompute are token-identical; page exhaustion sheds with
  ``retry_after_s`` and no error frame.
"""

from __future__ import annotations

import contextlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_at_home_tpu.models import trunk as jax_trunk
from learning_at_home_tpu.models.kv_pages import (
    PagedKVCache as JaxPagedKVCache,
    PagePressure as JaxPagePressure,
)
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client import reset_client_rpc
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.gateway import Gateway, GatewayClient
from learning_at_home_tpu_torch.models import trunk
from learning_at_home_tpu_torch.models.kv_pages import (
    PagedKVCache,
    PagePressure,
)
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


def _cfg(**overrides):
    base = dict(
        vocab_size=VOCAB, d_model=D, n_layers=LAYERS, n_heads=4,
        seq_len=SEQ, grid_size=(2,), k_best=2, k_min=2, uid_prefix="ffn",
        timeout_after_k_min=30.0,
        forward_timeout=60.0, backward_timeout=60.0,
        wire_codec="none", routing_cost_weight=0,
    )
    base.update(overrides)
    return SwarmTransformerConfig(**base)


@pytest.fixture(scope="module")
def swarm():
    """One in-process port server hosting all experts + a port model."""
    with contextlib.ExitStack() as stack:
        endpoint, _srv = stack.enter_context(background_server(
            expert_uids=UIDS, hidden_dim=D, seed=0, device="cpu"))
        model = SwarmDMoETransformerLM(
            _cfg(), StaticExpertSource({u: endpoint for u in UIDS}))
        yield model, model.init_params(jrandom.PRNGKey(0), device="cpu")
    reset_client_rpc()


def _decoder(swarm, **kw):
    model, params = swarm
    return SwarmKVDecoder(model, params, device="cpu", **kw)


# ---- the paged attention ----


def test_gather_and_paged_attention_equal_jax():
    rs = np.random.RandomState(0)
    pages, plen, h, hd, b, n = 9, 4, 2, 8, 3, 3
    k_pool = rs.randn(pages, plen, h, hd).astype(np.float32)
    v_pool = rs.randn(pages, plen, h, hd).astype(np.float32)
    table = rs.randint(0, pages, (b, n)).astype(np.int32)
    lp = {"wo": rs.randn(h * hd, h * hd).astype(np.float32)}
    q = rs.randn(b, 2, h, hd).astype(np.float32)
    t = np.asarray([[0, 5], [7, 11], [3, 3]], np.int32)[:, None, :, None]
    want = np.asarray(jax_trunk.gather_kv_pages(jnp.asarray(k_pool),
                                                jnp.asarray(table)))
    got = trunk.gather_kv_pages(torch.from_numpy(k_pool),
                                torch.from_numpy(table)).numpy()
    assert np.array_equal(got, want)
    want = np.asarray(jax_trunk.paged_one_query_attention(
        {"wo": jnp.asarray(lp["wo"])}, jnp.asarray(q), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(table), jnp.asarray(t)))
    got = trunk.paged_one_query_attention(
        {"wo": torch.from_numpy(lp["wo"])}, torch.from_numpy(q),
        torch.from_numpy(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(table), torch.from_numpy(t)).numpy()
    # the gathered views are the same bits; torch's and XLA's products sum
    # in their own orders, so the output is held within 2 f32 ulp of |y|
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.spacing(np.abs(want).max()))


# ---- the pool's bookkeeping against the JAX package's ----


def _state(kv) -> dict:
    return {
        "page_table": kv.page_table.tolist(),
        "alloc_count": kv.alloc_count.tolist(),
        "refcount": kv.refcount.tolist(),
        "free": list(kv._free),
        "entries": sorted((e.key, e.parent, e.tokens, e.page_id)
                          for e in kv._entries.values()),
        "audit": kv.audit(),
        "stats": kv.stats(),
    }


def _pools(kv) -> list:
    return [np.asarray(p) for p in (*kv.k_pools, *kv.v_pools)]


def test_pool_state_equals_jax_under_the_same_calls():
    kw = dict(n_layers=2, n_heads=2, head_dim=4, max_slots=3, seq_len=12,
              page_len=4, num_pages=7)
    jkv = JaxPagedKVCache(dtype=jnp.float32, **kw)
    tkv = PagedKVCache(dtype=torch.float32, device="cpu", **kw)
    rs = np.random.RandomState(3)

    def both(name, *args, expect=None):
        out = []
        for kv, pressure in ((jkv, JaxPagePressure), (tkv, PagePressure)):
            if expect is not None:
                with pytest.raises(pressure if expect == "pressure"
                                   else expect):
                    getattr(kv, name)(*args)
                out.append(None)
            else:
                out.append(getattr(kv, name)(*args))
        return out

    def write(layer, pids, rows):
        k = rs.randn(len(pids), 2, 4).astype(np.float32)
        v = rs.randn(len(pids), 2, 4).astype(np.float32)
        jkv.write_tokens(layer, np.asarray(pids), np.asarray(rows),
                         jnp.asarray(k), jnp.asarray(v))
        tkv.write_tokens(layer, np.asarray(pids), np.asarray(rows),
                         torch.from_numpy(k), torch.from_numpy(v))

    def check():
        assert _state(tkv) == _state(jkv)
        for got, want in zip(_pools(tkv), _pools(jkv)):
            assert np.array_equal(got, want)

    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    a, b = both("alloc_slot_page", 0), both("alloc_slot_page", 0)
    assert a[0] == a[1] and b[0] == b[1]
    for layer in range(2):
        write(layer, [a[0]] * 4 + [b[0]] * 4, list(range(4)) * 2)
    check()
    assert both("register_prefix", 0, prompt[:8]) == [2, 2]
    check()
    full_j, part_j = jkv.prefix_lookup(prompt[:6] + [9])
    full_t, part_t = tkv.prefix_lookup(prompt[:6] + [9])
    assert [e.page_id for e in full_t] == [e.page_id for e in full_j]
    assert (part_t[0].page_id, part_t[1]) == (part_j[0].page_id, part_j[1])
    for e_j, e_t in zip(full_j, full_t):
        jkv.map_shared(1, e_j)
        tkv.map_shared(1, e_t)
    dst = both("alloc_slot_page", 1)
    assert dst[0] == dst[1]
    both("copy_page_rows", part_j[0].page_id, dst[0], part_j[1])
    check()
    # a shared page refuses writes in both packages
    for kv, arr in ((jkv, jnp.zeros((1, 2, 4))), (tkv, torch.zeros(1, 2, 4))):
        with pytest.raises(AssertionError, match="copy-on-write"):
            kv.write_tokens(0, np.asarray([a[0]]), np.asarray([0]), arr, arr)
    for _ in range(3):
        both("alloc_slot_page", 2)
    # the pool is empty and no prefix page is reclaimable
    both("alloc_slot_page", 1, expect="pressure")
    check()
    assert both("truncate_slot", 2, 5) == [1, 1]
    both("release_slot", 0)
    check()
    assert both("pages_reclaimable") == [1, 1]  # b: held by its entry only
    both("release_slot", 1)
    assert both("reclaim", 1) == [1, 1]
    both("release_slot", 2)
    check()
    assert tkv.audit() == [] and tkv.pages_used() == jkv.pages_used()


def test_rollback_refuses_shared_pages():
    kv = PagedKVCache(n_layers=1, n_heads=2, head_dim=4,
                      dtype=torch.float32, max_slots=2, seq_len=16,
                      page_len=4, num_pages=8, device="cpu")
    for _ in range(4):
        kv.alloc_slot_page(0)
    assert kv.truncate_slot(0, 6) == 2 and kv.audit() == []
    assert kv.register_prefix(0, list(range(1, 9))) == 2
    with pytest.raises(AssertionError, match="rollback_private_only"):
        kv.truncate_slot(0, 2)
    assert kv.audit() == []


def test_pools_start_zeroed():
    """Masked positions get weight exactly 0 only over finite values."""
    kv = PagedKVCache(n_layers=1, n_heads=2, head_dim=4,
                      dtype=torch.float32, max_slots=1, seq_len=8,
                      page_len=4, device="cpu")
    assert all(torch.count_nonzero(p) == 0
               for p in (*kv.k_pools, *kv.v_pools))


# ---- decoding contracts on a port swarm ----


@pytest.mark.parametrize("page_len", [4, 5])
def test_paged_vs_dense_token_parity(swarm, page_len):
    prompts = [[1, 2, 3], [4, 5], [7, 8, 9, 10, 11]]
    out_d = _decoder(swarm, max_slots=3).generate(prompts, 6)
    paged = _decoder(swarm, max_slots=3, kv_layout="paged",
                     page_len=page_len)
    assert paged.generate(prompts, 6) == out_d
    assert paged.kv.pages_used() - paged.kv.pages_reclaimable() <= 0
    assert paged.kv.audit() == []


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_chunked_prefill_token_equal_any_chunk_size(swarm, chunk):
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    ref = _decoder(swarm, max_slots=1).generate([prompt], 4)[0]
    dec = _decoder(swarm, max_slots=1, kv_layout="paged", page_len=4,
                   prefix_cache=False)
    assert dec.begin_prefill(0, prompt, stream_id="s") == 0
    toks, tok = [], None
    while tok is None:
        consumed, tok = dec.prefill_step(0, chunk)
        assert consumed <= chunk
    toks.append(tok)
    while len(toks) < 4:
        assert dec.ensure_decode_pages() == []
        toks.append(int(dec.decode_step()[0]))
    assert toks == ref


def test_prefix_hit_matches_cold_and_cow_never_aliases(swarm):
    A = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    B = A[:10] + [7]
    warm = _decoder(swarm, max_slots=3, kv_layout="paged", page_len=4)
    cold = _decoder(swarm, max_slots=1, kv_layout="paged", page_len=4,
                    prefix_cache=False)
    warm.prefill_into_slot(0, A, stream_id="a")
    src_pid = int(warm.kv.page_table[0, 2])
    src = [p[src_pid].clone() for p in (*warm.kv.k_pools, *warm.kv.v_pools)]
    assert warm.begin_prefill(1, B, stream_id="b") == 10
    assert (warm.kv.prefix_hits_total, warm.kv.prefix_hit_tokens_total,
            warm.kv.cow_copies_total) == (1, 10, 1)
    assert int(warm.kv.page_table[1, 2]) != src_pid
    consumed_total, tok = 0, None
    while tok is None:
        consumed, tok = warm.prefill_step(1, SEQ)
        consumed_total += consumed
    assert consumed_total == 1
    assert tok == cold.prefill_into_slot(0, B, stream_id="cold")
    for _ in range(3):
        assert warm.ensure_decode_pages() == [] == cold.ensure_decode_pages()
        assert int(warm.decode_step()[1]) == int(cold.decode_step()[0])
    for before, pool in zip(src, (*warm.kv.k_pools, *warm.kv.v_pools)):
        assert torch.equal(pool[src_pid], before)
    assert warm.kv.audit() == []


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


def test_preemption_recompute_is_token_identical(swarm):
    model, params = swarm
    prompts = [[1, 2], [9, 8]]
    n_new = SEQ - 2
    ref = {tuple(p): _decoder(swarm, max_slots=1).generate([p], n_new)[0]
           for p in prompts}
    with Gateway(model, params, max_slots=2, max_pending=64, page_len=2,
                 num_pages=10, prefix_cache=False, prefill_chunk_tokens=4,
                 device="cpu") as gw:
        client = GatewayClient(gw.endpoint)
        # straight to the scheduler: admission would serialise them
        sids = [gw.scheduler.submit(p, n_new) for p in prompts]
        for p, sid in zip(prompts, sids):
            out = _poll_done(client, sid)
            assert out.get("error") is None, out
            assert out["tokens"] == ref[tuple(p)]
        assert gw.scheduler.preemptions_total >= 1
        assert gw.scheduler.streams_errored_total == 0
        assert gw.scheduler.audit() == [] and gw.decoder.kv.audit() == []


def test_page_exhaustion_sheds_with_retry_after_zero_errors(swarm):
    """A stream holding the whole 2-page pool makes the next submit a
    shed with ``retry_after_s``; the occupant is held mid-decode by the
    test (the decode thread waits on an event), so no timing decides
    whether the pool is full."""
    model, params = swarm
    with Gateway(model, params, max_slots=4, max_pending=64, page_len=8,
                 num_pages=3, prefix_cache=False, device="cpu") as gw:
        client = GatewayClient(gw.endpoint)
        started, release = threading.Event(), threading.Event()
        inner = gw.decoder.decode_step

        def held_decode_step():
            started.set()
            assert release.wait(60), "the test never released the decoder"
            return inner()

        gw.decoder.decode_step = held_decode_step
        sub = client.submit([1, 2, 3, 4], 12)
        assert sub.get("accepted"), sub
        assert started.wait(60), "the occupant never reached decode"
        shed = client.submit([5, 6, 7, 8], 8)
        release.set()
        assert shed["accepted"] is False and shed["shed"] is True
        assert isinstance(shed["retry_after_s"], float)
        assert shed["retry_after_s"] > 0 and "page pressure" in shed["message"]
        assert gw.admission.shed_pages_total >= 1
        out = _poll_done(client, sub["sid"])
        assert out.get("error") is None, out
        out = client.generate([1, 2, 3, 4], 8)
        assert not out.get("shed") and not out.get("error")
        assert gw.scheduler.streams_errored_total == 0
