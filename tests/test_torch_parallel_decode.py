"""The port's pod-mode decoders on a mesh against the JAX package's on
its virtual mesh: ``generate`` greedy and sampled, with and without the KV
cache, its guards, and the padding mask.

The decoding tests of ``tests/test_parallel.py``, one port test each.  Set
up as ``test_torch_parallel.py`` (spawned ``gloo`` CPU ranks, 4 for the
module, every wait bounded; a mesh of one rank in this process).  On a
mesh ``generate`` takes the whole prompt on every rank and returns the
whole output there: the trunk runs on every row alike and the MoE on each
rank's share of the flattened tokens, so a batch of fewer rows than
shards decodes too.
Tolerances: greedy tokens equal; logits within 2e-5 (f32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from torch_mesh_oracle import jax_mesh
from learning_at_home_tpu.models.transformer import (
    DMoETransformerConfig as JaxConfig,
    DMoETransformerLM as JaxLM,
)
from learning_at_home_tpu_torch.parallel.launch import RankGroup

ATOL = 2e-5
TIMEOUT_S = 120.0

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def ranks():
    """``ranks(n)``: this module's group of n gloo ranks."""
    torch.set_num_threads(1)
    # the 4 ranks start while the module's first test builds its JAX side
    groups = {4: RankGroup(4, timeout_s=TIMEOUT_S, wait=False)}

    def get(n):
        if n not in groups:
            groups[n] = RankGroup(n, timeout_s=TIMEOUT_S)
        return groups[n]

    yield get
    for g in groups.values():
        g.close()


TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, seq_len=16,
            num_experts=8, k=2)


def jax_model(axes, **over):
    mesh = jax_mesh(axes)
    cfg = JaxConfig(**{**TINY, "dtype": jnp.float32, **over})
    model = JaxLM(cfg, mesh)
    return model, jax.device_get(model.init_params(jax.random.PRNGKey(0)))


def port_kw(**over):
    return {**TINY, "dtype": torch.float32, **over}


def test_generate_greedy_decode_and_shapes(ranks):
    """expert 4, 2 rows (fewer rows than shards: the trunk runs on the
    whole buffer on every rank, the MoE on each rank's share of the
    tokens): the JAX tokens; sampling runs in range; the overflow guard."""
    jm, params = jax_model({"expert": 4})
    prompt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 5))
    g = ranks(4)
    outs = g.run(R.generate, {"expert": 4}, port_kw(), params, prompt, 5)
    for out in outs:
        np.testing.assert_array_equal(out, want)
    sampled = g.run(R.generate, {"expert": 4}, port_kw(), params, prompt, 5,
                    temperature=1.0, rng=1)
    assert all(np.array_equal(s, sampled[0]) for s in sampled)
    assert sampled[0].shape == (2, 8) and sampled[0].max() < 64
    errs = g.run(R.raises, "generate", {"expert": 4}, port_kw(), params,
                 prompt, 16)
    assert all(e is not None and e[0] == "ValueError" for e in errs)


def test_expert_choice_decode_falls_back_to_token_choice(ranks):
    jm, params = jax_model({"expert": 4}, gating="expert_choice")
    prompt = np.asarray([[1, 2, 3]], np.int32)
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 4))
    g = ranks(4)
    kw = port_kw(gating="expert_choice")
    assert g.run(R.decode_model_cfg, {"expert": 4}, kw)[0]["gating"] == "topk"
    for out in g.run(R.generate, {"expert": 4}, kw, params, prompt, 4):
        np.testing.assert_array_equal(out, want)
    cfg_j = g.run(R.decode_model_cfg, {"expert": 4},
                  port_kw(router_jitter=0.2))[0]
    assert cfg_j["router_jitter"] == 0.0


def test_padding_content_cannot_leak_into_decode_logits():
    """expert 1 (one rank, no process group): with the token mask the
    valid logits do not depend on the padding, as the JAX model's; without
    it the tight capacity makes them depend on it."""
    jm, params = jax_model({"expert": 1}, capacity_factor=0.5)
    p = 4
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, 64, (2, p))
    ids_a = np.concatenate([prompt, np.zeros((2, 16 - p), np.int64)], axis=1)
    ids_b = np.concatenate([prompt, rs.randint(0, 64, (2, 16 - p))], axis=1)
    mask = np.repeat(np.arange(16)[None, :] < p, 2, axis=0)
    kw = port_kw(capacity_factor=0.5)
    la, _ = R.apply({"expert": 1}, kw, params, ids_a, mask)
    lb, _ = R.apply({"expert": 1}, kw, params, ids_b, mask)
    np.testing.assert_array_equal(la[:, :p], lb[:, :p])
    jla, _ = jm.apply(params, jnp.asarray(ids_a), token_mask=jnp.asarray(mask))
    np.testing.assert_allclose(la, np.asarray(jla), atol=ATOL)
    ua, _ = R.apply({"expert": 1}, kw, params, ids_a)
    ub, _ = R.apply({"expert": 1}, kw, params, ids_b)
    assert not np.array_equal(ua[:, :p], ub[:, :p])


def test_kv_cache_decode_matches_full_forward(ranks):
    """expert 1: the cached decoder's tokens equal the re-forward
    decoder's and the JAX model's; on expert 2 x seq 2 the cache is
    refused with seq_parallel (NotImplementedError, as in JAX)."""
    jm, params = jax_model({"expert": 1}, seq_len=24, capacity_factor=8.0)
    prompt = np.asarray([[1, 2, 3, 4], [9, 8, 7, 6]], np.int32)
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 8))
    kw = port_kw(seq_len=24, capacity_factor=8.0)
    full = R.generate({"expert": 1}, kw, params, prompt, 8)
    cached = R.generate({"expert": 1}, kw, params, prompt, 8, use_cache=True)
    np.testing.assert_array_equal(full, want)
    np.testing.assert_array_equal(cached, want)
    one = R.generate({"expert": 1}, kw, params, prompt, 1, use_cache=True)
    np.testing.assert_array_equal(one, want[:, :5])
    t = R.generate({"expert": 1}, kw, params, prompt, 4, temperature=1.0,
                   rng=3, use_cache=True)
    assert t.shape == (2, 8) and t.max() < 64
    _, sp_params = jax_model({"expert": 2, "seq": 2}, seq_len=24,
                             capacity_factor=8.0, seq_parallel=True)
    errs = ranks(4).run(R.raises, "generate", {"expert": 2, "seq": 2},
                        dict(kw, seq_parallel=True), sp_params, prompt, 2,
                        use_cache=True)
    assert all(e is not None and e[0] == "NotImplementedError" for e in errs)


def test_kv_cache_decode_guards_row_shard_divisibility(ranks):
    """expert 4: 2 rows cannot divide over 4 token shards (ValueError
    naming them); 8 rows of 4 decode, the JAX tokens."""
    jm, params = jax_model({"expert": 4})
    g = ranks(4)
    prompt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    errs = g.run(R.raises, "generate", {"expert": 4}, port_kw(), params,
                 prompt, 2, use_cache=True)
    assert all(e[0] == "ValueError" and "token shards" in e[1] for e in errs)
    prompt8 = np.tile(np.asarray([[1, 2, 3, 4]], np.int32), (8, 1))
    want = np.asarray(jm.generate(params, jnp.asarray(prompt8), 2,
                                  use_cache=True))
    for out in g.run(R.generate, {"expert": 4}, port_kw(), params, prompt8,
                     2, use_cache=True):
        assert out.shape == (8, 6)
        np.testing.assert_array_equal(out, want)


def test_generate_zero_new_tokens_returns_prompt():
    _, params = jax_model({"expert": 1}, n_layers=1, num_experts=4)
    kw = port_kw(n_layers=1, num_experts=4)
    prompt = np.asarray([[1, 2, 3]], np.int32)
    for use_cache in (False, True):
        out = R.generate({"expert": 1}, kw, params, prompt, 0,
                         use_cache=use_cache)
        np.testing.assert_array_equal(out, prompt)
    err = R.raises("generate", {"expert": 1}, kw, params, prompt, -1)
    assert err[0] == "ValueError" and "max_new_tokens" in err[1]




def test_generate_on_a_seq_mesh(ranks):
    """Re-forward decoding with ``seq_parallel`` on expert 2 x seq 2: the
    whole buffer on every rank, the zigzag ring over ``seq`` on each
    rank's chunk of q, k, v and the MoE on its share of the tokens give
    the JAX model's greedy tokens on the same mesh."""
    over = dict(seq_parallel=True, capacity_factor=8.0)
    jm, params = jax_model({"expert": 2, "seq": 2}, **over)
    prompt = np.asarray([[1, 2, 3, 4], [9, 8, 7, 6]], np.int32)
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 4))
    for out in ranks(4).run(R.generate, {"expert": 2, "seq": 2},
                            port_kw(**over), params, prompt, 4):
        np.testing.assert_array_equal(out, want)
