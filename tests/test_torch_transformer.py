"""The port's pod-mode DMoE-Transformer (models/transformer.py, convert.py)
against the JAX package: the same params (converted), the same ids.

The model is the tiny flagship of the JAX package's own smoke config:
vocab 256, d 64, 2 layers, 4 heads, seq 32, 4 experts, top-2, f32, on a
one-device mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_at_home_tpu.models.transformer import (
    DMoETransformerConfig as JaxConfig,
    DMoETransformerLM as JaxLM,
)
from learning_at_home_tpu.parallel.mesh import make_mesh
from learning_at_home_tpu_torch import random as prng
from learning_at_home_tpu_torch.convert import (
    param_shapes,
    params_from_jax,
    params_to_jax,
)
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, seq_len=32,
            num_experts=4, k=2)
LAYOUTS = {
    "stacked": dict(),
    "tuple-untied": dict(stack_layers=False, scan_layers=False,
                         tie_embeddings=False),
}
_TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True)
def _full_precision_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_config(jcfg: JaxConfig) -> DMoETransformerConfig:
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = _TORCH_DTYPES[jcfg.dtype]
    fields["param_dtype"] = _TORCH_DTYPES[jcfg.param_dtype]
    return DMoETransformerConfig(**fields)


class Pair:
    """One tiny model in both packages, sharing converted params."""

    def __init__(self, layout, **over):
        self.jcfg = JaxConfig(**TINY, dtype=jnp.float32, **LAYOUTS[layout],
                              **over)
        mesh = make_mesh({"expert": 1}, devices=jax.devices()[:1])
        self.jmodel = JaxLM(self.jcfg, mesh)
        self.jparams = self.jmodel.init_params(jax.random.PRNGKey(0))
        self.np_tree = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.tcfg = torch_config(self.jcfg)
        self.tmodel = DMoETransformerLM(self.tcfg, device="cpu")
        self.tparams = params_from_jax(self.np_tree, self.tcfg, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    return {layout: Pair(layout) for layout in LAYOUTS}


def _ids(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_apply_logits_match_jax(pairs, layout, masked):
    pair = pairs[layout]
    ids = _ids(1, (2, 32))
    mask = None
    if masked:  # right padding, as generate's re-forward routes it
        mask = np.arange(32)[None, :] < np.array([[20], [9]])
    jlogits, jaux = jax.jit(pair.jmodel.apply)(
        pair.jparams, jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask))
    tlogits, taux = pair.tmodel.apply(
        pair.tparams, torch.from_numpy(ids),
        None if mask is None else torch.from_numpy(mask))
    assert tlogits.dtype == torch.float32 and tlogits.shape == (2, 32, 256)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_key_seeded_models_agree_unconverted(pairs, layout):
    """One key, two packages, no conversion: the port's ``init_params``
    of the JAX model's key gives the JAX model's logits (2e-5)."""
    pair = pairs[layout]
    ids = _ids(2, (2, 32))
    jlogits, _ = jax.jit(pair.jmodel.apply)(pair.jparams, jnp.asarray(ids))
    own = pair.tmodel.init_params(prng.PRNGKey(0))
    tlogits, _ = pair.tmodel.apply(own, torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_generate_matches_jax_token_for_token(pairs, use_cache):
    pair = pairs["stacked"]
    prompt = _ids(2, (2, 5))
    want = np.asarray(pair.jmodel.generate(
        pair.jparams, jnp.asarray(prompt), 10, use_cache=use_cache))
    got = pair.tmodel.generate(pair.tparams, torch.from_numpy(prompt), 10,
                               use_cache=use_cache)
    assert got.dtype == torch.int32 and got.shape == (2, 15)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_cache", [True, False])
def test_tuple_layout_decodes_like_stacked(pairs, use_cache):
    """The same weights in the tuple layout give the same tokens."""
    base = pairs["stacked"]
    stacked = base.tparams["layers"]
    layers = tuple(jax.tree_util.tree_map(lambda t: t[i], stacked)
                   for i in range(base.tcfg.n_layers))
    model = DMoETransformerLM(
        dataclasses.replace(base.tcfg, stack_layers=False, scan_layers=False),
        device="cpu")
    prompt = torch.from_numpy(_ids(3, (2, 4)))
    want = base.tmodel.generate(base.tparams, prompt, 6, use_cache=use_cache)
    got = model.generate({**base.tparams, "layers": layers}, prompt, 6,
                         use_cache=use_cache)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    dict(layout="stacked", param_dtype=jnp.float32),
    dict(layout="tuple-untied", param_dtype=jnp.float32),
    dict(layout="stacked", param_dtype=jnp.bfloat16),
])
def test_params_round_trip_is_bitwise(case):
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, param_dtype=case["param_dtype"],
                     **LAYOUTS[case["layout"]])
    model = JaxLM(jcfg, make_mesh({"expert": 1}, devices=jax.devices()[:1]))
    tree = jax.tree_util.tree_map(np.asarray,
                                  model.init_params(jax.random.PRNGKey(3)))
    params = params_from_jax(tree, jcfg, device="cpu")
    back = params_to_jax(params, jcfg)
    flat_a, treedef_a = jax.tree_util.tree_flatten(tree)
    flat_b, treedef_b = jax.tree_util.tree_flatten(back)
    assert treedef_a == treedef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_converter_refuses_a_tree_of_another_config(pairs):
    tree, cfg = pairs["stacked"].np_tree, pairs["stacked"].tcfg
    for over, match in [
        (dict(stack_layers=False, scan_layers=False), "tuple"),
        (dict(num_experts=8), "shape"),
        (dict(tie_embeddings=False), "lm_head"),
    ]:
        with pytest.raises(ValueError, match=match):
            params_from_jax(tree, dataclasses.replace(cfg, **over),
                            device="cpu")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_init_params_has_the_jax_layout(pairs, layout):
    pair = pairs[layout]
    params = pair.tmodel.init_params(prng.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: a.shape, pair.np_tree)
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert got == want == param_shapes(pair.tcfg)


def test_model_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DMoETransformerLM(DMoETransformerConfig(**TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({}, DMoETransformerConfig(**TINY))


def test_logits_are_f32_products_of_bf16_operands():
    """``_logits`` must not round to bf16: compare with the JAX einsum
    (bf16 operands, f32 accumulation, f32 result)."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((6, 64)), jnp.bfloat16)
    head = jnp.asarray(rng.standard_normal((64, 300)), jnp.bfloat16)
    want = np.asarray(JaxLM._logits(x, head))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    th = torch.from_numpy(np.array(head.astype(jnp.float32))).to(torch.bfloat16)
    got = DMoETransformerLM._logits(tx, th)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    # a bf16 matmul would be off by bf16 rounding of the result
    assert np.abs((tx @ th).float().numpy() - want).max() > 1e-2


@pytest.mark.parametrize("seq_len,device,want", [
    (32, "cpu", "xla"), (8192, "cpu", "xla"), (8192, "cuda", "flash"),
    (16384, "cuda", "flash"), (4096, "cuda", "xla"), (8200, "cuda", "xla"),
])
def test_auto_attention_rule(seq_len, device, want):
    """The JAX rule with the CUDA card in the place of the TPU.  Nothing
    is allocated, so the rule is checked without a card."""
    cfg = DMoETransformerConfig(**{**TINY, "seq_len": seq_len})
    assert DMoETransformerLM(cfg, device=device).cfg.attn_impl == want


@pytest.mark.parametrize("over", [dict(seq_parallel=True)])
def test_unported_training_features_raise(over):
    cfg = DMoETransformerConfig(**TINY, dtype=torch.float32, **over)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DMoETransformerLM(cfg, device="cpu")


@pytest.mark.parametrize("over", [dict(router_jitter=0.2),
                                  dict(gating="expert_choice")])
def test_generate_decodes_with_eval_routing(pairs, over):
    """Training-time routing runs in apply, where it gives the JAX
    model's logits and aux scalars, and is switched off for generate,
    which then decodes as the clean config does."""
    base = pairs["stacked"]
    model = DMoETransformerLM(dataclasses.replace(base.tcfg, **over),
                              device="cpu")
    jmodel = JaxLM(dataclasses.replace(base.jcfg, **over),
                   make_mesh({"expert": 1}, devices=jax.devices()[:1]))
    ids = torch.from_numpy(_ids(4, (2, 32)))
    jlogits, jaux = jax.jit(jmodel.apply)(base.jparams, jnp.asarray(ids.numpy()))
    tlogits, taux = model.apply(base.tparams, ids)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   atol=1e-5, rtol=1e-4)
    ids = ids[:, :6]
    want = base.tmodel.generate(base.tparams, ids, 4, use_cache=True)
    assert torch.equal(model.generate(base.tparams, ids, 4, use_cache=True),
                       want)


def test_generate_validates_and_samples_with_a_generator(pairs):
    """The sampling path's validation, and its draws: a function of the
    rng key alone (the same key gives the same tokens, another key other
    tokens), with the prompt kept."""
    pair = pairs["stacked"]
    m, p = pair.tmodel, pair.tparams
    ids = torch.from_numpy(_ids(5, (2, 6)))
    for args, kw in [((torch.zeros((2, 0), dtype=torch.int32), 3), {}),
                     ((ids, 40), {}), ((ids, -1), {}),
                     ((ids, 3), dict(temperature=-1.0)),
                     ((ids, 3), dict(temperature=0.7))]:
        with pytest.raises(ValueError):
            m.generate(p, *args, **kw)
    assert m.generate(p, ids, 0) is ids
    draws = [m.generate(p, ids, 5, temperature=0.7, use_cache=True,
                        rng=prng.PRNGKey(seed)) for seed in (11, 11, 12)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (2, 11)
    assert not torch.equal(draws[0], draws[2])
    assert torch.equal(draws[0][:, :6], ids)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("use_cache", [True, False])
def test_sampled_generate_matches_jax_token_for_token(pairs, use_cache, seed):
    """At temperature 0.7 the port splits the key where the JAX package
    does and draws with the same categorical: the same tokens on both
    decode paths, from the same seed and converted params."""
    pair = pairs["stacked"]
    prompt = _ids(8, (3, 4))
    want = np.asarray(pair.jmodel.generate(
        pair.jparams, jnp.asarray(prompt), 12, temperature=0.7,
        rng=jax.random.PRNGKey(seed), use_cache=use_cache))
    got = pair.tmodel.generate(pair.tparams, torch.from_numpy(prompt), 12,
                               temperature=0.7, rng=prng.PRNGKey(seed),
                               use_cache=use_cache)
    greedy = np.asarray(pair.jmodel.generate(
        pair.jparams, jnp.asarray(prompt), 12, use_cache=use_cache))
    assert (want != greedy).any()  # the draws are not the argmax
    np.testing.assert_array_equal(got.numpy(), want)
