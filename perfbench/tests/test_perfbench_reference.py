"""The plain reference agrees with the port at a tiny size on the CPU, in
f32 compute: the loss and every leaf's gradient, and one Adafactor step."""

import pytest
import torch

from conftest import tiny_train
from perfbench.lib import weights
from perfbench.lib.train import token_pool
from perfbench.reference import adafactor
from perfbench.reference.dmoe import Model

SEED = 2**31 + 11


def test_loss_and_gradients_match_the_port():
    cell = tiny_train(param_dtype="float32", ce_impl="chunked")
    cfg, family = cell.config, cell.family
    model = family.build(cfg, cell.traffic, "cpu")
    params = weights.make_params(family, cfg, SEED, torch.float32, "cpu")
    pool = token_pool(cfg, 1, 8, cfg["seq_len"] + 1, SEED, "cpu")[0]
    ids, tgt = pool[:, :-1].contiguous(), pool[:, 1:].contiguous()
    (loss, _), grads = model.value_and_grad(params, ids, tgt)

    specs = family.leaf_specs(cfg)
    live = [weights.get_leaf(params, p).clone().requires_grad_(True)
            for p, *_ in specs]
    tree = weights.tree_of(specs, live)
    ref_loss, ref_grads = Model(cfg).loss_and_grads(tree, live, ids, tgt)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    for (path, *_), g in zip(specs, ref_grads):
        mine = weights.get_leaf(grads, path)
        scale = max(float(g.norm()), 1e-6)
        assert float((mine - g).norm()) <= 1e-4 * scale, path


def test_one_adafactor_step_matches_the_port():
    from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
    gen = torch.Generator().manual_seed(5)
    shapes = [(256, 128), (8, 128, 512), (128,), (4, 3)]
    ps = [torch.randn(s, generator=gen) * 0.05 for s in shapes]
    gs = [torch.randn(s, generator=gen) * 1e-3 for s in shapes]
    opt = fused_adafactor(1e-3)
    tree = {str(i): p.clone() for i, p in enumerate(ps)}
    state = opt.init(tree)
    for step in range(3):
        grads = {str(i): g * (step + 1) for i, g in enumerate(gs)}
        tree, state = opt.apply_fused(tree, grads, state)
    mine = [p.clone() for p in ps]
    states = [adafactor.init(p) for p in mine]
    for step in range(3):
        for p, g, s in zip(mine, gs, states):
            adafactor.step(p, g * (step + 1), s, step, 1e-3)
    for i, p in enumerate(mine):
        assert torch.allclose(tree[str(i)], p, rtol=1e-5, atol=1e-7), shapes[i]


def test_stacked_and_tuple_layouts_hold_the_same_values():
    cell = tiny_train()
    cfg, family = cell.config, cell.family
    a = weights.make_params(family, cfg, 7, torch.bfloat16, "cpu")
    b = weights.make_params(family, cfg, 7, torch.bfloat16, "cpu", stacked=True)
    specs = family.leaf_specs(cfg)
    for index, (path, *_) in enumerate(specs):
        assert torch.equal(weights.get_leaf(a, path), weights.get_leaf(b, path))
        assert torch.equal(weights.get_leaf(a, path),
                           weights.draw_leaf(specs, index, 7, torch.bfloat16,
                                             "cpu"))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3, 2**55 - 1])
def test_leaf_seeds_never_meet(seed):
    got = [weights.leaf_seed(seed, i) for i in range(1000)]
    assert got[:250] == [(seed << 8) | i for i in range(250)]
    assert len(set(got)) == len(got)
    assert weights.input_seed(seed) not in got
    assert all(0 <= g < 2**64 for g in got)
    with pytest.raises(ValueError, match="outside"):
        weights.leaf_seed(seed, 2**16)


def test_a_tree_is_nested_by_its_paths():
    specs = [(("a",), (), "ones", 0.0), (("layers", 1, "b", "c"), (), "ones", 0.0),
             (("layers", 0, "b", "c"), (), "ones", 0.0), (("d", "e"), (), "ones", 0.0)]
    assert weights.tree_of(specs, [1, 2, 3, 4]) == {
        "a": 1, "layers": ({"b": {"c": 3}}, {"b": {"c": 2}}), "d": {"e": 4}}
    with pytest.raises(ValueError, match="not 0..n-1"):
        weights.tree_of(specs[1:2], [1])


@pytest.mark.parametrize("blocks", ["rows", "experts", "both"])
def test_blocks_leave_the_reference_unchanged(monkeypatch, blocks):
    from perfbench.reference import dmoe
    cell = tiny_train(param_dtype="float32")
    cfg, family = cell.config, cell.family
    params = weights.make_params(family, cfg, SEED, torch.float32, "cpu")
    pool = token_pool(cfg, 1, 8, cfg["seq_len"] + 1, SEED, "cpu")[0]
    ids, tgt = pool[:, :-1].contiguous(), pool[:, 1:].contiguous()

    def loss_and_grads():
        specs = family.leaf_specs(cfg)
        live = [weights.get_leaf(params, p).clone().requires_grad_(True)
                for p, *_ in specs]
        tree = weights.tree_of(specs, live)
        return Model(cfg).loss_and_grads(tree, live, ids, tgt)

    whole, whole_grads = loss_and_grads()
    if blocks != "experts":  # three rows a block: 8 rows in 3 blocks
        monkeypatch.setattr(dmoe, "TOKENS_PER_BLOCK", 3 * cfg["seq_len"])
    if blocks != "rows":  # one expert a block
        monkeypatch.setattr(dmoe, "HIDDEN_PER_BLOCK", 1)
    blocked, blocked_grads = loss_and_grads()
    assert blocked == pytest.approx(whole, rel=1e-6)
    for a, b in zip(blocked_grads, whole_grads):  # f32 sums in another order
        assert float((a - b).norm()) <= 1e-5 * max(float(b.norm()), 1e-12)
