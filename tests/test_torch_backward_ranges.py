"""The train step's backward ranges by block (``utils/profiling.py``
``BackwardRanges``, ``models/transformer.py``): under ``torch.profiler``
the backward of the embedding, of each layer's attention and MoE and of
the loss runs inside ``dmoe/<block>/backward``, opened and closed by the
backward's own nodes.

A small ``DMoETransformerLM`` (2 layers of d 32, 4 experts, the chunked
CE over two chunks, f32) takes fused-Adafactor train steps on the CPU
under a profiler with CPU activity, with remat on and off and autograd's
device threads on and off.  Checked: each range once a step; each
backward node in the range of the block whose forward made it (by the
node's sequence number); no new range inside a forward or optimizer
range, and the forward ranges' ops unchanged by the new ones; no marker
node and bit-identical results without a profiler; no range left open
after ``torch.autograd.grad``."""

import re
from collections import Counter

import pytest
import torch

from learning_at_home_tpu_torch import random as prng
from learning_at_home_tpu_torch.models.transformer import (
    PROFILE_RANGE,
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map
from learning_at_home_tpu_torch.utils.profiling import UNMARKED
from perfbench.lib.trace import range_device_ms

BLOCKS = ["embed", "layer0/attention", "layer0/moe", "layer1/attention",
          "layer1/moe", "loss"]
BACKWARD = {PROFILE_RANGE + b + "/backward" for b in BLOCKS}
FORWARD_ONLY = re.compile(r"^dmoe/(layer\d+/(attention|moe)|optimizer)$")
MARKERS = {"_OpenRangeBackward", "_CloseRangeBackward"}
BATCH, STEPS = 4, 2
CASES = [pytest.param(remat, threads, id=f"remat{int(remat)}-threads{int(threads)}")
         for remat in (False, True) for threads in (False, True)]


def make_model(remat: bool) -> DMoETransformerLM:
    cfg = DMoETransformerConfig(
        vocab_size=256, d_model=32, n_layers=2, n_heads=2, seq_len=16,
        num_experts=4, k=2, ce_chunk=32, dtype=torch.float32, remat=remat,
        stack_layers=False, scan_layers=False)
    return DMoETransformerLM(cfg, device="cpu")


def batch(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 256, (BATCH, 17), generator=gen)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def profiled_steps(model, threads: bool, steps: int = STEPS, marked=True):
    """``steps`` train steps under the profiler; its events."""
    params = model.init_params(prng.PRNGKey(0))
    opt = fused_adafactor(1e-3)
    state = model.init_opt_state(opt, params)
    step = model.make_train_step(opt)
    ids, tgt = batch()
    if not marked:
        model._backward_ranges.marks = lambda: UNMARKED
    with torch.autograd.set_multithreading_enabled(threads):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                params, state, _, _ = step(params, state, ids, tgt)
    return prof.events()


def ops_below(evt):
    """The ops of a range down to the next nested program range, as the
    frozen ``range_device_ms`` walks them."""
    out, stack = [], list(evt.cpu_children)
    while stack:
        e = stack.pop()
        if e.name.startswith(PROFILE_RANGE):
            continue
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def ancestors(evt):
    while evt.cpu_parent is not None:
        evt = evt.cpu_parent
        yield evt


@pytest.mark.parametrize("remat,threads", CASES)
def test_each_backward_range_once_a_step(remat, threads):
    names = Counter(e.name for e in profiled_steps(make_model(remat), threads)
                    if e.name.startswith(PROFILE_RANGE))
    for name in BACKWARD | {PROFILE_RANGE + "embed"}:
        assert names[name] == STEPS, (name, names)
    assert not [n for n in names if n.endswith("/backward")
                and n not in BACKWARD | {PROFILE_RANGE + "backward"}]


@pytest.mark.parametrize("remat,threads", CASES)
def test_backward_nodes_fall_in_their_blocks_range(remat, threads):
    events = profiled_steps(make_model(remat), threads, steps=1)
    made_in = {}  # sequence number of a forward op -> its block
    for e in events:
        if (e.name.startswith(PROFILE_RANGE)
                and not e.name.endswith("backward")):
            for op in ops_below(e):
                if op.sequence_nr >= 0:
                    made_in.setdefault(op.sequence_nr, set()).add(
                        e.name[len(PROFILE_RANGE):])
    ran_in = {}  # sequence number of a backward node -> its range's block
    unowned = Counter()
    for e in events:
        if e.name not in BACKWARD:
            continue
        block = e.name[len(PROFILE_RANGE):-len("/backward")]
        for node in e.cpu_children:
            if (not node.name.startswith("autograd::engine::evaluate_function")
                    or "AccumulateGrad" in node.name):
                continue
            ran_in[node.sequence_nr] = block
            owner = made_in.get(node.sequence_nr)
            if owner is None:
                unowned[(block, node.name.split(": ")[-1])] += 1
            else:
                assert owner == {block}, (node.name, owner, block)
    # every backward node of a block's forward op ran in that block's range
    ran = {e.sequence_nr for e in events
           if e.name.startswith("autograd::engine::evaluate_function")}
    for seq, owner in made_in.items():
        if seq in ran:
            assert ran_in.get(seq) in owner, (seq, owner, ran_in.get(seq))
    # the one node of a block made outside its forward range: the MoE's
    # residual add
    assert unowned == Counter({("layer0/moe", "AddBackward0"): 1,
                               ("layer1/moe", "AddBackward0"): 1}), unowned
    for block in BLOCKS:
        assert block in ran_in.values(), block


@pytest.mark.parametrize("remat,threads", CASES)
def test_new_ranges_leave_the_forward_ranges_alone(remat, threads):
    marked = profiled_steps(make_model(remat), threads, steps=1)
    for e in marked:
        if e.name in BACKWARD:
            assert not [a.name for a in ancestors(e)
                        if FORWARD_ONLY.match(a.name)], e.name
    plain = profiled_steps(make_model(remat), threads, steps=1, marked=False)
    assert not [e.name for e in plain if e.name in BACKWARD]
    new = {"embed/backward", "layer*/attention/backward",
           "layer*/moe/backward", "loss/backward"}
    assert set(range_device_ms(marked, 1)) == set(
        range_device_ms(plain, 1)) | new

    def ops(events):
        out = {}
        for e in events:
            name = re.sub(r"layer\d+", "layer*",
                          e.name[len(PROFILE_RANGE):])
            if FORWARD_ONLY.match(e.name):
                out.setdefault(name, Counter()).update(
                    op.name for op in ops_below(e))
        return out

    assert ops(marked) == ops(plain)


def grads_of(model, params, ids, tgt):
    (loss, _), grads = model.value_and_grad(params, ids, tgt)
    return [loss, *tree_leaves(grads)]


def graph_nodes(root):
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(next_fn for next_fn, _ in node.next_functions)
    return {type(node).__name__ for node in seen}


@pytest.mark.parametrize("remat,threads", CASES)
def test_untraced_step_is_unmarked_and_identical(remat, threads):
    model = make_model(remat)
    params = model.init_params(prng.PRNGKey(0))
    ids, tgt = batch()
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss_fn(live, ids, tgt)
    assert not graph_nodes(loss.grad_fn) & MARKERS
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        loss, _ = model.loss_fn(live, ids, tgt)
        assert graph_nodes(loss.grad_fn) >= MARKERS
    with torch.autograd.set_multithreading_enabled(threads):
        plain = grads_of(model, params, ids, tgt)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            traced = grads_of(model, params, ids, tgt)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


class _Boom(torch.autograd.Function):
    """Identity whose backward fails: a backward aborted midway."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("aborted backward")


@pytest.mark.parametrize("threads", [False, True],
                         ids=["threads0", "threads1"])
@pytest.mark.parametrize("case", ["frozen_embeddings", "aborted"])
def test_no_range_outlives_the_backward(case, threads, monkeypatch):
    model = make_model(remat=False)
    params = model.init_params(prng.PRNGKey(0))
    ids, tgt = batch()
    ranges = model._backward_ranges
    with torch.autograd.set_multithreading_enabled(threads), \
            torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if case == "frozen_embeddings":
            # layer 0's input needs no gradient: its attention block's
            # closing node never runs
            live = {k: (v if k in ("embed", "pos") else tree_map(
                lambda t: t.detach().requires_grad_(True), v))
                    for k, v in params.items()}
            loss, _ = model.loss_fn(live, ids, tgt)
            torch.autograd.grad(loss, tree_leaves(
                {k: v for k, v in live.items() if k not in ("embed", "pos")}))
            assert ranges.open_names() == []
        else:
            moe = model._moe

            def failing(p, h, layer_idx, *args, **kw):
                y, aux = moe(p, h, layer_idx, *args, **kw)
                return (_Boom.apply(y) if layer_idx == 1 else y), aux

            monkeypatch.setattr(model, "_moe", failing)
            with pytest.raises(RuntimeError, match="aborted backward"):
                model.value_and_grad(params, ids, tgt)
            assert ranges.open_names() == [PROFILE_RANGE + "layer1/moe"]
            monkeypatch.setattr(model, "_moe", moe)
            model.value_and_grad(params, ids, tgt)
            assert ranges.open_names() == []
    names = Counter(e.name for e in prof.events() if e.name in BACKWARD)
    if case == "frozen_embeddings":
        assert names == Counter(BACKWARD - {"dmoe/embed/backward"})
    else:
        assert names[PROFILE_RANGE + "layer1/moe/backward"] == 2
        assert all(e.time_range.end > e.time_range.start
                   for e in prof.events() if e.name in BACKWARD)
