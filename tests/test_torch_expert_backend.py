"""The port's ``ExpertBackend`` against the JAX package's, on converted
params and optimizer state: forward, backward (input gradients, f32 zeros
for integer inputs) and the optimizer step it applies, with optax's adam
and sgd, after 1 and 3 steps; plus its metadata and state surface.

Tolerances (f32; the packages sum in other orders, ~1e-6 relative):

- outputs and input gradients: ``atol = rtol = 2e-5``;
- sgd: params ``atol 1e-6, rtol 1e-5`` (one f32 product per step);
- adam: a step is ``lr * m̂ / (sqrt(v̂) + eps)``, ~``lr * sign(g)`` on the
  first; where |g| is near eps = 1e-8 the gradients' summation-order
  differences (~1e-7 of the expert's gradient scale) move that element's
  step by up to ~lr (the attention's key bias is such a leaf: its
  gradient is zero but for rounding, softmax being blind to a per-query
  constant).  So params are held at ``atol 1e-6, rtol 1e-5`` where every
  step's |g| ≥ 1e-4 of that step's largest gradient in the expert, and
  within ``2 * lr`` a step elsewhere; each moment (mu, nu) at ``1e-5`` of
  its largest value in the expert plus ``1e-4`` relative; the count
  exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_at_home_tpu.models.layers import make_expert as jax_make_expert
from learning_at_home_tpu.server.expert_backend import (
    ExpertBackend as JaxBackend,
)
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch.convert import expert_from_jax, expert_to_jax
from learning_at_home_tpu_torch.models.layers import make_expert, name_to_block
from learning_at_home_tpu_torch.server.expert_backend import ExpertBackend
from learning_at_home_tpu_torch.utils.nested import nested_flatten

H = 16
ROWS = 8
LR = 1e-3
TOL = dict(atol=2e-5, rtol=2e-5)
OPTIMIZERS = {
    "adam": (lambda: optax.adam(LR), lambda: optim.adam(LR)),
    "sgd": (lambda: optax.sgd(LR), lambda: optim.sgd(LR)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, opt):
    jopt, topt = OPTIMIZERS[opt]
    japply, jparams = jax_make_expert(name, H, jax.random.PRNGKey(2))
    n_in = 2 if name == "det_dropout" else 1
    jb = JaxBackend(name, japply, jparams, jopt(), n_inputs=n_in,
                    max_batch_size=64)
    tparams, tstate = expert_from_jax(_np(jb.params), _np(jb.opt_state),
                                      device="cpu")
    tapply, _ = make_expert(name, H, torch.Generator().manual_seed(0),
                            device="cpu")
    tb = ExpertBackend(name, tapply, tparams, topt(), opt_state=tstate,
                       n_inputs=n_in, max_batch_size=64, device="cpu")
    return jb, tb


def _inputs(name, rng):
    x = rng.standard_normal((ROWS, H)).astype(np.float32)
    if name == "det_dropout":
        return [x, rng.integers(0, 2 ** 31, size=ROWS).astype(np.int32)]
    return [x]


def _assert_params(tb, jb, grads, opt, what):
    """``grads``: each step's JAX param gradients (the adam mask)."""
    got, _ = expert_to_jax(tb.params)
    want = _np(jb.params)
    gl = [jax.tree_util.tree_leaves(g) for g in grads]
    scale = [max(float(np.abs(np.asarray(x)).max()) for x in step)
             for step in gl]
    for i, (g, w) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                   jax.tree_util.tree_leaves(want))):
        msg = f"{what} leaf {i}"
        if opt == "sgd":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5,
                                       err_msg=msg)
            continue
        big = np.ones(np.shape(w), bool)
        for step, top in zip(gl, scale):
            big &= np.abs(np.asarray(step[i])) >= 1e-4 * top
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=1e-5,
                                   err_msg=msg)
        np.testing.assert_allclose(g[~big], w[~big], rtol=0,
                                   atol=2 * LR * len(gl), err_msg=msg)


def _assert_state(tb, jb, what):
    _, got = expert_to_jax(tb.params, tb.opt_state)
    want = _np(jb.opt_state)
    assert [type(s).__name__ for s in got] == \
        [type(s).__name__ for s in want]
    assert jax.tree_util.tree_structure(tuple(got[0])) == \
        jax.tree_util.tree_structure(tuple(want[0]))
    if not want[0]:  # sgd: (EmptyState(), EmptyState())
        return
    np.testing.assert_array_equal(got[0].count, want[0].count)
    assert got[0].count.dtype == np.int32
    for field in ("mu", "nu"):
        gl = jax.tree_util.tree_leaves(getattr(got[0], field))
        wl = jax.tree_util.tree_leaves(getattr(want[0], field))
        top = max(float(np.abs(w).max()) for w in wl)
        for i, (g, w) in enumerate(zip(gl, wl)):
            assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
            np.testing.assert_allclose(g, w, atol=1e-5 * top, rtol=1e-4,
                                       err_msg=f"{what} {field} leaf {i}")


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("name", sorted(name_to_block))
def test_backward_steps_match_jax(name, opt):
    rng = np.random.default_rng(0)
    jb, tb = _pair(name, opt)
    assert jb.n_inputs == tb.n_inputs
    step_grads = []
    for step in range(1, 4):
        ins = _inputs(name, rng)
        gout = rng.standard_normal((ROWS, H)).astype(np.float32)
        # the JAX param gradients of this step (before its update)
        _, vjp = jax.vjp(lambda p: jb.apply_fn(p, *ins), jb.params)
        step_grads.append(vjp(jnp.asarray(gout))[0])
        jfwd = jb.forward(ins)
        tfwd = tb.forward(ins)
        np.testing.assert_allclose(tfwd[0].numpy(), np.asarray(jfwd[0]),
                                   **TOL)
        jg = jb.backward(ins, [gout])
        tg = tb.backward(ins, [gout])
        assert len(tg) == len(jg) == len(ins)
        np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), **TOL)
        if name == "det_dropout":  # the seed's grad: f32 zeros, both sides
            assert tg[1].dtype == torch.float32
            assert np.asarray(jg[1]).dtype == np.float32
            np.testing.assert_array_equal(tg[1].numpy(), np.asarray(jg[1]))
            assert not tg[1].any()
        assert tb.update_count == jb.update_count == step
        if step in (1, 3):
            _assert_params(tb, jb, step_grads, opt, f"{name}/{opt} step {step}")
            _assert_state(tb, jb, f"{name}/{opt} step {step}")


def test_optimizer_states_have_optax_structure():
    p = {"a": torch.zeros(3), "b": {"c": torch.ones(2, 2)}}
    jp = {"a": jnp.zeros(3), "b": {"c": jnp.ones((2, 2))}}
    adam_state = optim.adam(LR).init(p)
    jadam = optax.adam(LR).init(jp)
    assert [type(s).__name__ for s in adam_state] == \
        [type(s).__name__ for s in jadam]
    assert adam_state[0]._fields == jadam[0]._fields
    assert adam_state[0].count.dtype == torch.int32
    assert [type(s).__name__ for s in optim.sgd(LR).init(p)] == \
        [type(s).__name__ for s in optax.sgd(LR).init(jp)]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(opt):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    jopt, topt = OPTIMIZERS[opt][0](), OPTIMIZERS[opt][1]()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        jp = optax.apply_updates(jp, ju)
        optim.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       atol=1e-9, rtol=1e-5)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=1e-6)


def test_adam_state_round_trips_bitwise():
    """JAX → port → JAX: expert params and adam state bit for bit."""
    jb, tb = _pair("ffn", "adam")
    rng = np.random.default_rng(1)
    ins = _inputs("ffn", rng)
    jb.backward(ins, [rng.standard_normal((ROWS, H)).astype(np.float32)])
    params, state = _np(jb.params), _np(jb.opt_state)
    tparams, tstate = expert_from_jax(params, state, device="cpu")
    back_p, back_s = expert_to_jax(tparams, tstate)
    rebuilt = (optax.ScaleByAdamState(*back_s[0]), optax.EmptyState())
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((back_p, rebuilt))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sgd_state_round_trips():
    jb, _ = _pair("nop", "sgd")
    _, tstate = expert_from_jax(_np(jb.params), _np(jb.opt_state),
                                device="cpu")
    assert [type(s).__name__ for s in tstate] == ["EmptyState", "EmptyState"]
    _, back = expert_to_jax({}, tstate)
    assert back == (optim.EmptyState(), optim.EmptyState())


def test_metadata_matches_jax():
    jb, tb = _pair("det_dropout", "adam")
    rng = np.random.default_rng(4)
    ins = _inputs("det_dropout", rng)
    jb.forward(ins)
    tb.forward(ins)
    assert tb.output_schema == jb.output_schema
    assert tb.n_outputs == jb.n_outputs == 1
    jinfo, tinfo = jb.get_info(), tb.get_info()
    assert tinfo == jinfo


def test_warmup_records_buckets_and_schema():
    jb, tb = _pair("ffn", "sgd")
    sample = [np.zeros((1, H), np.float32)]
    jb.warmup(sample, buckets=[3, 10])
    tb.warmup(sample, buckets=[3, 10])
    assert tb.warm_buckets == jb.warm_buckets == frozenset({4, 16})
    assert tb.output_schema == jb.output_schema
    assert tb.update_count == 0


def test_state_dict_round_trip_and_replace_params():
    _, tb = _pair("swiglu", "adam")
    rng = np.random.default_rng(5)
    tb.backward(_inputs("swiglu", rng),
                [rng.standard_normal((ROWS, H)).astype(np.float32)])
    snap = tb.state_dict()
    assert snap["update_count"] == 1
    tmpl = tb.state_template()
    assert [a.shape for a in nested_flatten(tmpl["params"])] == \
        [a.shape for a in nested_flatten(snap["params"])]
    tb.backward(_inputs("swiglu", rng),
                [rng.standard_normal((ROWS, H)).astype(np.float32)])
    tb.load_state_dict(snap)
    assert tb.update_count == 1
    for a, b in zip(nested_flatten(tb.state_dict()), nested_flatten(snap)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    zeros = jax.tree_util.tree_map(np.zeros_like, snap["params"])
    tb.replace_params(zeros)
    assert all(not t.any() for t in nested_flatten(tb.params))
    assert int(tb.opt_state[0].count) == 1


def test_grad_mode_is_set_by_the_backend():
    """The Runtime's thread may run with grad disabled: backward still
    re-forwards with autograd, forward never records a graph."""
    _, tb = _pair("ffn", "sgd")
    rng = np.random.default_rng(6)
    ins = _inputs("ffn", rng)
    with torch.no_grad():
        g = tb.backward(ins, [np.ones((ROWS, H), np.float32)])
    assert g[0].abs().sum() > 0
    with torch.enable_grad():
        out = tb.forward(ins)
    assert out[0].grad_fn is None and not out[0].requires_grad


def test_backend_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    apply_fn, params = make_expert("nop", H, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExpertBackend("x", apply_fn, params, optim.sgd(LR))
