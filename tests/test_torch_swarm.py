"""Mixed swarms on the CPU: the port's server and client against the JAX
package's, over real loopback RPC, on converted weights.

Three servers of one swarm (4 ``ffn`` experts ``ms.0..3`` at hidden 16,
``sgd(0.05)``, the weights of the JAX server A) take one forward and
backward each:

- A (JAX) under a JAX client: the all-JAX reference;
- C (port) under a JAX client;
- B (JAX) under a port client;

and each pair must give A's outputs, input and gate gradients, and leave
its experts with A's updated weights.  Tolerances: f32 with other
summation orders on one side, ``atol = rtol = 2e-5`` (the JAX package's
own gradient bar); a JAX server driven by the port client computes
exactly what A computes, so its updated weights are held bit for bit
where the two clients' gradients agree bit for bit (RemoteExpert), else
at f32 tolerance.  The gate's top-2 choice is tie-free in the chosen
inputs (gap ≥ 1e-3 between the 2nd and 3rd logit), so torch's and XLA's
gate products pick the same experts.

Also here: the expert fuzz corpus (``tests/fuzz_corpus/expert.json``,
the JAX handler's hostile frames) replayed against a port server with
``tools/lah_fuzz.py``'s ``drive_case``/``probe``; the control ops the
port does not serve yet; the stats RPC; the bf16 wire; the k-of-n
quorum; the fire/join pair.  Every server and client loop is shut down
in a fixture; no assertion reads a wall clock.
"""

import contextlib
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_at_home_tpu.client import reset_client_rpc as jax_reset_client
from learning_at_home_tpu.client.expert import RemoteExpert as JaxRemoteExpert
from learning_at_home_tpu.client.moe import (
    RemoteMixtureOfExperts as JaxMoE,
)
from learning_at_home_tpu.client.routing import (
    StaticExpertSource as JaxSource,
)
from learning_at_home_tpu.server.server import (
    background_server as jax_background_server,
)
from learning_at_home_tpu_torch.client.expert import RemoteExpert
from learning_at_home_tpu_torch.client.moe import (
    MoEDispatchError,
    RemoteMixtureOfExperts,
)
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.client.rpc import (
    client_loop,
    pool_registry,
    reset_client_rpc,
)
from learning_at_home_tpu_torch.convert import expert_from_jax
from learning_at_home_tpu_torch.optim import sgd
from learning_at_home_tpu_torch.server.server import background_server
from learning_at_home_tpu_torch.utils import sanitizer as port_sanitizer

H = 16
N = 4
PREFIX = "ms"
UIDS = [f"{PREFIX}.{i}" for i in range(N)]
TOL = dict(atol=2e-5, rtol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_clients_and_port_sanitizer():
    """Both packages' client loops are torn down after every test, and the
    port's own concurrency sanitizer must record nothing (the conftest
    guard watches the JAX package's)."""
    before = port_sanitizer.violation_count()
    yield
    reset_client_rpc()
    jax_reset_client()
    new = port_sanitizer.violations()[before:]
    assert not new, f"port sanitizer violations: {new}"


def _jax_server(**kw):
    return jax_background_server(num_experts=N, hidden_dim=H,
                                 expert_prefix=PREFIX, seed=0, **kw)


@contextlib.contextmanager
def _port_server_like(jax_srv, **kw):
    """A port server holding the JAX server's experts' weights and state."""
    with background_server(num_experts=N, hidden_dim=H, expert_prefix=PREFIX,
                           device="cpu", **kw) as (ep, srv):
        for uid, jb in jax_srv.experts.items():
            state = jb.state_dict()
            params, opt_state = expert_from_jax(state["params"],
                                                state["opt_state"],
                                                device="cpu")
            srv.experts[uid].load_state_dict(
                {"params": params, "opt_state": opt_state, "update_count": 0})
        yield ep, srv


def _params(srv, uid):
    """An expert's params as numpy leaves (either package's backend)."""
    return [np.asarray(a) for a in
            jax.tree_util.tree_leaves(srv.experts[uid].state_dict()["params"])]


def _assert_same_experts(srv, ref, exact=False):
    for uid in UIDS:
        assert srv.experts[uid].update_count == ref.experts[uid].update_count
        for a, b in zip(_params(srv, uid), _params(ref, uid)):
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=uid)
            else:
                np.testing.assert_allclose(a, b, err_msg=uid, **TOL)


def _gate_and_x(seed=0, rows=12):
    """Gate weights and inputs whose top-2 choice has no near-tie."""
    rng = np.random.default_rng(seed)
    while True:
        gate = {"w0": (rng.standard_normal((H, N)) / np.sqrt(H))
                .astype(np.float32)}
        x = rng.standard_normal((rows, H)).astype(np.float32)
        logits = np.sort(x @ gate["w0"], axis=1)
        if (logits[:, -2] - logits[:, -3]).min() >= 1e-3:
            return gate, x


# ---- RemoteExpert, both ways ----

def _jax_expert_call(expert, x, cot):
    y, vjp = jax.vjp(expert, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(cot))
    return np.asarray(y), np.asarray(gx)


def _port_expert_call(expert, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = expert(xt)
    y.backward(torch.from_numpy(cot))
    return y.detach().numpy(), xt.grad.numpy()


def test_remote_expert_mixed_both_ways():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, H)).astype(np.float32)
    cot = rng.standard_normal((5, H)).astype(np.float32)
    with _jax_server() as (ep_a, srv_a), _jax_server() as (ep_b, srv_b):
        with _port_server_like(srv_a) as (ep_c, srv_c):
            y_ref, gx_ref = _jax_expert_call(JaxRemoteExpert("ms.1", ep_a),
                                             x, cot)
            # JAX client, port server
            y, gx = _jax_expert_call(JaxRemoteExpert("ms.1", ep_c), x, cot)
            np.testing.assert_allclose(y, y_ref, **TOL)
            np.testing.assert_allclose(gx, gx_ref, **TOL)
            _assert_same_experts(srv_c, srv_a)
            # port client, JAX server: the JAX server computes what A did
            y, gx = _port_expert_call(RemoteExpert("ms.1", ep_b), x, cot)
            np.testing.assert_array_equal(y, y_ref)
            np.testing.assert_array_equal(gx, gx_ref)
            _assert_same_experts(srv_b, srv_a, exact=True)


def test_port_client_against_port_server_with_integer_inputs():
    """det_dropout's int32 seed crosses the wire; it takes no gradient."""
    rng = np.random.default_rng(2)
    with background_server(num_experts=1, expert_cls="det_dropout",
                           hidden_dim=H, expert_prefix="dd",
                           device="cpu") as (ep, srv):
        expert = RemoteExpert("dd.0", ep)
        x = torch.from_numpy(rng.standard_normal((4, H)).astype(np.float32))
        x.requires_grad_(True)
        seed = torch.arange(4, dtype=torch.int32)
        y = expert(x, seed)
        y.sum().backward()
        assert y.shape == (4, H) and x.grad.shape == (4, H)
        assert srv.experts["dd.0"].update_count == 1
        # the JAX client against the same port server
        jy = JaxRemoteExpert("dd.0", ep)(jnp.asarray(x.detach().numpy()),
                                         jnp.asarray(seed.numpy()))
        assert np.asarray(jy).shape == (4, H)


# ---- RemoteMixtureOfExperts, both ways ----

def _jax_moe_call(ep, gate, x, cot, **kw):
    moe = JaxMoE(in_features=H, grid_size=(N,), uid_prefix=PREFIX,
                 source=JaxSource({u: ep for u in UIDS}), k_best=2, **kw)
    g = {k: jnp.asarray(v) for k, v in gate.items()}

    def loss(g, x):
        y = moe(x, g)
        return jnp.sum(y * jnp.asarray(cot)), y

    (_, y), (gg, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(g, jnp.asarray(x))
    return np.asarray(y), np.asarray(gx), np.asarray(gg["w0"]), moe


def _port_moe(ep, **kw):
    return RemoteMixtureOfExperts(
        in_features=H, grid_size=(N,), uid_prefix=PREFIX,
        source=StaticExpertSource({u: ep for u in UIDS}), k_best=2, **kw)


def _port_moe_call(moe, gate, x, cot):
    g = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in gate.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = moe(xt, g)
    (y * torch.from_numpy(cot)).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(), g["w0"].grad.numpy())


def test_moe_mixed_both_ways():
    gate, x = _gate_and_x()
    cot = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    with _jax_server() as (ep_a, srv_a), _jax_server() as (ep_b, srv_b):
        with _port_server_like(srv_a) as (ep_c, srv_c):
            y_ref, gx_ref, gg_ref, jmoe = _jax_moe_call(ep_a, gate, x, cot)
            ref_choice = jmoe.selection_log[-1]
            # JAX client, port server
            y, gx, gg, jmoe_c = _jax_moe_call(ep_c, gate, x, cot)
            assert jmoe_c.selection_log[-1] == ref_choice
            np.testing.assert_allclose(y, y_ref, **TOL)
            np.testing.assert_allclose(gx, gx_ref, **TOL)
            np.testing.assert_allclose(gg, gg_ref, **TOL)
            _assert_same_experts(srv_c, srv_a)
            # port client, JAX server
            moe = _port_moe(ep_b)
            y, gx, gg = _port_moe_call(moe, gate, x, cot)
            assert moe.selection_log[-1] == ref_choice
            np.testing.assert_allclose(y, y_ref, **TOL)
            np.testing.assert_allclose(gx, gx_ref, **TOL)
            np.testing.assert_allclose(gg, gg_ref, **TOL)
            _assert_same_experts(srv_b, srv_a)
            assert moe.backward_rpcs_sent == moe.backward_rpcs_ok == len(ref_choice)


def test_port_pair_matches_the_jax_pair():
    """Port client on a port server, against the all-JAX pair."""
    gate, x = _gate_and_x(seed=4)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    with _jax_server() as (ep_a, srv_a), _port_server_like(srv_a) as (
            ep_c, srv_c):
        y_ref, gx_ref, gg_ref, _ = _jax_moe_call(ep_a, gate, x, cot)
        y, gx, gg = _port_moe_call(_port_moe(ep_c), gate, x, cot)
        np.testing.assert_allclose(y, y_ref, **TOL)
        np.testing.assert_allclose(gx, gx_ref, **TOL)
        np.testing.assert_allclose(gg, gg_ref, **TOL)
        _assert_same_experts(srv_c, srv_a)


def test_unmerged_rpcs_and_no_grad_path():
    """``merge_rpcs=False`` (one RPC per expert) gives the merged path's
    values; a no-grad forward stores no session and updates nothing."""
    gate, x = _gate_and_x(seed=6)
    with background_server(num_experts=N, hidden_dim=H, expert_prefix=PREFIX,
                           device="cpu") as (ep, srv):
        g = {k: torch.from_numpy(v) for k, v in gate.items()}
        with torch.no_grad():
            merged = _port_moe(ep)(torch.from_numpy(x), g)
            moe = _port_moe(ep, merge_rpcs=False)
            single = moe(torch.from_numpy(x), g)
        assert torch.equal(merged, single)
        assert not moe._sessions
        assert all(b.update_count == 0 for b in srv.experts.values())


def test_fire_join_equals_call():
    """fire + join is __call__ in two halves: the same forward bit for
    bit, and on twin servers the same gradients and expert updates."""
    gate, x = _gate_and_x(seed=7)
    cot = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    with _jax_server() as (_, srv_a), _port_server_like(srv_a) as (
            ep1, srv1), _port_server_like(srv_a) as (ep2, srv2):
        y1, gx1, gg1 = _port_moe_call(_port_moe(ep1), gate, x, cot)
        moe = _port_moe(ep2)
        g = {k: torch.from_numpy(v.copy()).requires_grad_(True)
             for k, v in gate.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        token, handle, logits = moe.fire(xt, g)
        between = (xt * 2).sum()  # work between fire and join
        y2 = moe.join(token, handle, logits)
        ((y2 * torch.from_numpy(cot)).sum() + 0 * between).backward()
        np.testing.assert_array_equal(y2.detach().numpy(), y1)
        np.testing.assert_array_equal(xt.grad.numpy(), gx1)
        np.testing.assert_array_equal(g["w0"].grad.numpy(), gg1)
        _assert_same_experts(srv2, srv1, exact=True)
        assert moe.inflight_dispatches == 0
        assert not moe._pending and not moe._pending_bwd
        # discard cancels a fired, never-joined ticket
        with torch.no_grad():
            pending = moe.fire(xt, g)
        moe.discard(*pending)
        assert moe.inflight_dispatches == 0 and not moe._pending


def test_bf16_wire_within_bf16_tolerance():
    """``wire_dtype="bfloat16"``: activations and gradients cross the wire
    in bf16 both ways (8 mantissa bits, 2^-9 relative rounding on each
    crossing, compute in f32 on both ends); held to 2^-6 of each output's
    largest magnitude against the f32 wire on a twin server."""
    gate, x = _gate_and_x(seed=9)
    cot = np.random.default_rng(10).standard_normal(x.shape).astype(np.float32)
    with _jax_server() as (_, srv_a), _port_server_like(srv_a) as (
            ep1, _), _port_server_like(srv_a) as (ep2, _):
        ref = _port_moe_call(_port_moe(ep1), gate, x, cot)
        got = _port_moe_call(_port_moe(ep2, wire_dtype="bfloat16"),
                             gate, x, cot)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=2 ** -6 * np.abs(r).max())
            assert not np.array_equal(g, r)  # the wire really was bf16


def test_quorum_drops_samples_whose_experts_are_all_dead():
    """k_min=1 over a swarm whose experts 2 and 3 point at a closed port:
    a sample with one live choice survives, one with none is dropped to a
    zero output (no NaN) and counted."""
    gate, x = _gate_and_x(seed=11, rows=16)
    with background_server(num_experts=N, hidden_dim=H, expert_prefix=PREFIX,
                           device="cpu") as (ep, _):
        with background_server(num_experts=0, hidden_dim=H,
                               device="cpu") as (dead, _):
            pass  # bound, then closed: connections are refused
        table = {u: (ep if i < 2 else dead) for i, u in enumerate(UIDS)}
        moe = RemoteMixtureOfExperts(
            in_features=H, grid_size=(N,), uid_prefix=PREFIX,
            source=StaticExpertSource(table), k_best=2, k_min=1,
            forward_timeout=10.0)
        g = {k: torch.from_numpy(v) for k, v in gate.items()}
        top2 = np.argsort(-(x @ gate["w0"]), axis=1)[:, :2]
        all_dead = (top2 >= 2).all(axis=1)
        assert all_dead.any() and not all_dead.all()
        with torch.no_grad():
            y = moe(torch.from_numpy(x), g).numpy()
        assert np.isfinite(y).all()
        assert not y[all_dead].any()
        assert np.abs(y[~all_dead]).sum(axis=1).min() > 0
        assert moe.samples_dropped == int(all_dead.sum())
        # every choice dead: the whole dispatch fails loudly
        moe_dead = RemoteMixtureOfExperts(
            in_features=H, grid_size=(N,), uid_prefix=PREFIX,
            source=StaticExpertSource({u: dead for u in UIDS}), k_best=2)
        with pytest.raises(MoEDispatchError):
            with torch.no_grad():
                moe_dead(torch.from_numpy(x), g)


# ---- the server's RPC surface ----

def _rpc(ep, op, meta):
    pool = pool_registry().get(ep)
    return client_loop().run(pool.rpc(op, (), meta, timeout=10))


def test_stats_info_and_later_ops():
    with _jax_server() as (ep_a, _), background_server(
            num_experts=N, hidden_dim=H, expert_prefix=PREFIX, device="cpu",
            warmup=[8]) as (ep, srv):
        _, jstats = _rpc(ep_a, "stats", {})
        _, stats = _rpc(ep, "stats", {})
        assert set(stats) == set(jstats)
        assert stats["n_experts"] == N and stats["update_count_total"] == 0
        assert set(stats["runtime"]) == set(jstats["runtime"])
        _, info = _rpc(ep, "info", {"uid": "ms.2"})
        assert info["output_schema"] == [{"shape": [H], "dtype": "float32"}]
        assert info["num_params"] == sum(
            t.numel() for t in jax.tree_util.tree_leaves(
                srv.experts["ms.2"].params))
        # the elastic ops are served as the JAX package serves them
        _, rep = _rpc(ep, "replica", {"uid": "ms.0"})
        assert rep == {"uid": "ms.0", "installed": False, "hosted": True}
        with pytest.raises(Exception, match="session"):
            _rpc(ep, "handoff", {"uid": "ms.0"})
        with pytest.raises(Exception, match="target"):
            _rpc(ep, "migrate", {"uid": "ms.0"})
        with pytest.raises(Exception, match="successor"):
            _rpc(ep, "drain", {"successor": "nowhere"})
        assert srv.lifecycle_state == "SERVING"
        assert all(b.update_count == 0 for b in srv.experts.values())
        from learning_at_home_tpu_torch.utils.telemetry import fetch_json

        doc = fetch_json((srv.endpoint[0], srv.metrics_port))
        assert doc is not None and doc["experts"] == {
            u: 0 for u in UIDS}


def test_expert_fuzz_corpus_replays_clean():
    """The JAX handler's whole pinned expert corpus against a port server
    (it runs in well under a second here, so it stays in tier-1)."""
    from learning_at_home_tpu.analysis.fuzz import load_corpus

    cases = load_corpus(os.path.join(REPO, "tests", "fuzz_corpus",
                                     "expert.json"))
    outcomes = _replay(cases)
    # the JAX server's shape on this corpus: most frames rejected with an
    # error reply, the well-formed ones answered
    assert outcomes["reject"] > 50 and outcomes["result"] > 0


def _replay(cases):
    """``tools/lah_fuzz.py``'s expert contract against a port server: no
    hang, no success where a rejection is required, the server alive
    after every 50 frames and at the end."""
    lah_fuzz = importlib.import_module("tools.lah_fuzz")
    outcomes = {"reject": 0, "result": 0, "close": 0, "noreply": 0}
    failures = []
    with background_server(num_experts=2, hidden_dim=16, expert_prefix="fz",
                           seed=0, optimizer=sgd(0.0), device="cpu") as (
            ep, _):
        assert lah_fuzz.probe(ep, "stats", {})
        frames = 0
        for i, case in enumerate(cases):
            outcome = lah_fuzz.drive_case(ep, case)
            assert outcome != "connect_fail", case.name
            frames += 1
            outcomes[outcome] += 1
            if outcome == "noreply" or (case.expect == "reject"
                                        and outcome == "result"):
                failures.append((case.name, case.mutation, outcome))
            if (i + 1) % lah_fuzz.PROBE_EVERY == 0:
                assert lah_fuzz.probe(ep, "stats", {}), case.name
        assert lah_fuzz.probe(ep, "stats", {})
    assert failures == []
    assert frames == len(cases)
    assert outcomes["noreply"] == 0
    return outcomes
