"""The port's decentralized averaging (``averaging/``) against the JAX
package's: the flatten order of the port's trees is ``jax.tree.flatten``'s
on converted swarm params; partition bounds and the weighted mean are
bitwise JAX's; a MIXED group (JAX and port averagers matched through one
DHT of JAX and port nodes) ends bitwise-equal, and equal to two JAX peers
on the same inputs; the mirrors of ``tests/test_averaging.py``'s death,
late-joiner, timeout, quantized-wire and session cases run in mixed
groups; a torch ``PipelinedSwarmTrainer`` averages with a JAX one.  Real
averager peers on their own loops and TCP endpoints, tiny trees; every
wait is bounded."""

from __future__ import annotations

import collections
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_at_home_tpu import averaging as javg
from learning_at_home_tpu.averaging import partitioning as jpart
from learning_at_home_tpu.client.routing import StaticExpertSource as JaxSrc
from learning_at_home_tpu.client.trainer import (
    PipelinedSwarmTrainer as JaxTrainer,
)
from learning_at_home_tpu.dht import DHT as JaxDHT
from learning_at_home_tpu.models.transformer_swarm import (
    SwarmDMoETransformerLM as JaxSwarmLM,
    SwarmTransformerConfig as JaxSwarmConfig,
)
from learning_at_home_tpu.server.chaos import ChaosConfig as JaxChaos
from learning_at_home_tpu_torch import averaging as tavg
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch.averaging import partitioning as tpart
from learning_at_home_tpu_torch.client import PipelinedSwarmTrainer
from learning_at_home_tpu_torch.convert import swarm_params_from_jax
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.models.transformer_swarm import (
    SwarmTransformerConfig,
)
from learning_at_home_tpu_torch.server.chaos import ChaosConfig
from learning_at_home_tpu_torch.tree import jax_tree_leaves


# ---- the pure helpers ----


def test_flatten_order_equals_jax_on_converted_swarm_params():
    kw = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=4, seq_len=8,
              grid_size=(3,), k_best=2, uid_prefix="fo")
    jparams = JaxSwarmLM(JaxSwarmConfig(**kw), JaxSrc({})).init_params(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = swarm_params_from_jax(np_params, SwarmTransformerConfig(**kw),
                                    device="cpu")
    jvec, _, jspecs = jpart.flatten_tree(jparams)
    tvec, treedef, tspecs = tpart.flatten_tree(tparams)
    np.testing.assert_array_equal(tvec.view(np.uint32), jvec.view(np.uint32))
    assert [s[0] for s in tspecs] == [tuple(s[0]) for s in jspecs]
    back = tpart.unflatten_tree(tvec, treedef, tspecs)
    for a, b in zip(jax_tree_leaves(tparams), jax_tree_leaves(back)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


Pair = collections.namedtuple("Pair", ["second", "first"])


def test_flatten_roundtrip_mixed_dtypes_as_jax():
    """Sorted dict keys, list order, named-tuple fields, None subtrees;
    bf16 widened exactly and rounded once back, as JAX's astype."""
    rs = np.random.RandomState(0)
    arrs = {"w": rs.randn(2, 3).astype(np.float32),
            "b": rs.randn(4).astype(np.float32),
            "n0": np.float32(3.5), "n1": rs.randn(2, 2).astype(np.float32),
            "p": rs.randn(3).astype(np.float32)}
    jtree = {"w": jnp.asarray(arrs["w"]),
             "b": jnp.asarray(arrs["b"]).astype(jnp.bfloat16),
             "nested": [jnp.asarray(arrs["n0"]), jnp.asarray(arrs["n1"])],
             "pair": Pair(second=None, first=jnp.asarray(arrs["p"]))}
    ttree = {"w": torch.from_numpy(arrs["w"]),
             "b": torch.from_numpy(arrs["b"]).to(torch.bfloat16),
             "nested": [torch.tensor(arrs["n0"]), torch.from_numpy(arrs["n1"])],
             "pair": Pair(second=None, first=torch.from_numpy(arrs["p"]))}
    jvec = jpart.flatten_tree(jtree)[0]
    tvec, treedef, specs = tpart.flatten_tree(ttree)
    np.testing.assert_array_equal(tvec, jvec)
    # a reduced vector off the bf16 grid comes back rounded as JAX rounds
    shifted = (jvec * np.float32(1.37)).astype(np.float32)
    jback = jpart.unflatten_tree(shifted, *jpart.flatten_tree(jtree)[1:])
    tback = tpart.unflatten_tree(shifted, treedef, specs)
    assert isinstance(tback["pair"], Pair) and tback["pair"].second is None
    for a, b in zip(jax.tree.leaves(jback), jax_tree_leaves(tback)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    assert tback["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("n,parts", [(10, 4), (2, 4), (0, 3), (1000, 7),
                                     (12345, 16)])
def test_bounds_and_chunks_are_jaxs(n, parts):
    assert tpart.partition_bounds(n, parts) == jpart.partition_bounds(n, parts)
    for chunk in (1, 7, 1 << 16):
        assert tpart.chunk_ranges(n, chunk) == jpart.chunk_ranges(n, chunk)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (1.0, 3.0, 0.5)])
def test_weighted_mean_is_jaxs_bitwise(weights):
    rs = np.random.RandomState(1)
    parts = [(f"p{i}", w, rs.randn(101).astype(np.float32))
             for i, w in enumerate(weights)]
    np.testing.assert_array_equal(
        tpart.weighted_mean(parts[::-1]).view(np.uint32),
        jpart.weighted_mean(parts).view(np.uint32))


# ---- groups over the real stack: one DHT of JAX and port nodes ----


@pytest.fixture
def dhts():
    """(JAX DHT node, port DHT node) of one swarm."""
    boot = DHT()
    jnode = JaxDHT(initial_peers=[boot.endpoint])
    tnode = DHT(initial_peers=[boot.endpoint])
    yield jnode, tnode
    for node in (jnode, tnode, boot):
        node.shutdown()


def _arrays(seed: int, d: int = 17) -> dict:
    rs = np.random.RandomState(seed)
    return {"embed": rs.randn(3, d).astype(np.float32),
            "gate": {"w": rs.randn(d).astype(np.float32)}}


def _tree(kind: str, seed: int, d: int = 17):
    a = _arrays(seed, d)
    to = jnp.asarray if kind == "jax" else torch.from_numpy
    return {"embed": to(a["embed"]), "gate": {"w": to(a["gate"]["w"])}}


def _vec(tree) -> np.ndarray:
    """The tree's f32 vector in jax.tree.flatten's order (either kind)."""
    return np.concatenate([np.asarray(leaf, np.float32).ravel()
                           for leaf in jax_tree_leaves(tree)])


def _spawn(dhts, kinds, cfg_kw, peer_ids=None, chaos=None):
    out = []
    for i, kind in enumerate(kinds):
        mod, node = (javg, dhts[0]) if kind == "jax" else (tavg, dhts[1])
        out.append(mod.DecentralizedAverager(
            node, config=mod.AveragingConfig(**cfg_kw),
            peer_id=peer_ids[i] if peer_ids else f"peer{i:02d}",
            chaos=chaos[i] if chaos else None))
    return out


def _run_rounds(averagers, trees, matchmaking_timeout=20.0):
    results, errors = [None] * len(averagers), []

    def run(i):
        try:
            results[i] = averagers[i].step_round(
                trees[i], matchmaking_timeout=matchmaking_timeout)
        except BaseException as e:
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(averagers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "averaging round hung"
    return results, errors


def _shutdown(avgs):
    for av in avgs:
        av.shutdown()


@pytest.mark.parametrize("kinds", [("jax", "torch"), ("torch", "jax"),
                                   ("torch", "torch")])
def test_mixed_group_bitwise_equal_and_equal_to_two_jax_peers(dhts, kinds):
    cfg = dict(min_group_size=2, max_group_size=2, part_timeout=3.0,
               chunk_elems=7)
    avgs = _spawn(dhts, kinds, cfg)
    try:
        results, errors = _run_rounds(
            avgs, [_tree(k, i) for i, k in enumerate(kinds)])
        assert not errors, errors
        assert results[0][1]["gid"] == results[1][1]["gid"]
        assert not any(r[1]["degraded"] for r in results)
        got = [_vec(r[0]) for r in results]
        np.testing.assert_array_equal(got[0].view(np.uint32),
                                      got[1].view(np.uint32))
        for r, k in zip(results, kinds):
            leaf = r[0]["embed"]
            assert isinstance(leaf, torch.Tensor) == (k == "torch")
    finally:
        _shutdown(avgs)
    jax_pair = _spawn(dhts, ("jax", "jax"), cfg)
    try:
        ref, errors = _run_rounds(jax_pair, [_tree("jax", i)
                                             for i in range(2)])
        assert not errors, errors
        np.testing.assert_array_equal(got[0].view(np.uint32),
                                      _vec(ref[0][0]).view(np.uint32))
    finally:
        _shutdown(jax_pair)


def test_four_peer_mixed_butterfly_parity_with_local_mean(dhts):
    kinds = ("torch", "jax", "torch", "jax")
    avgs = _spawn(dhts, kinds, dict(min_group_size=4, max_group_size=4,
                                    part_timeout=5.0, chunk_elems=7))
    try:
        results, errors = _run_rounds(
            avgs, [_tree(k, i) for i, k in enumerate(kinds)])
        assert not errors, errors
        want = sum(_vec(_tree("jax", i)) for i in range(4)) / np.float32(4)
        for tree, info in results:
            assert not info["degraded"] and info["group_size"] == 4
            np.testing.assert_array_equal(_vec(tree), want)
    finally:
        _shutdown(avgs)


def test_member_death_mid_round_degrades_not_hangs(dhts):
    """A port peer dies after matchmaking in a mixed group of 3: the
    survivors finish degraded (re-weighted over themselves) and keep the
    dead member's partition local."""
    kinds = ("jax", "torch", "torch")
    avgs = _spawn(dhts, kinds, dict(min_group_size=3, max_group_size=3,
                                    part_timeout=1.5))
    avgs[2].debug_die_after_match = True
    trees = [_tree(k, i) for i, k in enumerate(kinds)]
    try:
        results, errors = _run_rounds(avgs, trees)
        assert not errors, errors
        (ta, ia), (tb, ib), (tc, ic) = results
        assert tc is None and ic.get("died_after_match")
        assert ia["degraded"] and ib["degraded"]
        assert avgs[1].stats()["degraded_rounds"] == 1
        vecs = [_vec(t) for t in trees]
        bounds = tpart.partition_bounds(vecs[0].size, 3)
        for lo, hi in bounds[:2]:
            want = (vecs[0][lo:hi] + vecs[1][lo:hi]) / np.float32(2.0)
            np.testing.assert_array_equal(_vec(ta)[lo:hi], want)
            np.testing.assert_array_equal(_vec(tb)[lo:hi], want)
        lo, hi = bounds[2]
        np.testing.assert_array_equal(_vec(tb)[lo:hi], vecs[1][lo:hi])
        assert 2 in ib["failed_parts"]
    finally:
        _shutdown(avgs)


def test_late_joiner_waits_for_next_epoch(dhts):
    """A port peer knocking while a JAX leader's round runs is told to
    wait, and joins the next epoch."""
    slow = JaxChaos(averaging_base_latency=1.5, seed=0).make()
    cfg = dict(min_group_size=2, max_group_size=3, part_timeout=6.0,
               gather_timeout=4.0)
    a, b = _spawn(dhts, ("jax", "jax"), cfg, peer_ids=["aa", "bb"],
                  chaos=[None, slow])
    late = _spawn(dhts, ("torch",), cfg, peer_ids=["cc"])[0]
    trees = [_tree("jax", 0), _tree("jax", 1)]
    try:
        round1 = {}

        def first(av, key, tree):
            round1[key] = av.step_round(tree, matchmaking_timeout=20.0)

        ts = [threading.Thread(target=first, args=(a, "a", trees[0]),
                               daemon=True),
              threading.Thread(target=first, args=(b, "b", trees[1]),
                               daemon=True)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 15
        while not a._round_active and time.monotonic() < deadline:
            time.sleep(0.02)
        assert a._round_active, "round 1 never became active"
        late_result = {}
        tl = threading.Thread(target=lambda: late_result.__setitem__(
            "r", late.step_round(_tree("torch", 2),
                                 matchmaking_timeout=40.0)), daemon=True)
        tl.start()
        for t in ts:
            t.join(timeout=45)
            assert not t.is_alive()
        epoch1 = round1["a"][1]["epoch"]
        assert round1["a"][1]["members"] == ["aa", "bb"]
        _, errors = _run_rounds([a, b], trees, matchmaking_timeout=30.0)
        assert not errors, errors
        tl.join(timeout=60)
        assert not tl.is_alive() and "r" in late_result
        _, late_info = late_result["r"]
        assert late_info["epoch"] > epoch1 and "cc" in late_info["members"]
        assert late.stats()["late_join_waits"] >= 1
    finally:
        _shutdown([a, b, late])


def test_chaos_dropped_frames_trigger_timeout_path(dhts):
    """The port peer's handler drops every avg_part reply: the JAX
    peer's sends time out and its round ends degraded, never hung."""
    chaos = ChaosConfig(averaging_drop_prob=1.0, seed=0).make()
    a, b = _spawn(dhts, ("jax", "torch"),
                  dict(min_group_size=2, max_group_size=2, part_timeout=1.0,
                       sender_timeout=2.0, round_timeout=6.0),
                  chaos=[None, chaos])
    try:
        results, errors = _run_rounds([a, b], [_tree("jax", 0),
                                               _tree("torch", 1)])
        assert not errors, errors
        info_a = results[0][1]
        assert info_a["degraded"] and 1 in info_a["failed_parts"]
        assert chaos.injected_averaging_drops >= 1
    finally:
        _shutdown([a, b])


def test_quantized_wire_keeps_mixed_members_bitwise_identical(dhts):
    kinds = ("torch", "jax", "torch")
    avgs = _spawn(dhts, kinds, dict(min_group_size=3, max_group_size=3,
                                    part_timeout=3.0, chunk_elems=1 << 10,
                                    wire_codec="blockq8"))
    try:
        results, errors = _run_rounds(
            avgs, [_tree(k, i, d=997) for i, k in enumerate(kinds)])
        assert not errors, errors
        vecs = [_vec(r[0]) for r in results]
        for v in vecs[1:]:
            np.testing.assert_array_equal(v.view(np.uint32),
                                          vecs[0].view(np.uint32))
        exact = sum(_vec(_tree("jax", i, d=997)) for i in range(3)) / 3
        assert float(np.abs(vecs[0] - exact).max()) < 0.1
        assert all(av.stats()["quantized_chunks"] > 0 for av in avgs)
    finally:
        _shutdown(avgs)


def test_matchmaking_times_out_alone(dhts):
    av = _spawn(dhts, ("torch",), dict(min_group_size=2, poll=0.1))[0]
    try:
        with pytest.raises(tavg.AveragingFailed):
            av.step_round(_tree("torch", 0), matchmaking_timeout=1.5)
        assert av.stats()["matchmaking_failures"] == 1
    finally:
        av.shutdown()


# ---- sessions and trainers ----


def test_session_background_delta_apply_and_blocking_round(dhts):
    """Background mode: notify_step kicks a round off-thread and the
    group delta is applied on the trainer's tree (no local steps meanwhile:
    the group mean); blocking mode returns the mean, and a lone failed
    round is counted, not raised."""
    cfg = dict(min_group_size=2, max_group_size=2, part_timeout=3.0)
    a, b = _spawn(dhts, ("torch", "jax"), cfg)
    sa, sb = tavg.AveragingSession(a, every_steps=1), \
        javg.AveragingSession(b, every_steps=1)
    params = [_tree("torch", 0), _tree("jax", 1)]
    want = (_vec(params[0]) + _vec(params[1])) / np.float32(2)
    locks = [threading.Lock(), threading.Lock()]

    def wire(i, session):
        def snapshot():
            with locks[i]:
                return params[i]

        def apply_fn(transform):
            with locks[i]:
                params[i] = transform(params[i])

        session.attach_trainer(snapshot, apply_fn)

    try:
        wire(0, sa)
        wire(1, sb)
        sa.notify_step(1)
        sb.notify_step(1)
        deadline = time.monotonic() + 45
        while not (sa.rounds_applied and sb.rounds_applied) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert sa.rounds_applied == 1 and sb.rounds_applied == 1
        assert isinstance(params[0]["embed"], torch.Tensor)
        np.testing.assert_allclose(_vec(params[0]), want, atol=1e-6)
        np.testing.assert_allclose(_vec(params[1]), want, atol=1e-6)
        out = [None, None]
        ts = [threading.Thread(target=lambda i, s: out.__setitem__(
            i, s.blocking_round(params[i], matchmaking_timeout=20.0)),
            args=(i, s), daemon=True) for i, s in enumerate((sa, sb))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        np.testing.assert_array_equal(_vec(out[0]), _vec(out[1]))
        stats = sa.averaging_stats()
        assert stats["rounds"] == 2 and stats["rounds_applied"] == 2
        assert stats["group_size_last"] == 2
        lone = sa.blocking_round(params[0], matchmaking_timeout=0.5)
        assert lone is params[0]
        assert sa.averaging_stats()["rounds_skipped"] == 1
    finally:
        sa.shutdown()
        sb.shutdown()


class _TorchLinear:
    """A stand-in model (the trainer needs only ``loss_fn``)."""

    @staticmethod
    def loss_fn(params, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        return ((x @ params["w"] + params["b"] - y) ** 2).mean()


class _JaxLinear:
    @staticmethod
    def loss_fn(params, x, y):
        return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def test_torch_trainer_averages_with_a_jax_trainer(dhts):
    """PipelinedSwarmTrainer.attach_averaging in both packages: the
    background rounds run and apply, averaging_stats shows the group of
    2, and a final blocking round leaves both trainers bitwise-equal."""
    rs = np.random.RandomState(0)
    w0, b0 = rs.randn(8, 2).astype(np.float32), np.zeros(2, np.float32)
    cfg = dict(min_group_size=2, max_group_size=2, part_timeout=3.0)
    ta, ja = _spawn(dhts, ("torch", "jax"), cfg)
    ts, js = tavg.AveragingSession(ta, every_steps=2), \
        javg.AveragingSession(ja, every_steps=2)
    tt = PipelinedSwarmTrainer(
        _TorchLinear, optim.sgd(0.05),
        {"w": torch.from_numpy(w0.copy()), "b": torch.from_numpy(b0.copy())},
        n_workers=1)
    jt = JaxTrainer(_JaxLinear, optax.sgd(0.05),
                    {"w": jnp.asarray(w0), "b": jnp.asarray(b0)},
                    n_workers=1)
    tt.attach_averaging(ts)
    jt.attach_averaging(js)

    def batches(seed):
        r = np.random.RandomState(seed)
        while True:
            x = r.randn(4, 8).astype(np.float32)
            yield x, (x[:, :2] * 0.5).astype(np.float32)

    try:
        runs = [threading.Thread(target=tr.train, args=(batches(s), 4),
                                 daemon=True)
                for s, tr in ((1, tt), (2, jt))]
        for t in runs:
            t.start()
        for t in runs:
            t.join(timeout=60)
            assert not t.is_alive()
        assert ts.wait_idle(30.0) and js.wait_idle(30.0)
        stats = tt.averaging_stats()
        assert stats["rounds_applied"] + stats["rounds_skipped"] >= 1
        finals = [None, None]
        fs = [threading.Thread(target=lambda i, s, tr: finals.__setitem__(
            i, s.blocking_round(tr.snapshot()[0], matchmaking_timeout=20.0)),
            args=(i, s, tr), daemon=True)
            for i, (s, tr) in enumerate(((ts, tt), (js, jt)))]
        for t in fs:
            t.start()
        for t in fs:
            t.join(timeout=60)
            assert not t.is_alive()
        np.testing.assert_array_equal(_vec_wb(finals[0]), _vec_wb(finals[1]))
        assert tt.averaging_stats()["group_size_last"] == 2
        assert jt.averaging_stats()["group_size_last"] == 2
    finally:
        ts.shutdown()
        js.shutdown()


def _vec_wb(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k], np.float32).ravel()
                           for k in ("b", "w")])
