"""The port's swarm DMoE-Transformer, data pipeline and pipelined trainer
against the JAX package's, on the CPU.

Twin swarms: a JAX server process and a port server host the same 6
``ffn`` experts (2 layers, grid (3,), hidden 16), crc32-seeded as the JAX
server seeds them (the port's loaded through ``expert_from_jax``), both
stepping them with ``sgd(0.0)`` so
the experts stay put while the trainers under test call them again and
again.  The JAX model's params (a JAX init) go to the port through
``swarm_params_from_jax``.  Held against JAX with ``atol = rtol = 2e-5``
(both sides f32, other summation orders): logits, loss, and every trunk
and gate gradient of ``apply`` and of ``apply_overlapped`` in both
schedules; two ``make_train_step`` steps with ``adamw`` under the
two-level AdamW tolerance of ``tests/test_torch_train_step.py``.  Bit for
bit: the port's serial and overlapped schedules, ``PipelinedSwarmTrainer``
with one worker against sequential steps, the data pipeline's batches.
The quorum waits for every reply (``timeout_after_k_min`` 60 s), so no
straggler drops a reply on one side only.

Mixed training through a DHT, both ways: a port trainer against a JAX
server process (``python -m learning_at_home_tpu.server``) and a JAX
trainer against a port server process (``python -m
learning_at_home_tpu_torch.server --device cpu``), each found through a
DHT of port and JAX nodes; the loss falls and the servers' update counts
lie between the backward RPCs acked and sent.
"""

import contextlib
import dataclasses
import itertools
import os
import subprocess
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_at_home_tpu.client import reset_client_rpc as jax_reset_client
from learning_at_home_tpu.client.expert import RemoteExpert as JaxRemoteExpert
from learning_at_home_tpu.client.routing import (
    StaticExpertSource as JaxSource,
)
from learning_at_home_tpu.dht import DHT as JaxDHT
from learning_at_home_tpu.models import data as jax_data
from learning_at_home_tpu.models.transformer_swarm import (
    SwarmDMoETransformerLM as JaxSwarmLM,
    SwarmTransformerConfig as JaxSwarmConfig,
)
from learning_at_home_tpu.utils.subproc import clean_jax_subprocess_env
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client import PipelinedSwarmTrainer
from learning_at_home_tpu_torch.client.expert import RemoteExpert
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.convert import (
    expert_from_jax,
    swarm_params_from_jax,
    swarm_params_to_jax,
)
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.models import data
from learning_at_home_tpu_torch.models.transformer_swarm import (
    SwarmDMoETransformerLM,
    SwarmTransformerConfig,
)
from learning_at_home_tpu_torch.server.server import background_server
from learning_at_home_tpu_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, VOCAB, SEQ, HEADS, LAYERS, GRID, BATCH = 16, 64, 8, 4, 2, (3,), 4
TOL = dict(atol=2e-5, rtol=2e-5)
TWIN = "tw"  # the twins' uid prefix: tw0.0 .. tw1.2


def _cfg_kw(prefix, **over):
    return dict(vocab_size=VOCAB, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                seq_len=SEQ, grid_size=GRID, k_best=2, uid_prefix=prefix,
                timeout_after_k_min=60.0, **over)


def _uids(prefix):
    return [f"{prefix}{layer}.{i}" for layer in range(LAYERS)
            for i in range(GRID[0])]


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
            rs.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32))


@pytest.fixture(autouse=True)
def _clean_clients():
    yield
    reset_client_rpc()
    jax_reset_client()


# the JAX twin server's start, its first reply included (a loaded host
# imports JAX and compiles for tens of seconds)
JAX_SERVER_START_S = 180.0


def _jax_server_process(uids):
    """A JAX expert server process hosting ``uids`` (crc32-seeded,
    ``sgd(0.0)``, no DHT), and its endpoint once it answers ``info``.
    A process of its own: a JAX server in the process of a JAX client
    whose backward waits in a host callback can be starved of the XLA
    runtime it shares with that client, and its replies then time out
    on a loaded host."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "learning_at_home_tpu.server",
         "--expert-uids", ",".join(uids), "--hidden-dim", str(D),
         "--host", "127.0.0.1", "--port", "0", "--no-dht",
         "--optimizer", "sgd", "--lr", "0.0", "--max-batch-size", "256"],
        env=clean_jax_subprocess_env(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []

    def pump():  # its output, read as it comes: a full pipe never blocks it
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + JAX_SERVER_START_S
    endpoint = None
    try:
        while True:
            if endpoint is None:
                for line in list(lines):
                    if line.startswith("serving "):
                        host, port = line.split(" on ")[1].split()[0].rsplit(
                            ":", 1)
                        endpoint = (host, int(port))
            if endpoint is not None:
                try:
                    JaxRemoteExpert(uids[0], endpoint).info()
                    break
                except Exception:
                    pass
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("the JAX server did not answer: "
                                     + "".join(lines)[-3000:])
            time.sleep(0.5)
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        raise
    return proc, endpoint


@pytest.fixture(scope="module")
def twins():
    """(JAX model, port model, JAX params, port params, port server).
    The JAX twin server is a process of its own (``_jax_server_process``);
    the port server, here, is loaded with the same crc32-seeded experts."""
    from learning_at_home_tpu.models import make_expert

    uids = _uids(TWIN)
    jproc, jep = _jax_server_process(uids)
    try:
        with background_server(
                num_experts=0, expert_uids=uids, hidden_dim=D,
                optimizer=optim.sgd(0.0), max_batch_size=256,
                device="cpu") as (tep, tsrv):
            for uid in uids:
                _, jax_params = make_expert(
                    "ffn", D,
                    jax.random.PRNGKey(zlib.crc32(uid.encode()) & 0x7FFFFFFF))
                params, _ = expert_from_jax(
                    jax.tree_util.tree_map(np.asarray, jax_params),
                    device="cpu")
                backend = tsrv.experts[uid]
                backend.load_state_dict({"params": params,
                                         "opt_state": backend.opt_state,
                                         "update_count": 0})
            jmodel = JaxSwarmLM(JaxSwarmConfig(**_cfg_kw(TWIN)),
                                JaxSource({u: jep for u in uids}))
            tcfg = SwarmTransformerConfig(**_cfg_kw(TWIN))
            tmodel = SwarmDMoETransformerLM(
                tcfg, StaticExpertSource({u: tep for u in uids}))
            jparams = jmodel.init_params(jax.random.PRNGKey(0))
            np_params = jax.tree_util.tree_map(np.asarray, jparams)
            tparams = swarm_params_from_jax(np_params, tcfg, device="cpu")
            yield jmodel, tmodel, jparams, tparams, tsrv
    finally:
        jproc.terminate()
        try:
            jproc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            jproc.kill()
            jproc.wait(timeout=30)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, want, what, **tol):
    flat_g, tdef_g = jax.tree_util.tree_flatten(got)
    flat_w, tdef_w = jax.tree_util.tree_flatten(want)
    assert tdef_g == tdef_w, what
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        if tol:
            np.testing.assert_allclose(g, w, err_msg=f"{what} leaf {i}", **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def _port_grads(tmodel, grads):
    return swarm_params_to_jax(grads, tmodel.cfg)


# ---- configuration, parameters, data ----


def test_config_fields_equal_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxSwarmConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(
        SwarmTransformerConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (name, jd), (_, td) in zip(jf, tf):
        if name == "dtype":
            assert jd == jnp.float32 and td == torch.float32
        else:
            assert jd == td, name


def test_swarm_params_round_trip_and_init_tree():
    jcfg = JaxSwarmConfig(**_cfg_kw("rt"))
    tcfg = SwarmTransformerConfig(**_cfg_kw("rt"))
    src = JaxSource({})
    jparams = _np(JaxSwarmLM(jcfg, src).init_params(jax.random.PRNGKey(3)))
    tparams = swarm_params_from_jax(jparams, tcfg, device="cpu")
    assert isinstance(tparams["layers"], list)
    _assert_tree_close(swarm_params_to_jax(tparams, tcfg), jparams, "round trip")
    # the port's own init has the JAX tree's structure and shapes
    tmodel = SwarmDMoETransformerLM(tcfg, StaticExpertSource({}))
    own = tmodel.init_params(jrandom.PRNGKey(0), device="cpu")
    own_np = swarm_params_to_jax(own, tcfg)  # checks every shape
    assert jax.tree_util.tree_structure(own_np) == \
        jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(own_np),
                    jax.tree_util.tree_leaves(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    bad = dict(jparams, pos=jparams["pos"][:, :-1])
    with pytest.raises(ValueError, match="pos"):
        swarm_params_from_jax(bad, tcfg, device="cpu")


def test_init_params_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = SwarmDMoETransformerLM(SwarmTransformerConfig(**_cfg_kw("nc")),
                                   StaticExpertSource({}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(jrandom.PRNGKey(0))


def test_data_equal_jax(tmp_path):
    assert (data.VOCAB_SIZE, data.BOS, data.EOS) == (
        jax_data.VOCAB_SIZE, jax_data.BOS, jax_data.EOS)
    np.testing.assert_array_equal(data.encode_bytes("héllo\n"),
                                  jax_data.encode_bytes("héllo\n"))
    for seed in (0, 3):
        a = data.synthetic_corpus(5000, seed)
        b = jax_data.synthetic_corpus(5000, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    text = tmp_path / "c.txt"
    text.write_bytes(b"some corpus text " * 20)
    toks = tmp_path / "c.npy"
    np.save(toks, np.arange(400, dtype=np.int64) % 258)
    for path in (None, str(text), str(toks)):
        np.testing.assert_array_equal(
            data.load_corpus(path, 3000, seed=1),
            jax_data.load_corpus(path, 3000, seed=1))
    corpus = data.synthetic_corpus(4000, 2)
    ours = data.LMBatcher(corpus, 3, 16, seed=5)
    theirs = jax_data.LMBatcher(corpus, 3, 16, seed=5)
    for _ in range(3):
        for a, b in zip(next(ours), next(theirs)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    ours.skip(4)
    theirs.skip(4)
    for a, b in zip(next(ours), next(theirs)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        data.LMBatcher(corpus[:10], 1, 16)


# ---- the model against the JAX package's, on twin swarms ----


def test_apply_matches_jax(twins):
    jmodel, tmodel, jparams, tparams, _ = twins
    ids, tgt = _batch(0)
    jlogits = np.asarray(jmodel.apply(jparams, jnp.asarray(ids)))
    with torch.no_grad():
        tlogits = tmodel.apply(tparams, ids)
    assert tlogits.shape == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **TOL)
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jparams, jnp.asarray(ids), jnp.asarray(tgt))
    tloss, tgrads = optim.value_and_grad(tmodel.loss_fn)(tparams, ids, tgt)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _assert_tree_close(_port_grads(tmodel, tgrads), _np(jgrads), "grad", **TOL)


def test_key_seeded_models_agree_unconverted(twins):
    """One key, two packages, no conversion: the port's ``init_params``
    of the JAX model's key gives the JAX model's logits (2e-5)."""
    jmodel, tmodel, jparams, _, _ = twins
    ids, _ = _batch(2)
    jlogits = np.asarray(jmodel.apply(jparams, jnp.asarray(ids)))
    own = tmodel.init_params(jrandom.PRNGKey(0), device="cpu")
    with torch.no_grad():
        tlogits = tmodel.apply(own, ids)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("overlap", [True, False])
def test_apply_overlapped_matches_jax(twins, overlap):
    jmodel, tmodel, jparams, tparams, _ = twins
    ids, tgt = _batch(1)
    jlogits = np.asarray(jmodel.apply_overlapped(jparams, jnp.asarray(ids),
                                                 overlap=overlap))
    with torch.no_grad():
        tlogits = tmodel.apply_overlapped(tparams, ids, overlap=overlap)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **TOL)

    def jloss_fn(p, i, t):
        return jmodel.loss_fn_overlapped(p, i, t, overlap=overlap)

    def tloss_fn(p, i, t):
        return tmodel.loss_fn_overlapped(p, i, t, overlap=overlap)

    jloss, jgrads = jax.value_and_grad(jloss_fn)(
        jparams, jnp.asarray(ids), jnp.asarray(tgt))
    tloss, tgrads = optim.value_and_grad(tloss_fn)(tparams, ids, tgt)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _assert_tree_close(_port_grads(tmodel, tgrads), _np(jgrads), "grad", **TOL)


def test_serial_and_overlapped_schedules_bitwise(twins):
    _, tmodel, _, tparams, _ = twins
    ids, tgt = _batch(2)
    out = {}
    for overlap in (True, False):
        def loss(p, i, t, overlap=overlap):
            return tmodel.loss_fn_overlapped(p, i, t, overlap=overlap)

        value, grads = optim.value_and_grad(loss)(tparams, ids, tgt)
        out[overlap] = [value] + tree_leaves(grads)
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


def _step_close(got, want, what):
    """Two AdamW steps: every element within 1e-6 + 1e-5 |ref| but a few
    (1e-4 of a leaf, at least 2) within 2e-4 — where |g| is near eps,
    f32 summation-order differences move that element's step by up to
    lr * 2e-9 / eps (``tests/test_torch_train_step.py``)."""
    flat_g, tdef_g = jax.tree_util.tree_flatten(got)
    flat_w, tdef_w = jax.tree_util.tree_flatten(want)
    assert tdef_g == tdef_w
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        off = np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)
        assert off.sum() <= max(1e-4 * off.size, 2), f"{what} {i}"
        np.testing.assert_allclose(g[off], w[off], atol=2e-4, rtol=0,
                                   err_msg=f"{what} {i}")


def test_two_adamw_train_steps_match_jax(twins):
    jmodel, tmodel, jparams, tparams, _ = twins
    jopt, topt = optax.adamw(1e-3), optim.adamw(1e-3)
    jstep, tstep = jmodel.make_train_step(jopt), tmodel.make_train_step(topt)
    jp, js = jparams, jopt.init(jparams)
    tp, ts = tparams, topt.init(tparams)
    for seed in (3, 4):
        ids, tgt = _batch(seed)
        jp, js, jloss = jstep(jp, js, jnp.asarray(ids), jnp.asarray(tgt))
        tp, ts, tloss = tstep(tp, ts, ids, tgt)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _step_close(swarm_params_to_jax(tp, tmodel.cfg), _np(jp), "param")
    assert int(ts.count) == int(js[0].count) == 2
    # the step built new trees: the params it was given are unchanged
    _assert_tree_close(swarm_params_to_jax(tparams, tmodel.cfg),
                       _np(jparams), "input params")


def test_pipelined_trainer_one_worker_equals_sequential_steps(twins):
    _, tmodel, _, tparams, _ = twins
    opt = optim.adamw(3e-3)
    batches = [_batch(10 + i) for i in range(3)]
    step = tmodel.make_train_step(opt)
    p, s, losses = tparams, opt.init(tparams), []
    for ids, tgt in batches:
        p, s, loss = step(p, s, ids, tgt)
        losses.append(float(loss))
    trainer = PipelinedSwarmTrainer(tmodel, opt, tparams, n_workers=1)
    summary = trainer.train(iter(batches), steps=3)
    assert summary["steps"] == trainer.step_count == 3
    assert trainer.losses == losses
    for a, b in zip(tree_leaves(trainer.params), tree_leaves(p)):
        assert torch.equal(a, b)
    params, state, n = trainer.snapshot()
    assert n == 3 and params is trainer.params
    for a, b in zip(tree_leaves(state), tree_leaves(s)):
        assert torch.equal(a, b)


def test_pipelined_trainer_two_workers_converge_and_count(twins):
    _, tmodel, _, tparams, tsrv = twins
    before = sum(b.update_count for b in tsrv.experts.values())
    sent0 = sum(m.backward_rpcs_sent for m in tmodel.moes)
    ok0 = sum(m.backward_rpcs_ok for m in tmodel.moes)
    trainer = PipelinedSwarmTrainer(tmodel, optim.adamw(3e-3), tparams,
                                    n_workers=2)
    logs = []
    summary = trainer.train(itertools.repeat(_batch(20)), steps=10,
                            log_every=5, on_log=logs.append,
                            tokens_per_batch=BATCH * SEQ)
    assert trainer.step_count == summary["steps"] == 10
    assert [e["step"] for e in logs] == [5, 10]
    assert summary["tokens_per_sec"] > 0
    assert np.isfinite(trainer.losses).all()
    assert np.mean(trainer.losses[-3:]) < trainer.losses[0]
    updates = sum(b.update_count for b in tsrv.experts.values()) - before
    sent = sum(m.backward_rpcs_sent for m in tmodel.moes) - sent0
    acked = sum(m.backward_rpcs_ok for m in tmodel.moes) - ok0
    # two workers' RPCs to one expert may share a batch: one update
    assert 0 < updates <= sent and acked <= sent
    # no AveragingSession attached: no averaging stats
    assert trainer.averaging_stats() is None


# ---- mixed training through a DHT, both ways ----


def _wait_alive(dht_get_alive, procs, prefixes, n_each, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for proc in procs:
            if proc.poll() is not None:
                raise AssertionError(
                    f"server died: {proc.stdout.read()[-3000:]}")
        found = {p: dht_get_alive(p) for p in prefixes}
        if all(len(v) == n_each for v in found.values()):
            return {u: ep for v in found.values() for u, ep in v.items()}
        time.sleep(0.25)
    raise AssertionError(f"experts never showed up: {found}")


@pytest.fixture(scope="module")
def mixed_swarm():
    """A port bootstrap DHT node, a JAX server process hosting ``mj*``
    and a port server process hosting ``mp*`` (adam 1e-3), both joined
    to it."""
    boot = DHT(cache_ttl=0.0)
    peer = f"{boot.endpoint[0]}:{boot.endpoint[1]}"
    env = clean_jax_subprocess_env(REPO)
    common = ["--hidden-dim", str(D), "--host", "127.0.0.1",
              "--initial-peers", peer, "--update-period", "5",
              "--optimizer", "adam", "--lr", "1e-3",
              "--max-batch-size", "256"]
    procs = []
    try:
        for module, prefix, extra in (
                ("learning_at_home_tpu.server", "mj", []),
                ("learning_at_home_tpu_torch.server", "mp",
                 ["--device", "cpu"])):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, "--expert-uids",
                 ",".join(_uids(prefix)), *common, *extra],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        yield boot, procs
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            with contextlib.suppress(Exception):
                proc.communicate(timeout=30)
        boot.shutdown()


def _train(step, params, opt_state, batch, n):
    losses = []
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state, *batch)
        losses.append(float(loss))
    return losses


def test_port_trainer_against_jax_server_through_the_dht(mixed_swarm):
    boot, procs = mixed_swarm
    dht = DHT(initial_peers=[boot.endpoint], cache_ttl=0.0)
    try:
        alive = _wait_alive(lambda p: dht._loop.run(dht._get_alive(p)),
                            procs, ["mj0", "mj1"], GRID[0])
        cfg = SwarmTransformerConfig(**_cfg_kw("mj"))
        model = SwarmDMoETransformerLM(cfg, dht)
        params = model.init_params(jrandom.PRNGKey(1),
                                   device="cpu")
        opt = optim.adamw(3e-3)
        ids, tgt = _batch(30)
        losses = _train(model.make_train_step(opt), params, opt.init(params),
                        (ids, tgt), 6)
        assert losses[-1] < losses[0], losses
        updates = sum(JaxRemoteExpert(u, ep).info()["update_count"]
                      for u, ep in alive.items())
        sent = sum(m.backward_rpcs_sent for m in model.moes)
        acked = sum(m.backward_rpcs_ok for m in model.moes)
        assert 0 < acked <= updates <= sent
    finally:
        dht.shutdown()


def test_jax_trainer_against_port_server_through_the_dht(mixed_swarm):
    boot, procs = mixed_swarm
    dht = JaxDHT(initial_peers=[boot.endpoint], cache_ttl=0.0)
    try:
        alive = _wait_alive(lambda p: dht._loop.run(dht._get_alive(p)),
                            procs, ["mp0", "mp1"], GRID[0])
        model = JaxSwarmLM(JaxSwarmConfig(**_cfg_kw("mp")), dht)
        params = model.init_params(jax.random.PRNGKey(1))
        opt = optax.adamw(3e-3)
        ids, tgt = (jnp.asarray(a) for a in _batch(31))
        losses = _train(model.make_train_step(opt), params, opt.init(params),
                        (ids, tgt), 6)
        assert losses[-1] < losses[0], losses
        updates = sum(RemoteExpert(u, ep).info()["update_count"]
                      for u, ep in alive.items())
        sent = sum(m.backward_rpcs_sent for m in model.moes)
        acked = sum(m.backward_rpcs_ok for m in model.moes)
        assert 0 < acked <= updates <= sent
    finally:
        dht.shutdown()
