"""The port's swarm-mode trainer (``train_lm --mode swarm``) against the
JAX package's, on the CPU (``--device cpu``).

- ``train_lm --mode swarm`` with in-process servers: the JAX script's
  ``run_swarm`` and the twin at the same seed and args (d 32, 2 layers, 4
  experts a layer on 2 servers, seq 16, batch 4, 4 steps), each waiting
  for every expert reply (``full_quorum``); the JAX side's servers run as
  processes of their own (``jax_swarm_servers``), with the in-process
  servers' seeds, optimizer and batch limit.  The experts
  are crc32-seeded from flax's stream on both sides and the trunks drawn
  from one key, so the runs are one computation in two packages: step 0's
  loss at rtol 2e-5, the later steps' at 1e-4 (the two-level AdamW bar of
  ``test_torch_train_step.py``: an element with |g| near adam's eps may
  move a parameter 2e-4 apart, which moves these losses far less), each
  beside the JAX line's rounding to 4 decimals (5e-5 absolute).  The
  backward-RPC and server-update counts are equal.
- ``--overlap`` equals ``--overlap-serial`` bit for bit (losses and
  params), the JAX package's own contract for the two schedules.
- One ``--subprocess-servers`` run (servers through ``python -m
  learning_at_home_tpu_torch.server --device cpu``) and one
  ``--n-trainers 2 --averaging`` run: the trainers' ``avg_final_params.npz``
  are equal bit for bit and ``server_updates_total <=
  backward_rpcs_sent_total``; no server outlives its run.
"""

import functools
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from learning_at_home_tpu.client import reset_client_rpc as jax_reset_client
from learning_at_home_tpu_torch.experiments import train_lm
from learning_at_home_tpu_torch.tree import jax_tree_leaves
from learning_at_home_tpu_torch.utils.subproc import SERVER_MODULE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWARM = ["--mode", "swarm", "--d-model", "32", "--n-layers", "2",
         "--experts-per-layer", "4", "--n-servers", "2", "--seq-len", "16",
         "--batch-size", "4", "--log-every", "1", "--no-telemetry"]
JAX_ROUNDING = 5e-5  # the JAX script prints losses to 4 decimals


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", os.path.join(REPO, "experiments",
                                                f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture
def full_quorum(monkeypatch):
    """Both packages' swarm configs wait for every expert reply (a 60 s
    straggler grace, not 1 s), so a slow first call on a loaded host
    drops no reply on one side only (as
    ``tests/test_torch_swarm_transformer.py`` does)."""
    import learning_at_home_tpu.models.transformer_swarm as jax_swarm
    import learning_at_home_tpu_torch.models.transformer_swarm as port_swarm

    for module in (jax_swarm, port_swarm):
        waiting = functools.partial(module.SwarmTransformerConfig,
                                    timeout_after_k_min=60.0)
        monkeypatch.setattr(module, "SwarmTransformerConfig", waiting)


# the JAX servers' start, every expert alive in the DHT (a loaded host
# imports JAX and compiles for tens of seconds)
JAX_SERVERS_START_S = 180.0


@pytest.fixture
def jax_swarm_servers():
    """The JAX script's in-process swarm (``run_swarm`` without
    ``--initial-peers``) as processes of their own: a JAX bootstrap DHT
    node here and ``--n-servers`` JAX server processes hosting the uids
    ``_uids_for_server`` strides onto them, crc32-seeded with the script's
    adam and batch limit, every expert alive before it returns the
    bootstrap's ``host:port``.  In-process JAX servers share the XLA
    runtime with the JAX trainer, whose backward waits in a host
    callback; on a loaded host that starves the servers, and backward
    RPCs time out on the JAX side only."""
    from learning_at_home_tpu.dht import DHT as JaxDHT
    from learning_at_home_tpu.utils.subproc import clean_jax_subprocess_env

    args = train_lm.parse_args(SWARM)
    boot = JaxDHT()
    client = JaxDHT(initial_peers=[boot.endpoint])
    env = clean_jax_subprocess_env(REPO)
    procs = []
    try:
        for s in range(args.n_servers):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "learning_at_home_tpu.server",
                 "--expert-uids",
                 ",".join(train_lm._uids_for_server(args, s)),
                 "--hidden-dim", str(args.d_model), "--host", "127.0.0.1",
                 "--port", "0", "--initial-peers",
                 f"{boot.endpoint[0]}:{boot.endpoint[1]}",
                 "--update-period", "5.0", "--optimizer", "adam",
                 "--lr", str(args.lr), "--max-batch-size", "4096"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
            threading.Thread(target=procs[-1].stdout.read,
                             daemon=True).start()
        want = args.n_layers * args.experts_per_layer
        deadline = time.monotonic() + JAX_SERVERS_START_S
        while True:
            found = sum(len(client._loop.run(client._get_alive(f"ffn{i}")))
                        for i in range(args.n_layers))
            if found == want:
                break
            dead = [p.returncode for p in procs if p.poll() is not None]
            assert not dead and time.monotonic() < deadline, (
                f"{found}/{want} JAX experts alive, exits {dead}")
            time.sleep(0.25)
        yield f"{boot.endpoint[0]}:{boot.endpoint[1]}"
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        client.shutdown()
        boot.shutdown()


@pytest.fixture
def keep_sigterm():
    """The drivers route SIGTERM to ``sys.exit`` (so spawned servers are
    torn down); the worker gets its own handler back."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def free_port_block(n: int) -> int:
    """A base port with ``n`` consecutive free ports after it."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535:
            continue
        try:
            socks = []
            for i in range(n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no block of free ports")


def live_servers_on(ports) -> list:
    """Port server processes whose argv names one of ``ports``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = [a.decode() for a in f.read().split(b"\0") if a]
        except OSError:
            continue
        if SERVER_MODULE in argv and "--port" in argv and \
                argv[argv.index("--port") + 1] in {str(p) for p in ports}:
            found.append(int(pid))
    return found


# ---- train_lm --mode swarm ----

def test_swarm_in_process_matches_jax_run_swarm(monkeypatch, capsys,
                                                full_quorum, keep_sigterm,
                                                jax_swarm_servers):
    jmod = jax_script("train_lm")
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *SWARM, "--steps", "4",
                                      "--initial-peers", jax_swarm_servers])
    capsys.readouterr()
    jmod.run_swarm(jmod.parse_args())
    want = [e for e in json_lines(capsys.readouterr().out) if "step" in e]
    jax_reset_client()
    out = train_lm.main(SWARM + ["--steps", "4", "--device", "cpu"])
    got = [e for e in json_lines(capsys.readouterr().out) if "step" in e]
    assert [e["step"] for e in got] == [e["step"] for e in want] == \
        [0, 1, 2, 3]
    assert [set(e) for e in got] == [set(e) for e in want]
    jl = np.asarray([e["loss"] for e in want])
    np.testing.assert_allclose(out["losses"][0], jl[0],
                               rtol=2e-5, atol=JAX_ROUNDING)
    np.testing.assert_allclose(out["losses"][1:], jl[1:],
                               rtol=1e-4, atol=JAX_ROUNDING)
    for key in ("server_updates", "backward_rpcs_sent", "backward_rpcs_ok"):
        assert [e[key] for e in got] == [e[key] for e in want], key


def test_overlap_equals_overlap_serial_bitwise(capsys, full_quorum,
                                               keep_sigterm):
    runs = {arm: train_lm.main(SWARM + ["--steps", "3", arm,
                                        "--device", "cpu"])
            for arm in ("--overlap", "--overlap-serial")}
    text = capsys.readouterr().out
    assert "# shortcut schedule: overlapped" in text
    assert "# shortcut schedule: serial" in text
    a, b = runs["--overlap"], runs["--overlap-serial"]
    assert a["losses"] == b["losses"]
    for x, y in zip(jax_tree_leaves(a["params"]),
                    jax_tree_leaves(b["params"])):
        assert x.dtype == y.dtype and x.numpy().tobytes() == \
            y.numpy().tobytes()


def test_subprocess_servers_run_and_die_with_it(capsys, keep_sigterm):
    base = free_port_block(2)
    out = train_lm.main(SWARM + ["--steps", "3", "--subprocess-servers",
                                 "--base-port", str(base),
                                 "--device", "cpu"])
    text = capsys.readouterr().out
    assert "# discovered 8/8 experts via DHT" in text
    lines = [e for e in json_lines(text) if "step" in e]
    assert all(np.isfinite(out["losses"]))
    last = lines[-1]
    assert 0 < last["backward_rpcs_ok"] <= last["server_updates"] <= \
        last["backward_rpcs_sent"]
    assert live_servers_on([base, base + 1]) == []


def test_two_averaging_trainers_end_identical(tmp_path, capsys,
                                              keep_sigterm):
    base = free_port_block(2)
    summary = train_lm.main(SWARM + [
        "--steps", "4", "--n-trainers", "2", "--averaging",
        "--averaging-every", "2", "--averaging-timeout", "20",
        "--base-port", str(base), "--checkpoint-dir", str(tmp_path),
        "--device", "cpu"])
    text = capsys.readouterr().out
    assert json_lines(text)[-1] == summary
    assert summary["n_trainers"] == 2
    assert summary["server_updates_total"] <= \
        summary["backward_rpcs_sent_total"]
    assert summary["experts_updated"] > 0
    for t in summary["trainers"]:
        assert t["averaging_rounds"] >= 1
    with np.load(tmp_path / "t0" / "avg_final_params.npz") as a, \
            np.load(tmp_path / "t1" / "avg_final_params.npz") as b:
        assert sorted(a.files) == sorted(b.files) and a.files
        for key in a.files:
            assert a[key].tobytes() == b[key].tobytes(), key
    assert live_servers_on([base, base + 1]) == []
