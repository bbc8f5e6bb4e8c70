#!/usr/bin/env python
"""The pre-test gate over the port: fail in seconds when a stage the
tier-1 run depends on is broken, instead of minutes into the run.

    python -m learning_at_home_tpu_torch.tools.collect_gate [--device cpu]

The JAX repo's ``tools/collect_gate.py`` run over
``learning_at_home_tpu_torch/``, in the same order, with the same exit
codes and verdict lines:

- stage 0, LINT (rc 5): ``analysis.lint`` over the package; any
  finding not baselined with ``# lah-lint: ignore[Rn] <reason>`` fails;
- stage 0.5, VERIFY (rc 6): ``tools.lah_verify --smoke`` in a
  subprocess under ``LAH_SANITIZE=1`` (interleaving exploration of the
  gateway scheduler, drain lifecycle and handoff receiver, and the
  seeded-bug self-validation);
- stage 0.7, SCHEMA (rc 7): the wire IR must cover every op of the
  package's ``docs/PROTOCOL.md`` tables, then ``tools.lah_fuzz --smoke``
  in a subprocess (its expert and gateway hosts on ``--device``);
- stage 0.8, PLACEMENT (rc 8): ``tools.lah_rebalance --plan`` twice
  over each embedded fixture: byte-identical, non-empty and
  cost-improving plans;
- the ORPHAN GUARD (rc 4): refuse to time anything while port servers
  of an earlier run are alive (``LAH_IGNORE_ORPHANS=1`` proceeds);
- COLLECTION: ``pytest --collect-only`` on ``tests/test_torch_*.py``
  (pytest's exit code).  Where the JAX package cannot import (jax, flax
  or optax is not installed), only the port test files that import
  neither JAX nor the JAX package (an AST scan) are collected, under
  ``--noconftest``: the repo's conftest imports jax;
- the twelve SMOKES, in a child process (``--smoke-worker``; its exit
  code, or 1 when a marker is missing): client path under both wire
  protocols, averaging, codec, telemetry, replication, overlap,
  lifecycle, DHT sim, macro-sim, SLO churn, gateway, SLO trace.

Expert servers, the gateway's decoder and the swarm models' params sit
on ``--device`` (default: the CUDA card; without one the gate exits 3
and says why, before any stage).  The DHT, sim and churn smokes' own
processes pick their device as their CLIs do.

``--lint`` runs ONLY the lint stage; ``--verify`` the lint and verify
stages; ``--schema`` up to schema; ``--placement`` up to placement;
``--no-smoke`` skips the smokes; ``--smoke-worker`` is the child mode
that runs them.  ``LAH_SANITIZE_SUMMARY=<path>`` makes the lint stage
print a tier-1 sanitizer export when present.
"""

import argparse
import ast
import glob
import importlib.util
import json
import os
import subprocess
import sys

PKG_NAME = "learning_at_home_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NO_DEVICE_RC = 3
# modules a torch-only test file may not import: JAX, its libraries, the
# JAX package and the JAX repo's script directories
JAX_SIDE = ("jax", "jaxlib", "flax", "optax", "learning_at_home_tpu",
            "tools", "experiments", "bench", "__graft_entry__")
REFERENCE_DEPS = ("jax", "flax", "optax")


def _module(name: str) -> list:
    """``python -m`` of one of the package's modules."""
    return [sys.executable, "-m", f"{PKG_NAME}.{name}"]


def orphan_guard() -> int:
    """REFUSE to run (rc=4, PIDs printed) when port servers of an earlier
    session are alive: they load the host's cores and corrupt every
    timing this gate (and the tier-1 run after it) takes.  Kill the PIDs
    and re-run, or set LAH_IGNORE_ORPHANS=1 to proceed anyway."""
    try:
        from learning_at_home_tpu_torch.utils.subproc import (
            find_orphan_servers,
        )

        orphans = find_orphan_servers()
    except Exception as e:
        print(f"collect_gate: orphan scan failed ({e}); continuing",
              file=sys.stderr)
        return 0
    if not orphans:
        return 0
    for pid, age, cmd in orphans:
        print(f"collect_gate: ORPHAN server pid={pid} age={age}s: {cmd}",
              file=sys.stderr)
    if os.environ.get("LAH_IGNORE_ORPHANS") == "1":
        print("collect_gate: LAH_IGNORE_ORPHANS=1 — proceeding on a DIRTY "
              "box", file=sys.stderr)
        return 0
    print("collect_gate: REFUSING — kill the orphan PIDs above (kill -9 "
          "<pid>) or set LAH_IGNORE_ORPHANS=1", file=sys.stderr)
    return 4


def lint_stage() -> int:
    """Stage 0: lah-lint over the package.  Fails (rc=5) on any finding
    not baselined with an inline ``# lah-lint: ignore[Rn]`` annotation.
    Pure AST, sub-second."""
    try:
        from learning_at_home_tpu_torch.analysis.lint import (
            format_findings,
            lint_paths,
        )
    except Exception as e:
        print(f"collect_gate: lint stage unavailable ({e})", file=sys.stderr)
        return 5
    findings = lint_paths([os.path.join(REPO, PKG_NAME)])
    active = [f for f in findings if not f.suppressed]
    if active:
        print("collect_gate: FAIL — lint findings (fix them or baseline "
              "with `# lah-lint: ignore[Rn] <reason>`):", file=sys.stderr)
        print(format_findings(findings), file=sys.stderr)
        return 5
    sup = sum(1 for f in findings if f.suppressed)
    print(f"collect_gate: lint OK — 0 findings, {sup} baselined")
    # surface the most recent tier-1 sanitizer export, if one exists
    summary_path = os.environ.get("LAH_SANITIZE_SUMMARY")
    if summary_path and os.path.exists(summary_path):
        try:
            with open(summary_path) as fh:
                print(f"collect_gate: sanitizer summary — {fh.read().strip()}")
        except OSError:
            pass
    return 0


def verify_stage() -> int:
    """Stage 0.5: ``lah_verify --smoke`` in a subprocess (the virtual
    clock's patching never leaks into this process).  LAH_SANITIZE=1
    arms the lock-footprint observer the explorer's pruning feeds on.
    Fails (rc=6) on any invariant violation or a seeded race the
    explorer no longer re-finds."""
    env = dict(os.environ)
    env.setdefault("LAH_SANITIZE", "1")
    try:
        r = subprocess.run(
            [*_module("tools.lah_verify"), "--smoke"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=int(os.environ.get("COLLECT_GATE_VERIFY_TIMEOUT_S",
                                       "120")),
        )
    except subprocess.TimeoutExpired:
        print("collect_gate: lah_verify timed out", file=sys.stderr)
        return 6
    if r.returncode != 0:
        print("collect_gate: FAIL — lah_verify:", file=sys.stderr)
        print(r.stdout[-2000:], file=sys.stderr)
        print(r.stderr[-1000:], file=sys.stderr)
        return 6
    tail = (r.stdout or "").strip().splitlines()
    print(f"collect_gate: verify OK — {tail[-1] if tail else ''}")
    return 0


def schema_stage(device: str) -> int:
    """Stage 0.7: every op the package's PROTOCOL.md documents must have
    an extracted handler schema, then ``lah_fuzz --smoke`` in a
    subprocess (the expert and gateway hosts on ``device``): schema-
    derived hostile frames against live instances of all four dispatcher
    families, tolerate-never-crash.  Fails (rc=7)."""
    try:
        from learning_at_home_tpu_torch.analysis.lint import (
            _doc_corpus,
            _find_docs_dir,
        )
        from learning_at_home_tpu_torch.analysis.schema import (
            coverage_report,
        )
    except Exception as e:
        print(f"collect_gate: schema stage unavailable ({e})",
              file=sys.stderr)
        return 7
    pkg = os.path.join(REPO, PKG_NAME)
    docs = _find_docs_dir(pkg)
    doc_ops = _doc_corpus(docs)["ops"] if docs else {}
    if not doc_ops:
        print("collect_gate: FAIL — no PROTOCOL.md op tables found",
              file=sys.stderr)
        return 7
    cov = coverage_report([pkg], doc_ops)
    if not cov["ok"]:
        print("collect_gate: FAIL — documented ops with no extracted "
              f"handler schema: {cov['missing_handler']}", file=sys.stderr)
        return 7
    env = dict(os.environ)
    env.setdefault("LAH_SANITIZE", "1")
    try:
        r = subprocess.run(
            [*_module("tools.lah_fuzz"), "--smoke", "--device", device],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=int(os.environ.get("COLLECT_GATE_FUZZ_TIMEOUT_S",
                                       "420")),
        )
    except subprocess.TimeoutExpired:
        print("collect_gate: lah_fuzz timed out", file=sys.stderr)
        return 7
    if r.returncode != 0:
        print("collect_gate: FAIL — lah_fuzz:", file=sys.stderr)
        print(r.stdout[-2000:], file=sys.stderr)
        print(r.stderr[-1000:], file=sys.stderr)
        return 7
    tail = (r.stdout or "").strip().splitlines()
    print(f"collect_gate: schema OK — {len(cov['ops'])} documented ops "
          f"covered; {tail[-1] if tail else ''}")
    return 0


# a skewed two-node fixture with two co-activation clusters split across
# the nodes and a slow measured link: the solver MUST consolidate (the
# plan is non-trivial) and MUST be byte-deterministic per seed — the
# live rebalancer replays plans move-for-move, so two driver instances
# with the same snapshot must never disagree
_PLACEMENT_FIXTURE = {
    "experts": {
        "expert.0": "10.0.0.1:31330", "expert.1": "10.0.0.2:31330",
        "expert.2": "10.0.0.1:31330", "expert.3": "10.0.0.2:31330",
        "expert.4": "10.0.0.1:31330", "expert.5": "10.0.0.2:31330",
    },
    "activations": {
        "expert.0": 900, "expert.1": 850, "expert.2": 800,
        "expert.3": 120, "expert.4": 100, "expert.5": 80,
    },
    "coact": {
        "expert.0|expert.1": 700, "expert.1|expert.2": 650,
        "expert.0|expert.2": 600, "expert.3|expert.4": 90,
        "expert.4|expert.5": 80,
    },
    "links": {
        "10.0.0.1:31330": {"10.0.0.2:31330": [0.04, 5.0e7]},
        "trainer-a": {
            "10.0.0.1:31330": [0.002, 2.0e8],
            "10.0.0.2:31330": [0.05, 4.0e7],
        },
    },
    "sources": {"trainer-a": 1.0},
    "bytes_per_dispatch": 1.5e6,
}

# capacity-locked interleave: two co-activation clusters split across
# two FULL nodes (cap == occupancy), so no single-expert move is ever
# admissible — only the pair-swap neighborhood can untangle it.  Pins
# the swap path into the same byte-determinism contract.
_PLACEMENT_SWAP_FIXTURE = {
    "experts": {
        "a.0": "10.0.0.1:31330", "a.1": "10.0.0.2:31330",
        "b.0": "10.0.0.1:31330", "b.1": "10.0.0.2:31330",
    },
    "coact": {"a.0|a.1": 500, "b.0|b.1": 500},
    "links": {
        "10.0.0.1:31330": {"10.0.0.2:31330": [0.04, 5.0e7]},
    },
    "capacity": {"10.0.0.1:31330": 2, "10.0.0.2:31330": 2},
    "bytes_per_dispatch": 1.5e6,
}


def _placement_plan_twice(fixture: dict, label: str):
    """Run ``lah_rebalance --plan`` twice over ``fixture``; returns the
    parsed plan, or None after printing the failure (the byte-diff is
    the determinism contract the live driver depends on)."""
    import tempfile

    with tempfile.NamedTemporaryFile(
        "w", suffix=".json", delete=False
    ) as fh:
        json.dump(fixture, fh)
        snap_path = fh.name
    try:
        outs = []
        for _ in range(2):
            try:
                r = subprocess.run(
                    [*_module("tools.lah_rebalance"),
                     "--plan", snap_path, "--seed", "0"],
                    cwd=REPO, capture_output=True, text=True,
                    timeout=int(os.environ.get(
                        "COLLECT_GATE_PLACEMENT_TIMEOUT_S", "60")),
                )
            except subprocess.TimeoutExpired:
                print(f"collect_gate: lah_rebalance --plan ({label}) "
                      "timed out", file=sys.stderr)
                return None
            if r.returncode != 0:
                print(f"collect_gate: FAIL — lah_rebalance --plan "
                      f"({label}):", file=sys.stderr)
                print(r.stdout[-2000:], file=sys.stderr)
                print(r.stderr[-1000:], file=sys.stderr)
                return None
            outs.append(r.stdout)
    finally:
        os.unlink(snap_path)
    if outs[0] != outs[1]:
        print(f"collect_gate: FAIL — placement plans ({label}) for one "
              "(snapshot, seed) differ between runs:", file=sys.stderr)
        print(outs[0], file=sys.stderr)
        print(outs[1], file=sys.stderr)
        return None
    try:
        return json.loads(outs[0])
    except ValueError:
        print(f"collect_gate: FAIL — --plan ({label}) printed non-JSON:",
              file=sys.stderr)
        print(outs[0][-500:], file=sys.stderr)
        return None


def placement_stage() -> int:
    """Stage 0.8: ``lah_rebalance --plan`` twice each over an embedded
    skewed fixture AND a capacity-locked fixture only pair swaps can
    improve, in subprocesses; fails (rc=8) unless every plan is
    byte-identical across runs, non-empty, and strictly cost-improving
    — the properties the live SLO-gated driver depends on."""
    for label, fixture, empty_msg in (
        ("skewed", _PLACEMENT_FIXTURE,
         "solver found no moves on the skewed fixture (must "
         "consolidate the split clusters)"),
        ("capacity-locked swap", _PLACEMENT_SWAP_FIXTURE,
         "solver found no moves on the capacity-locked fixture (the "
         "pair-swap neighborhood must untangle full nodes)"),
    ):
        plan = _placement_plan_twice(fixture, label)
        if plan is None:
            return 8
        if not plan.get("moves"):
            print(f"collect_gate: FAIL — {empty_msg}", file=sys.stderr)
            return 8
        if not plan["cost_after"] < plan["cost_before"]:
            print(f"collect_gate: FAIL — plan ({label}) does not "
                  f"improve cost ({plan['cost_before']} -> "
                  f"{plan['cost_after']})", file=sys.stderr)
            return 8
        print(f"collect_gate: placement OK ({label}) — byte-identical "
              f"plan, {len(plan['moves'])} move(s), cost "
              f"{plan['cost_before']} -> {plan['cost_after']}")
    return 0


def missing_reference() -> list:
    """Which of the JAX package's own imports (jax, flax, optax) are not
    installed here: without them the JAX package, and so the repo's
    conftest and the port's parity tests, do not import."""
    return [m for m in REFERENCE_DEPS if importlib.util.find_spec(m) is None]


def torch_only(path: str, _seen=None) -> bool:
    """The test file imports nothing of :data:`JAX_SIDE` (an AST scan of
    its import statements and ``import_module`` calls), nor does a
    module beside it that it imports."""
    seen = _seen if _seen is not None else set()
    seen.add(os.path.abspath(path))
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            if any(name == side or name.startswith(side + ".")
                   for side in JAX_SIDE):
                return False
            beside = os.path.join(os.path.dirname(os.path.abspath(path)),
                                  name.split(".")[0] + ".py")
            if (os.path.exists(beside) and beside not in seen
                    and not torch_only(beside, seen)):
                return False
    return True


def collection_stage(missing=None) -> int:
    """``pytest --collect-only`` on the port's test files; returns
    pytest's exit code.  Where the JAX package cannot import (``missing``
    None: :func:`missing_reference`), only the torch-only files are
    collected, under ``--noconftest``."""
    files = sorted(
        os.path.relpath(p, REPO)
        for p in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    extra = []
    missing = missing_reference() if missing is None else missing
    if missing:
        kept = [f for f in files if torch_only(os.path.join(REPO, f))]
        print(f"collect_gate: no {', '.join(missing)} here — collecting "
              f"{len(kept)} of {len(files)} port test files under "
              f"--noconftest; {len(files) - len(kept)} import jax or the "
              f"JAX package")
        files, extra = kept, ["--noconftest"]
    try:
        r = subprocess.run(
            [
                sys.executable, "-m", "pytest", *files, "-q",
                "--collect-only", "-p", "no:cacheprovider", *extra,
            ],
            cwd=REPO,
            capture_output=True,
            text=True,
            timeout=int(os.environ.get("COLLECT_GATE_TIMEOUT_S", "180")),
        )
    except subprocess.TimeoutExpired:
        print("collect_gate: pytest --collect-only timed out", file=sys.stderr)
        return 2
    tail = "\n".join((r.stdout or "").splitlines()[-15:])
    if r.returncode != 0:
        print("collect_gate: FAIL — collection errors:\n", file=sys.stderr)
        print(tail, file=sys.stderr)
        print(r.stderr[-2000:], file=sys.stderr)
        return r.returncode or 1
    last = tail.splitlines()[-1] if tail else ""
    print(f"collect_gate: OK — {last.strip()}")
    return 0


# ---------------------------------------------------------------------------
# the smokes (run in the --smoke-worker child)
# ---------------------------------------------------------------------------


def _where(srv) -> str:
    """The device(s) a server's experts live on."""
    return ",".join(sorted({str(b.device) for b in srv.experts.values()}))


def _peak_bytes(endpoints) -> list:
    """Each server's ``stats`` RPC ``lah_server_device_peak_bytes`` (its
    card's peak; None for a server whose experts are on the CPU)."""
    from learning_at_home_tpu_torch.client.rpc import (
        client_loop,
        pool_registry,
    )

    out = []
    for ep in endpoints:
        _, meta = client_loop().run(
            pool_registry().get(ep).rpc("stats", (), {}, timeout=60.0))
        collected = (meta.get("metrics") or {}).get("collected") or {}
        out.append(collected.get("lah_server_device_peak_bytes"))
    return out


def client_path_smoke(device: str) -> int:
    """One fwd+bwd RPC per protocol version against an in-process server
    on ``device``; numerics must agree across protocols and v2 must
    actually negotiate."""
    import numpy as np

    from learning_at_home_tpu_torch.client import RemoteExpert, reset_client_rpc
    from learning_at_home_tpu_torch.client.rpc import (
        pool_registry,
        set_dispatch_mode,
    )
    from learning_at_home_tpu_torch.optim import sgd
    from learning_at_home_tpu_torch.server.server import background_server

    with background_server(
        num_experts=1, hidden_dim=8, expert_prefix="gate", seed=0,
        optimizer=sgd(0.0),  # frozen params: replies must match
        device=device,
    ) as (endpoint, srv):
        expert = RemoteExpert("gate.0", endpoint, timeout=30.0)
        x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
        g = np.ones((2, 8), np.float32)
        outs = {}
        for mode in ("legacy", "pipelined"):
            set_dispatch_mode(mode)
            y = expert.forward_blocking([x])[0]
            gx = expert.backward_blocking([x], [g])[0]
            assert y.shape == x.shape and gx.shape == x.shape
            assert np.isfinite(y).all() and np.isfinite(gx).all()
            outs[mode] = (y, gx)
        np.testing.assert_allclose(
            outs["legacy"][0], outs["pipelined"][0], atol=1e-6
        )
        np.testing.assert_allclose(  # backward wire path too, not just fwd
            outs["legacy"][1], outs["pipelined"][1], atol=1e-6
        )
        pool = pool_registry().peek(endpoint)
        assert pool is not None and pool._proto == 2, (
            f"pipelined mode did not negotiate protocol v2 (got "
            f"{None if pool is None else pool._proto})"
        )
        where = _where(srv)
    reset_client_rpc()
    print(f"client path: expert on {where}")
    print("SMOKE_OK protocols=v1,v2")
    return 0


def dht_smoke(device: str) -> int:
    """DHT control-plane gate: a 200-virtual-node simulated swarm
    (in-process transport shim, real DHTNode/DHTProtocol code) must
    join, survive two kill-and-replace churn rounds with lookup hit-rate
    >= 0.99, and show the coalesced heartbeat cutting store RPCs >= 4x vs
    the per-key baseline.  Host only (``device`` unused)."""
    try:
        r = subprocess.run(
            [
                *_module("experiments.dht_swarm_sim"),
                "--sizes", "200", "--experts", "64",
                "--churn-rounds", "2", "--lookups", "120", "--check",
            ],
            cwd=REPO, capture_output=True, text=True,
            timeout=int(os.environ.get("COLLECT_GATE_DHT_TIMEOUT_S", "180")),
        )
    except subprocess.TimeoutExpired:
        print("collect_gate: DHT swarm sim timed out", file=sys.stderr)
        return 2
    if r.returncode != 0 or "DHT_SWARM_SIM_OK" not in r.stdout:
        print("collect_gate: FAIL — DHT swarm sim:", file=sys.stderr)
        print(r.stdout[-1500:], file=sys.stderr)
        print(r.stderr[-1500:], file=sys.stderr)
        return r.returncode or 1
    line = next(
        (ln for ln in r.stdout.splitlines() if ln.startswith("{")), "{}"
    )
    rep = json.loads(line)
    print(
        "DHT_SMOKE_OK nodes=200 "
        f"hit_rate={rep['churn']['hit_rate']} "
        f"store_reduction={rep['heartbeat']['reduction']}x "
        f"join_mean_ms={rep['join']['mean_ms']}"
    )
    return 0


def macro_sim_smoke(device: str) -> int:
    """Whole-system macro-sim gate: a 200-virtual-node swarm (real
    DHT/scheduler/admission/routing code on the virtual clock) serves a
    warmup+burst trace through one kill event; the burst must push real
    admission into shedding (without collapsing), TTFT p99 must stay
    bounded, lookups must keep resolving.  Host only (``device``
    unused)."""
    try:
        r = subprocess.run(
            [
                *_module("sim.runner"),
                "--nodes", "200", "--servers", "48", "--gateways", "4",
                "--experts", "64", "--slots", "32",
                "--trace", "poisson:60:6,burst:480:3",
                "--churn", "4:kill:0.15",
                "--check", "--min-completed", "300",
                "--shed-min", "0.01", "--shed-max", "0.55",
                "--ttft-p99-max-ms", "45000", "--hit-rate-floor", "0.75",
            ],
            cwd=REPO, capture_output=True, text=True,
            timeout=int(
                os.environ.get("COLLECT_GATE_MACRO_SIM_TIMEOUT_S", "240")
            ),
        )
    except subprocess.TimeoutExpired:
        print("collect_gate: macro-sim smoke timed out", file=sys.stderr)
        return 2
    ok_line = next(
        (ln for ln in r.stdout.splitlines()
         if ln.startswith("MACRO_SIM_OK")), None,
    )
    if r.returncode != 0 or ok_line is None:
        print("collect_gate: FAIL — macro-sim smoke:", file=sys.stderr)
        print(r.stdout[-1500:], file=sys.stderr)
        print(r.stderr[-1500:], file=sys.stderr)
        return r.returncode or 1
    print(ok_line)
    return 0


def lifecycle_smoke(device: str) -> int:
    """Lifecycle gate: drain one of two servers (experts on ``device``)
    while a client keeps dispatching — ZERO failed dispatches and zero
    dropped samples, the successor serves the migrated experts with
    BITWISE-equal params and optimizer state, and the drained server
    ends DRAINED with its experts retired."""
    import time

    import numpy as np
    import torch

    from learning_at_home_tpu_torch import random as jrandom
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.optim import adam
    from learning_at_home_tpu_torch.server.server import Server
    from learning_at_home_tpu_torch.tree import tree_leaves

    hid = 16
    boot = DHT()
    d_a = DHT(initial_peers=[boot.endpoint])
    d_b = DHT(initial_peers=[boot.endpoint])
    d_c = DHT(initial_peers=[boot.endpoint])
    srv_a = Server.create(
        expert_uids=["lg.0", "lg.1"], hidden_dim=hid, host="127.0.0.1",
        optimizer=adam(1e-3), dht=d_a, update_period=0.4, device=device,
    )
    srv_b = Server.create(
        expert_uids=["lg.2", "lg.3"], hidden_dim=hid, host="127.0.0.1",
        optimizer=adam(1e-3), dht=d_b, update_period=0.4, device=device,
    )
    try:
        moe = RemoteMixtureOfExperts(
            in_features=hid, grid_size=(4,), uid_prefix="lg", source=d_c,
            k_best=3, k_min=1, timeout_after_k_min=0.5,
            forward_timeout=20.0, alive_ttl=0.4,
        )
        deadline = time.time() + 30
        while time.time() < deadline:
            if len(d_c._loop.run(d_c._get_alive("lg"))) == 4:
                break
            time.sleep(0.2)
        gate = moe.init_gate_params(jrandom.PRNGKey(0).to(device))
        x = torch.as_tensor(
            np.random.RandomState(0).randn(8, hid).astype(np.float32),
            device=device,
        )
        failures = 0
        want = None
        for it in range(24):
            if it == 6:
                want = {
                    uid: b.state_dict() for uid, b in srv_a.experts.items()
                }
                assert srv_a.start_drain(
                    successor=srv_b.endpoint, grace=0.5, quiesce_timeout=5.0
                )
            try:
                y = moe(x, gate)
                assert torch.isfinite(y).all()
            except Exception:
                failures += 1
        assert srv_a.wait_drained(timeout=30.0), "drain never completed"
        assert failures == 0, f"{failures} dispatches failed mid-drain"
        assert moe.samples_dropped == 0, moe.samples_dropped
        assert not srv_a.experts, "drained server still hosts experts"
        assert srv_a.lifecycle_state == "DRAINED"
        # successor serves the migrated experts BITWISE (params AND
        # optimizer state — the live-migration acceptance contract)
        for uid, state in want.items():
            got = srv_b.experts[uid].state_dict()
            for a, b in zip(
                tree_leaves(
                    {"params": state["params"],
                     "opt_state": state["opt_state"]}
                ),
                tree_leaves(
                    {"params": got["params"], "opt_state": got["opt_state"]}
                ),
            ):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert srv_b.handoff.received == 2
        print(
            f"lifecycle: drained=2 experts migrated bitwise, "
            f"failed_dispatches=0 dropped=0 (experts on {_where(srv_b)})"
        )
    finally:
        for srv in (srv_a, srv_b):
            try:
                srv.shutdown()
            except Exception as e:
                print(f"collect_gate: lifecycle smoke teardown: {e!r}",
                      file=sys.stderr)
        reset_client_rpc()
        for d in (d_a, d_b, d_c, boot):
            d.shutdown()
    print("LIFECYCLE_SMOKE_OK migration=bitwise")
    return 0


def slo_smoke(device: str) -> int:
    """SLO gate: the churn harness's fast profile — subprocess servers
    (on ``device``) under a sustained mixed graceful/hard
    kill-and-rejoin schedule — must hold its floors: throughput >= 0.8x
    the churn-free baseline, the dispatch p99 ceiling, and zero quorum
    failures during graceful drains.  The harness exits non-zero on any
    violation; the JSON report is re-checked here so the gate fails
    loudly with the verdict, not just an exit code."""
    import tempfile

    report = os.path.join(tempfile.mkdtemp(prefix="slo_gate_"), "slo.json")
    try:
        r = subprocess.run(
            [
                *_module("experiments.churn_experiment"),
                "--profile", "fast", "--report", report,
                "--device", device,
            ],
            cwd=REPO, capture_output=True, text=True,
            timeout=int(os.environ.get("COLLECT_GATE_SLO_TIMEOUT_S", "420")),
        )
    except subprocess.TimeoutExpired:
        print("collect_gate: SLO harness timed out", file=sys.stderr)
        return 2
    try:
        with open(report) as f:
            summary = json.load(f)
    except (OSError, json.JSONDecodeError):
        summary = None
    if r.returncode != 0 or not summary or not summary["slo"]["pass"]:
        print("collect_gate: FAIL — SLO harness:", file=sys.stderr)
        print((summary or {}).get("slo"), file=sys.stderr)
        print(r.stdout[-1500:], file=sys.stderr)
        print(r.stderr[-1500:], file=sys.stderr)
        return r.returncode or 1
    print(
        f"slo: throughput_ratio={summary['throughput_ratio']} "
        f"p99={summary['dispatch_p99_churn_ms']}ms "
        f"kills={summary['kills']} "
        f"graceful_failures="
        f"{summary['quorum_failures_during_graceful_drains']}"
    )
    print("SLO_SMOKE_OK profile=fast")
    return 0


def replication_smoke(device: str) -> int:
    """Replication gate: one expert grown to TWO replicas — the second
    installed through the real replica lifecycle (``Server.add_replica``
    on an initially-empty server) and advertised via the replica-aware
    DHT subkey scheme — then the primary is killed while the client's
    cached alive set still lists it.  The next dispatch must succeed
    through the hedged fallback with ZERO dropped samples, a hedge-win
    counter > 0, and the same reply (replicas share the uid's
    crc32-seeded params)."""
    import time

    import numpy as np
    import torch

    from learning_at_home_tpu_torch import random as jrandom
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
    from learning_at_home_tpu_torch.client.routing import as_replica_set
    from learning_at_home_tpu_torch.client.rpc import pool_registry
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.optim import sgd
    from learning_at_home_tpu_torch.server.server import Server

    hid = 16
    boot = DHT()
    d_a = DHT(initial_peers=[boot.endpoint])
    d_b = DHT(initial_peers=[boot.endpoint])
    d_c = DHT(initial_peers=[boot.endpoint])
    srv_a = Server.create(
        expert_uids=["rg.0"], hidden_dim=hid, host="127.0.0.1",
        optimizer=sgd(0.0), dht=d_a, update_period=1.0, device=device,
    )
    srv_b = Server.create(
        num_experts=0, hidden_dim=hid, host="127.0.0.1",
        optimizer=sgd(0.0), dht=d_b, update_period=1.0, device=device,
    )
    try:
        assert srv_b.add_replica("rg.0"), "replica install failed"
        moe = RemoteMixtureOfExperts(
            in_features=hid, grid_size=(1,), uid_prefix="rg", source=d_c,
            k_best=1, k_min=1, forward_timeout=20.0, alive_ttl=60.0,
            hedge_floor_s=0.05,
        )
        deadline = time.time() + 30
        alive = {}
        while time.time() < deadline:
            alive = d_c._loop.run(d_c._get_alive("rg"))
            if "rg.0" in alive and len(as_replica_set(alive["rg.0"])) == 2:
                break
            time.sleep(0.3)
        assert len(as_replica_set(alive.get("rg.0", ()))) == 2, (
            f"replica set never resolved: {alive}"
        )
        gate = moe.init_gate_params(jrandom.PRNGKey(0).to(device))
        x = torch.as_tensor(
            np.random.RandomState(0).randn(4, hid).astype(np.float32),
            device=device,
        )
        y0 = moe(x, gate).cpu().numpy()  # both alive; caches the alive set
        # pin the dying server as PRIMARY, then kill it — the 60 s alive
        # TTL keeps it in the cached set, so only hedging can save the
        # next dispatch
        pool_registry().get(srv_a.endpoint).rtt_ema = 0.001
        pool_registry().get(srv_b.endpoint).rtt_ema = 0.5
        where = _where(srv_b)
        srv_a.shutdown()
        y1 = moe(x, gate).cpu().numpy()
        np.testing.assert_allclose(y1, y0, atol=1e-5)
        routing = moe.dispatch_stats()["routing"]
        assert routing["hedge_wins"] >= 1, routing
        assert moe.samples_dropped == 0, moe.samples_dropped
        assert moe._headline_metrics()["lah_client_hedge_wins_total"] >= 1
        print(
            f"replication: replica_set=2 hedge_wins={routing['hedge_wins']}"
            f" fires={routing['hedge_fires']} dropped=0 (replica on "
            f"{where})"
        )
    finally:
        for srv in (srv_a, srv_b):
            try:
                srv.shutdown()  # srv_a is already down (the kill) — fine
            except Exception as e:
                print(f"collect_gate: replica smoke teardown: {e!r}",
                      file=sys.stderr)
        reset_client_rpc()
        for d in (d_a, d_b, d_c, boot):
            d.shutdown()
    print("REPLICA_SMOKE_OK hedge=first-reply-wins")
    return 0


def overlap_smoke(device: str) -> int:
    """Overlap gate: a 2-layer swarm forward against two fake-delay pools
    — SUBPROCESS servers (on ``device``) with ~50/60 ms injected chaos
    reply latency and ``nop`` experts, so the window is pure latency.
    The overlapped schedule must (a) produce bitwise the same outputs as
    the serial schedule — same primitive ops, different host-side
    scheduling — and (b) beat it wall-clock, because each layer's
    attention now runs inside the in-flight RPC window.

    Subprocess (not in-process) servers are load-bearing: an in-process
    server shares the client's interpreter lock, and the attention the
    schedule hides starves the server's loop threads — the reply window
    then GROWS by exactly the hidden compute and the A/B measures
    nothing.

    The trainer (its params and attention) runs on the host CPU with one
    intra-op thread, as the JAX gate's does, whatever ``device`` is: (b)
    needs compute to hide.  On a CUDA card the attention at these sizes
    takes ~1 ms a layer against the ~55 ms window (overlap fraction
    ~0.05), and with every core the CPU attention takes ~5 ms while its
    threads slow the replies as much: either way the two schedules'
    medians fell within a few ms of each other, in either order."""
    import time

    import numpy as np
    import torch

    from learning_at_home_tpu_torch import random as jrandom
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.utils.subproc import (
        shutdown_procs,
        spawn_overlap_swarm,
    )

    try:
        # the ONE shared swarm definition (utils.subproc)
        servers, source, cfg = spawn_overlap_swarm(
            REPO, "ov", (0.05, 0.06), extra_args=("--device", device)
        )
    except Exception as e:
        print(f"collect_gate: overlap smoke setup failed: {e}",
              file=sys.stderr)
        return 1
    try:
        from learning_at_home_tpu_torch.models.transformer_swarm import (
            SwarmDMoETransformerLM,
        )

        # one model per arm: fractions must not mix schedules
        model_s = SwarmDMoETransformerLM(cfg, source)
        model_o = SwarmDMoETransformerLM(cfg, source)
        params = model_s.init_params(jrandom.PRNGKey(0), device="cpu")
        ids = torch.as_tensor(
            np.random.RandomState(0).randint(0, 64, (8, cfg.seq_len)))

        def run(model, overlap: bool):
            t0 = time.monotonic()
            with torch.no_grad():
                out = model.apply_overlapped(params, ids, overlap=overlap)
            return time.monotonic() - t0, out.numpy()

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            run(model_s, False), run(model_o, True)  # warm, unmeasured
            serial_t, overlap_t = [], []
            out_s = out_o = None
            for _ in range(3):  # interleaved pairs: box noise hits both arms
                dt, out_s = run(model_s, False)
                serial_t.append(dt)
                dt, out_o = run(model_o, True)
                overlap_t.append(dt)
        finally:
            torch.set_num_threads(threads)
        s50, o50 = float(np.median(serial_t)), float(np.median(overlap_t))
        assert np.array_equal(out_s, out_o), (
            "overlapped schedule changed the forward outputs"
        )
        assert o50 < s50, (
            f"overlapped step not faster: {o50 * 1e3:.1f} ms vs serial "
            f"{s50 * 1e3:.1f} ms"
        )
        frac = max(
            m.dispatch_stats()["overlap_fraction"] for m in model_o.moes
        )
        assert frac > 0.0, "overlap_fraction stayed zero under delays"
        print(
            f"overlap step p50: serial {s50 * 1e3:.1f} ms, overlapped "
            f"{o50 * 1e3:.1f} ms ({o50 / s50:.3f}), overlap_fraction "
            f"{frac:.3f}"
        )
        peaks = _peak_bytes([source.experts[f"ov{layer}.0"]
                             for layer in range(cfg.n_layers)])
        print(f"overlap: servers on {device}, their card peak bytes "
              f"(stats) {peaks}; the trainer on cpu, 1 thread")
    finally:
        shutdown_procs(servers)
        reset_client_rpc()
    print("OVERLAP_SMOKE_OK schedule=fire/join")
    return 0


def codec_smoke(device: str) -> int:
    """Quantized wire-codec gate: one fwd+bwd dispatch through a real
    server (on ``device``) under ``u8`` and ``blockq8``, asserting (a)
    the codec actually negotiated (not silently fallen back to raw), (b)
    wire bytes reduced >= 3.5x vs the ``none`` run, and (c) per-run input
    gradient cosine >= 0.99 vs uncompressed."""
    import numpy as np
    import torch

    from learning_at_home_tpu_torch import random as jrandom
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
    from learning_at_home_tpu_torch.client.routing import StaticExpertSource
    from learning_at_home_tpu_torch.client.rpc import pool_registry
    from learning_at_home_tpu_torch.optim import sgd
    from learning_at_home_tpu_torch.server.server import background_server

    hid, rows = 256, 256
    with background_server(
        num_experts=2, hidden_dim=hid, expert_prefix="cs", seed=0,
        optimizer=sgd(0.0),  # frozen params: runs must be comparable
        device=device,
    ) as (endpoint, srv):
        source = StaticExpertSource({uid: endpoint for uid in srv.experts})
        x0 = torch.as_tensor(
            np.random.RandomState(0).randn(rows, hid).astype(np.float32),
            device=device,
        )
        grads, bytes_per = {}, {}
        for codec in ("none", "u8", "blockq8"):
            moe = RemoteMixtureOfExperts(
                in_features=hid, grid_size=(2,), uid_prefix="cs",
                source=source, k_best=2, k_min=2, wire_codec=codec,
            )
            gate = moe.init_gate_params(jrandom.PRNGKey(0).to(device))
            x = x0.clone().requires_grad_(True)
            pool = pool_registry().get(endpoint)
            b0 = pool.bytes_sent + pool.bytes_received
            loss = torch.sum(moe(x, gate) ** 2)
            (gx,) = torch.autograd.grad(loss, x)
            grads[codec] = gx.cpu().numpy()
            bytes_per[codec] = pool.bytes_sent + pool.bytes_received - b0
            if codec != "none":
                counts = moe.dispatch_stats()["codecs"]
                assert counts.get(codec, 0) > 0, (
                    f"{codec} did not negotiate; payloads used {counts}"
                )
        for codec in ("u8", "blockq8"):
            reduction = bytes_per["none"] / max(bytes_per[codec], 1)
            g0, g1 = grads["none"], grads[codec]
            cos = float(
                (g0 * g1).sum()
                / (np.linalg.norm(g0) * np.linalg.norm(g1) + 1e-12)
            )
            assert reduction >= 3.5, (
                f"{codec} wire reduction {reduction:.2f}x < 3.5x "
                f"({bytes_per})"
            )
            assert cos >= 0.99, f"{codec} gradient cosine {cos:.4f} < 0.99"
            print(f"codec {codec}: bytes /{reduction:.2f}, "
                  f"grad_cosine {cos:.5f}")
        print(f"codec: experts on {_where(srv)}")
    reset_client_rpc()
    print("CODEC_SMOKE_OK codecs=u8,blockq8")
    return 0


def averaging_smoke(device: str) -> int:
    """Two in-process averaging peers, one round over trees on
    ``device``: post-round parameter equality and ``rounds == 1`` — the
    subsystem can't silently rot."""
    import threading

    import torch

    from learning_at_home_tpu_torch.averaging import (
        AveragingConfig,
        DecentralizedAverager,
    )
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.tree import tree_leaves

    dht = DHT()
    cfg = AveragingConfig(min_group_size=2, max_group_size=2,
                          part_timeout=5.0)
    a = DecentralizedAverager(dht, config=cfg, peer_id="gate-a")
    b = DecentralizedAverager(dht, config=cfg, peer_id="gate-b")
    trees = [
        {"w": torch.arange(33, dtype=torch.float32, device=device) * (i + 1),
         "b": torch.full((5,), float(i), dtype=torch.float32, device=device)}
        for i in range(2)
    ]
    results: list = [None, None]

    def run(i, av):
        results[i] = av.step_round(trees[i], matchmaking_timeout=30.0)

    try:
        threads = [
            threading.Thread(target=run, args=(i, av), daemon=True)
            for i, av in enumerate((a, b))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "averaging round hung"
        assert results[0] is not None and results[1] is not None
        (tree_a, info_a), (tree_b, _) = results
        assert not info_a["degraded"], info_a
        for la, lb in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            assert torch.equal(la, lb)
        want = (trees[0]["w"] + trees[1]["w"]) / 2.0
        assert torch.equal(tree_a["w"], want)
        assert a.stats()["rounds"] == 1, a.stats()
        assert b.stats()["rounds"] == 1, b.stats()
        where = tree_a["w"].device
    finally:
        a.shutdown()
        b.shutdown()
        dht.shutdown()
    print(f"averaging: averaged tree on {where}")
    print("AVG_SMOKE_OK rounds=1")
    return 0


def telemetry_smoke(device: str) -> int:
    """Observability smoke: one server (experts on ``device``) with a
    DHT, one driven RPC; its Prometheus endpoint must carry the
    always-on headline metrics WITHOUT LAH_PROFILE, and ``lah_top
    --once`` must discover and render the peer via the DHT alone (no
    endpoint on the CLI)."""
    import time
    import urllib.request

    import numpy as np

    from learning_at_home_tpu_torch.client import RemoteExpert, reset_client_rpc
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.server.server import background_server
    from learning_at_home_tpu_torch.utils.telemetry import discover_telemetry

    bootstrap = DHT()
    dht = DHT(initial_peers=[bootstrap.endpoint])
    try:
        with background_server(
            num_experts=1, hidden_dim=8, expert_prefix="tel", seed=0,
            dht=dht, update_period=2.0, device=device,
        ) as (endpoint, srv):
            expert = RemoteExpert("tel.0", endpoint, timeout=30.0)
            expert.forward_blocking([np.ones((2, 8), np.float32)])
            assert srv.metrics_port, "server did not start a metrics endpoint"
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.metrics_port}/metrics", timeout=10
            ).read().decode()
            for needle in (
                "lah_server_jobs_processed_total",
                "lah_server_updates_total",
                "lah_server_staging_reused_total",
            ):
                assert needle in text, f"headline metric {needle} missing"
            # the telemetry.<prefix> record must appear via DHT discovery
            deadline = time.time() + 30
            peers = {}
            while time.time() < deadline:
                peers = discover_telemetry(bootstrap, "swarm")
                if peers:
                    break
                time.sleep(0.5)
            assert peers, "no telemetry.swarm record appeared in the DHT"
            r = subprocess.run(
                [
                    *_module("tools.lah_top"),
                    "--once", "--prefix", "swarm", "--initial-peers",
                    f"{bootstrap.endpoint[0]}:{bootstrap.endpoint[1]}",
                ],
                capture_output=True, text=True, timeout=60, cwd=REPO,
            )
            assert r.returncode == 0, (
                f"lah_top --once failed rc={r.returncode}:\n"
                f"{r.stdout[-500:]}\n{r.stderr[-1000:]}"
            )
            assert "server-" in r.stdout and "tel.0" in r.stdout, (
                f"lah_top did not render the discovered server:\n{r.stdout}"
            )
            where = _where(srv)
    finally:
        reset_client_rpc()
        dht.shutdown()
        bootstrap.shutdown()
    print(f"telemetry: expert on {where}")
    print("TELEMETRY_SMOKE_OK lah_top=dht-discovered")
    return 0


def gateway_smoke(device: str) -> int:
    """Gateway gate: two subprocess expert servers (on ``device``) + one
    in-process serving gateway (its decoder on ``device``), ~8 concurrent
    streams driven open-loop by ``experiments.loadgen``.  Every accepted
    stream must finish (zero sheds, zero errors, zero client crashes at
    this far-below-saturation rate) and the coalescer must have grouped
    overlapping expert sets: the number of pack-once dispatches actually
    fired must be STRICTLY less than the per-stream dispatch count an
    ungrouped gateway would have issued (fired + coalesced-away).

    A shared-prefix phase follows against the same (warm) gateway: every
    prompt opens with one fixed 16-token prefix spanning two KV pages, so
    the content-addressed prefix cache MUST report hits."""
    from learning_at_home_tpu_torch import random as jrandom
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.routing import StaticExpertSource
    from learning_at_home_tpu_torch.experiments.loadgen import run_load
    from learning_at_home_tpu_torch.gateway import Gateway
    from learning_at_home_tpu_torch.models.transformer_swarm import (
        SwarmDMoETransformerLM,
        SwarmTransformerConfig,
    )
    from learning_at_home_tpu_torch.utils.subproc import (
        shutdown_procs,
        spawn_expert_servers,
    )

    try:
        procs, ports = spawn_expert_servers(
            REPO, "gws", (0.0, 0.0), d_model=16, num_experts=2,
            extra_args=("--device", device),
        )
    except Exception as e:
        print(f"collect_gate: gateway smoke setup failed: {e}",
              file=sys.stderr)
        return 1
    try:
        source = StaticExpertSource({
            f"gws{layer}.{e}": ("127.0.0.1", ports[layer])
            for layer in range(2) for e in range(2)
        })
        cfg = SwarmTransformerConfig(
            vocab_size=64, d_model=16, n_layers=2, n_heads=4, seq_len=32,
            grid_size=(2,), k_best=2, k_min=2, uid_prefix="gws",
            timeout_after_k_min=30.0, forward_timeout=60.0,
            backward_timeout=60.0, wire_codec="none",
            routing_cost_weight=0,
        )
        model = SwarmDMoETransformerLM(cfg, source)
        params = model.init_params(jrandom.PRNGKey(0), device=device)
        with Gateway(
            model, params, max_slots=8, coalesce=True, page_len=8,
            device=device,
        ) as gw:
            rep = run_load(
                gw.endpoint, rate_hz=40.0, duration_s=0.2,
                prompt_len=(6, 6), max_new=(8, 8), vocab=64, seed=0,
            )
            co = gw.coalescer.stats()
            # shared-prefix phase on the SAME warm gateway: two runs with
            # one seed share one 16-token prefix (= 2 full 8-token
            # pages); the first registers the pages, the second must hit
            prep = None
            for _round in range(2):
                prep = run_load(
                    gw.endpoint, rate_hz=20.0, duration_s=0.2,
                    prompt_len=(20, 20), max_new=(4, 6), vocab=64,
                    seed=1, prefix_share=1.0, prefix_len=16,
                )
                assert prep["completed"] == prep["arrivals"], (
                    f"dropped shared-prefix streams: {prep}"
                )
                assert prep["shed"] == prep["errors"] == 0, prep
            hits = gw.decoder.kv.prefix_hits_total
            hit_tokens = gw.decoder.kv.prefix_hit_tokens_total
        peaks = _peak_bytes([("127.0.0.1", p) for p in ports])
        assert rep["arrivals"] >= 4, f"loadgen produced too few: {rep}"
        assert rep["completed"] == rep["arrivals"], f"dropped streams: {rep}"
        assert rep["shed"] == rep["errors"] == rep["crashes"] == 0, rep
        assert hits > 0, (
            "shared-prefix load produced no prefix-cache hits "
            f"(prefix_hits_total={hits})"
        )
        fired = co["group_dispatches_total"]
        per_stream = fired + co["coalesced_dispatches_total"]
        assert fired < per_stream, (
            f"coalescer never grouped: fired {fired} == per-stream "
            f"{per_stream}"
        )
        print(
            f"gateway: {rep['completed']} streams, {rep['tokens_served']} "
            f"tokens, dispatches fired {fired} vs per-stream {per_stream}, "
            f"prefix hits {hits} ({hit_tokens} tokens skipped)"
        )
        print(f"gateway: decoder on {params['embed'].device}, the expert "
              f"servers' card peak bytes (stats) {peaks}")
    finally:
        shutdown_procs(procs)
        reset_client_rpc()
    print("GATEWAY_SMOKE_OK coalesce=expert-set prefix=content-addressed")
    return 0


def slo_trace_smoke(device: str) -> int:
    """SLO + stream-trace gate: loadgen against an in-process gateway
    (decoder and experts on ``device``) whose TTFT objective is
    INTENTIONALLY impossible (1 µs), so every stream is a bad event and
    the burn-rate evaluator must walk to PAGE on both windows — and
    entering PAGE must write a parseable flight artifact.  The same run
    submits one traced stream and asserts trace continuity: the id
    echoes through gen_submit/gen_poll and every gateway lifecycle span
    nests inside the stream umbrella."""
    import tempfile
    import time as _time

    from learning_at_home_tpu_torch import random as jrandom
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.routing import StaticExpertSource
    from learning_at_home_tpu_torch.experiments.loadgen import (
        check_floors,
        run_load,
    )
    from learning_at_home_tpu_torch.gateway import Gateway, GatewayClient
    from learning_at_home_tpu_torch.models.transformer_swarm import (
        SwarmDMoETransformerLM,
        SwarmTransformerConfig,
    )
    from learning_at_home_tpu_torch.server.server import background_server
    from learning_at_home_tpu_torch.utils import flight
    from learning_at_home_tpu_torch.utils.profiling import (
        new_trace_id,
        timeline,
    )

    tmpdir = tempfile.mkdtemp(prefix="lah_slo_trace_smoke_")
    knobs = {
        "LAH_TTFT_SLO_S": "0.000001",  # nothing serves a 1 µs TTFT
        "LAH_TTFT_SLO_OBJECTIVE": "0.99",
        "LAH_SLO_FAST_S": "1.0",
        "LAH_SLO_SLOW_S": "5.0",
        "LAH_FLIGHT_DIR": tmpdir,
    }
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    was_profiling = timeline.enabled
    timeline.enable()
    timeline.clear()
    flight.recorder.clear()  # fresh rings + dump throttle
    uids = [f"slt{layer}.{e}" for layer in range(2) for e in range(2)]
    try:
        with background_server(
            expert_uids=uids, hidden_dim=16, seed=0, device=device
        ) as (endpoint, srv):
            source = StaticExpertSource({u: endpoint for u in uids})
            cfg = SwarmTransformerConfig(
                vocab_size=64, d_model=16, n_layers=2, n_heads=4,
                seq_len=32, grid_size=(2,), k_best=2, k_min=2,
                uid_prefix="slt", timeout_after_k_min=30.0,
                forward_timeout=60.0, backward_timeout=60.0,
                wire_codec="none", routing_cost_weight=0,
            )
            model = SwarmDMoETransformerLM(cfg, source)
            params = model.init_params(jrandom.PRNGKey(0), device=device)
            with Gateway(
                model, params, max_slots=8, coalesce=True, page_len=8,
                device=device,
            ) as gw:
                rep = run_load(
                    gw.endpoint, rate_hz=30.0, duration_s=0.2,
                    prompt_len=(6, 6), max_new=(6, 6), vocab=64, seed=0,
                )
                # the re-expressed loadgen floors: one evaluator for
                # every "is this report healthy" question
                violations = check_floors(rep, min_completed=2)
                assert not violations, violations
                # one traced stream end to end
                client = GatewayClient(gw.endpoint)
                tid = new_trace_id()
                sub = client.submit([1, 2, 3, 4], 6, trace=tid)
                assert sub.get("accepted") and sub.get("trace") == tid, sub
                deadline = _time.monotonic() + 60.0
                while _time.monotonic() < deadline:
                    out = client.poll(sub["sid"])
                    if out.get("done"):
                        break
                    _time.sleep(0.01)
                assert out.get("done") and out.get("trace") == tid, out
                # every stream blew the 1 µs objective → PAGE, and the
                # exported series agree
                status = gw.slo.evaluate()["gateway_ttft"]
                assert status["state"] == "page", status
                assert status["bad_total"] >= rep["completed"]
                series = gw.slo.collect()
                # lah-lint: ignore[R9] the catalog's per-objective
                # series lah_slo_<name>_state, for the gateway_ttft
                # objective (OBSERVABILITY.md, SLO engine)
                assert series["lah_slo_gateway_ttft_state"] == 2.0
            where = _where(srv)
        # PAGE entry dumped a parseable flight artifact
        arts = [f for f in os.listdir(tmpdir) if f.endswith(".json")]
        assert len(arts) == 1 and "slo_page_gateway_ttft" in arts[0], arts
        with open(os.path.join(tmpdir, arts[0]), encoding="utf-8") as fh:
            doc = json.load(fh)
        assert doc["reason"] == "slo_page_gateway_ttft"
        hops = [
            e for e in doc["components"].get("gateway", [])
            if e["kind"] == "slo_state_change" and e["state"] == "page"
        ]
        assert hops, f"no page transition in artifact: {doc['components']}"
        # trace continuity + nesting: the umbrella contains every
        # gateway lifecycle span of the traced stream
        spans = [s for s in timeline.spans() if s[3] == tid]
        names = {s[0] for s in spans}
        for needed in (
            "gateway.admit", "gateway.pending.wait", "gateway.slot.assign",
            "gateway.token.first", "gateway.stream",
        ):
            assert needed in names, (needed, names)
        (umbrella,) = [s for s in spans if s[0] == "gateway.stream"]
        _, u_start, u_dur, _, _ = umbrella
        for name, start, dur, _, _ in spans:
            if name.startswith("gateway."):
                assert start >= u_start - 0.05, name
                assert start + dur <= u_start + u_dur + 0.05, name
        print(
            f"slo_trace: {rep['completed']} streams all past the 1 µs "
            f"objective, fast_burn={status['fast_burn']:.0f}, "
            f"artifact={arts[0]}, {len(spans)} spans on trace {tid} "
            f"(decoder on {params['embed'].device}, experts on {where})"
        )
    finally:
        reset_client_rpc()
        if not was_profiling:
            timeline.disable()
        timeline.clear()
        flight.recorder.clear()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print("SLO_TRACE_SMOKE_OK page=burn-rate trace=stream-lifecycle")
    return 0


# the twelve smokes in the order the child runs them, each with the
# marker line it prints when it passed
SMOKES = (
    ("SMOKE_OK", client_path_smoke),
    ("AVG_SMOKE_OK", averaging_smoke),
    ("CODEC_SMOKE_OK", codec_smoke),
    ("TELEMETRY_SMOKE_OK", telemetry_smoke),
    ("REPLICA_SMOKE_OK", replication_smoke),
    ("OVERLAP_SMOKE_OK", overlap_smoke),
    ("LIFECYCLE_SMOKE_OK", lifecycle_smoke),
    ("DHT_SMOKE_OK", dht_smoke),
    ("MACRO_SIM_OK", macro_sim_smoke),
    ("SLO_SMOKE_OK", slo_smoke),
    ("GATEWAY_SMOKE_OK", gateway_smoke),
    ("SLO_TRACE_SMOKE_OK", slo_trace_smoke),
)


def smoke_worker(device: str) -> int:
    """The child: every smoke in order, each independently runnable, the
    first failure's exit code returned (so it is attributed to the
    right one)."""
    for _marker, smoke in SMOKES:
        rc = smoke(device)
        if rc:
            return rc
    return 0


def run_smoke(device: str) -> int:
    """The smokes in a child process; fails with the child's exit code,
    or 1 when its output lacks a marker line."""
    try:
        r = subprocess.run(
            [*_module("tools.collect_gate"), "--smoke-worker",
             "--device", device],
            cwd=REPO, capture_output=True, text=True,
            # twelve smokes: a wider bound than the gate's
            timeout=int(os.environ.get("COLLECT_GATE_SMOKE_TIMEOUT_S", "1200")),
        )
    except subprocess.TimeoutExpired:
        print("collect_gate: client-path smoke timed out", file=sys.stderr)
        return 2
    lines = r.stdout.splitlines()
    missing = [m for m, _ in SMOKES
               if not any(ln.startswith(m + " ") for ln in lines)]
    if r.returncode != 0 or missing:
        print("collect_gate: FAIL — client-path/averaging/telemetry smoke:",
              file=sys.stderr)
        print(r.stdout[-1000:], file=sys.stderr)
        print(r.stderr[-2000:], file=sys.stderr)
        return r.returncode or 1
    print(f"collect_gate: OK — {r.stdout.strip().splitlines()[-1]}")
    return 0


def resolve(device):
    """``device`` as a string, the CUDA card when None; None (after
    saying why) when there is no card to default to."""
    import torch

    if device is None and not torch.cuda.is_available():
        print("collect_gate: no CUDA device is available: pass --device "
              "cpu to run the gate on the CPU", file=sys.stderr)
        return None
    return "cuda" if device is None else device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for flag, what in (("--lint", "the lint stage only"),
                       ("--verify", "up to the verify stage"),
                       ("--schema", "up to the schema stage"),
                       ("--placement", "up to the placement stage"),
                       ("--no-smoke", "every stage but the smokes"),
                       ("--smoke-worker", "the smokes' child mode")):
        p.add_argument(flag, action="store_true", help=what)
    p.add_argument("--device", default=None,
                   help="where expert servers, the gateway's decoder and "
                        "the swarm models sit (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve(args.device)
    if device is None:
        return NO_DEVICE_RC
    if args.smoke_worker:
        return smoke_worker(device)
    rc = lint_stage()  # stage 0: static invariants, cheapest first
    if rc:
        return rc
    if args.lint:
        return 0
    rc = verify_stage()  # stage 0.5: interleaving exploration, seconds
    if rc:
        return rc
    if args.verify:
        return 0
    rc = schema_stage(device)  # stage 0.7: wire conformance + hostile fuzz
    if rc:
        return rc
    if args.schema:
        return 0
    rc = placement_stage()  # stage 0.8: placement-plan determinism
    if rc:
        return rc
    if args.placement:
        return 0
    rc = orphan_guard()  # BEFORE any timing work (smokes spawn servers)
    if rc:
        return rc
    rc = collection_stage()
    if rc:
        return rc
    if not args.no_smoke:
        return run_smoke(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
