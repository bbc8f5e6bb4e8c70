"""The port's pre-test gate against the JAX repo's on the CPU: the orphan
guard, the collection stage, the smokes' parent (``run_smoke``), the
stage order of ``main`` and the device it requires.

- orphan guard: a faked orphan list (and the scan raising), with and
  without ``LAH_IGNORE_ORPHANS``: the JAX gate's exit code and lines;
- collection: a temporary tree whose one test file fails to import, and
  one that collects; then the port's torch-only branch (the branch a
  machine without flax takes): its files, found by an AST scan,
  collect under ``--noconftest`` with ``jax`` made unimportable;
- ``run_smoke``: canned child output holding all twelve markers, each of
  them missing in turn, a failing child and a timeout;
- ``main``: which stages each flag runs, in which order, and that a
  failing stage ends the run with its exit code; without a card and
  without ``--device cpu`` the port gate refuses before any stage.
"""

import ast
import importlib
import importlib.util
import inspect
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from learning_at_home_tpu.utils import subproc as jax_subproc
from learning_at_home_tpu_torch.tools import collect_gate as port_gate
from learning_at_home_tpu_torch.utils import subproc as port_subproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jax_gate = importlib.import_module("tools.collect_gate")
GATES = {"jax": jax_gate, "port": port_gate}
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_imports import forbidden, imported_modules  # noqa: E402
from torch_gate_harness import canned, captured  # noqa: E402


# ---- the orphan guard ----

ORPHANS = [(4242, 812.5, "python -m <pkg>.server --expert-prefix ffn0")]


@pytest.mark.parametrize("case", ["clean", "orphan", "orphan, ignored",
                                  "scan fails"])
def test_orphan_guard_is_the_jax_gates(case, monkeypatch, capsys):
    if case == "orphan, ignored":
        monkeypatch.setenv("LAH_IGNORE_ORPHANS", "1")
    else:
        monkeypatch.delenv("LAH_IGNORE_ORPHANS", raising=False)

    def scan():
        if case == "scan fails":
            raise OSError("no /proc here")
        return [] if case == "clean" else ORPHANS

    got = {}
    for gate, module in (("jax", jax_subproc), ("port", port_subproc)):
        monkeypatch.setattr(module, "find_orphan_servers", scan)
        got[gate] = captured(capsys, GATES[gate].orphan_guard)
    assert got["port"] == got["jax"]
    rc, out, err = got["port"]
    assert rc == {"orphan": 4}.get(case, 0) and not out
    if case.startswith("orphan"):
        assert err[0] == ("collect_gate: ORPHAN server pid=4242 age=812.5s: "
                          "python -m <pkg>.server --expert-prefix ffn0")


# ---- collection ----


def _skip_to_collection(monkeypatch):
    """Every stage before the collection passes without running."""
    for gate, module in GATES.items():
        for stage in ("lint_stage", "verify_stage", "schema_stage",
                      "placement_stage", "orphan_guard"):
            monkeypatch.setattr(module, stage, lambda *a: 0)


def _run_main(gate: str, flags: list, monkeypatch, capsys):
    if gate == "jax":
        monkeypatch.setattr(sys, "argv", ["collect_gate.py", *flags])
        return captured(capsys, jax_gate.main)
    return captured(capsys, port_gate.main, [*flags, "--device", "cpu"])


@pytest.mark.parametrize("broken", [True, False], ids=["broken", "clean"])
def test_collection_verdict_is_the_jax_gates(broken, tmp_path, monkeypatch,
                                             capsys):
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_fine.py").write_text("def test_fine():\n    pass\n")
    if broken:
        (tests / "test_torch_broken.py").write_text(
            "import a_module_that_is_nowhere  # noqa: F401\n")
    _skip_to_collection(monkeypatch)
    got = {}
    for gate, module in GATES.items():
        monkeypatch.setattr(module, "REPO", str(tmp_path))
        rc, out, err = _run_main(gate, ["--no-smoke"], monkeypatch, capsys)
        got[gate] = (rc, [re.sub(r" in [0-9.]+s", "", line) for line in out],
                     err[:1], "test_torch_broken.py" in "\n".join(err))
    assert got["port"] == got["jax"]
    if broken:
        assert got["port"] == (
            2, [], ["collect_gate: FAIL — collection errors:"], True)
    else:
        assert got["port"] == (0, ["collect_gate: OK — 1 test collected"],
                               [], False)


def test_the_reference_counts_as_missing_without_any_of_its_imports(
        monkeypatch):
    assert port_gate.missing_reference() == []  # the tests' interpreter has all three
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "flax"
                        else real(name, *a))
    assert port_gate.missing_reference() == ["flax"]


def test_torch_only_files_are_the_import_scans():
    """The gate's AST scan keeps the port test files that import nothing
    of JAX or the JAX package (the scan of ``test_torch_imports.py``) and
    nothing of the JAX repo's scripts (``tools``, ``experiments``)."""
    files = sorted(f for f in os.listdir(os.path.join(REPO, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    for name in files:
        with open(os.path.join(REPO, "tests", name)) as fh:
            mods = [m for m in imported_modules(fh.read()) if m]
        jax_side = any(forbidden(m) or m.split(".")[0] in (
            "tools", "experiments", "bench", "__graft_entry__")
            for m in mods)
        # a test module beside it that it imports counts as its own
        jax_side |= any(
            os.path.exists(os.path.join(REPO, "tests", m + ".py"))
            and not port_gate.torch_only(os.path.join(REPO, "tests",
                                                      m + ".py"))
            for m in mods)
        assert port_gate.torch_only(
            os.path.join(REPO, "tests", name)) == (not jax_side), name
    for name in ("test_torch_imports.py", "test_torch_kernel_build.py",
                 "test_torch_parallel_cuda.py"):
        assert port_gate.torch_only(os.path.join(REPO, "tests", name))
    for name in ("test_torch_collect_gate.py",
                 "test_torch_collect_gate_smokes.py",
                 "test_torch_collect_gate_swarm.py"):
        assert not port_gate.torch_only(os.path.join(REPO, "tests", name))


def test_torch_only_branch_collects_without_jax(capsys):
    """The branch a machine without the JAX package's imports takes (flax
    missing): the port gate collects the torch-only files under
    ``--noconftest``; and those files collect in an interpreter where
    ``jax``, its libraries and the JAX package do not import."""
    rc, out, err = captured(capsys, port_gate.collection_stage, ["flax"])
    n_files = len([f for f in os.listdir(os.path.join(REPO, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py")])
    kept = [os.path.join("tests", f) for f in sorted(os.listdir(
        os.path.join(REPO, "tests"))) if f.startswith("test_torch_")
        and f.endswith(".py") and port_gate.torch_only(
            os.path.join(REPO, "tests", f))]
    assert rc == 0, err
    assert out[0] == (
        f"collect_gate: no flax here — collecting {len(kept)} "
        f"of {n_files} port test files under --noconftest; "
        f"{n_files - len(kept)} import jax or the JAX package")
    assert re.fullmatch(r"collect_gate: OK — \d+ tests collected in .*s",
                        out[-1]), out
    blocked = (
        "import sys\n"
        "for name in [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'learning_at_home_tpu')]:\n"
        "    del sys.modules[name]\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', "
        "'learning_at_home_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import pytest\n"
        "sys.exit(pytest.main(sys.argv[1:]))\n")
    r = subprocess.run(
        [sys.executable, "-c", blocked, *kept, "-q", "--collect-only",
         "--noconftest", "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert out[-1].split(" — ")[1].split(" in ")[0] in r.stdout


# ---- the smokes' parent ----

CHILD = [
    "SMOKE_OK protocols=v1,v2",
    "AVG_SMOKE_OK rounds=1",
    "codec u8: bytes /4.00, grad_cosine 0.99980",
    "codec blockq8: bytes /3.87, grad_cosine 0.99975",
    "CODEC_SMOKE_OK codecs=u8,blockq8",
    "TELEMETRY_SMOKE_OK lah_top=dht-discovered",
    "replication: replica_set=2 hedge_wins=1 fires=1 dropped=0",
    "REPLICA_SMOKE_OK hedge=first-reply-wins",
    "overlap step p50: serial 248.4 ms, overlapped 176.5 ms (0.711), "
    "overlap_fraction 1.000",
    "OVERLAP_SMOKE_OK schedule=fire/join",
    "lifecycle: drained=2 experts migrated bitwise, failed_dispatches=0 "
    "dropped=0",
    "LIFECYCLE_SMOKE_OK migration=bitwise",
    "DHT_SMOKE_OK nodes=200 hit_rate=1.0 store_reduction=6.83x "
    "join_mean_ms=19.6",
    "MACRO_SIM_OK nodes=200 arrivals=1779 shed_fraction=0.5385",
    "slo: throughput_ratio=0.98 p99=83.6ms kills={'graceful': 1, 'hard': 1} "
    "graceful_failures=0",
    "SLO_SMOKE_OK profile=fast",
    "gateway: 15 streams, 120 tokens, dispatches fired 64 vs per-stream "
    "242, prefix hits 5 (80 tokens skipped)",
    "GATEWAY_SMOKE_OK coalesce=expert-set prefix=content-addressed",
    "slo_trace: 9 streams all past the 1 µs objective",
    "SLO_TRACE_SMOKE_OK page=burn-rate trace=stream-lifecycle",
]
MARKERS = [m for m, _ in port_gate.SMOKES]


def test_the_smokes_are_the_jax_gates_in_its_order():
    """The port child runs the JAX child's twelve smokes in its order,
    each printing the JAX marker."""
    body = ast.parse(inspect.getsource(jax_gate.smoke_worker)).body[0]
    jax_order = ["client_path_smoke"] + [
        node.func.id for node in ast.walk(body)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id.endswith("_smoke")]
    assert [fn.__name__ for _, fn in port_gate.SMOKES] == jax_order
    assert MARKERS == [line.split()[0] for line in CHILD
                       if line.split()[0].endswith("_OK")]
    run_smoke = inspect.getsource(jax_gate.run_smoke)
    for marker in MARKERS:
        assert f'"{marker}" not in r.stdout' in run_smoke


@pytest.mark.parametrize("missing", [None, *MARKERS])
def test_run_smoke_verdicts_and_each_missing_marker(missing, monkeypatch,
                                                    capsys):
    stdout = "".join(line + "\n" for line in CHILD
                     if line.split()[0] != missing)
    got = {}
    for gate in GATES:
        seen = []
        canned(monkeypatch, GATES[gate], [(0, stdout, "child's log\n")],
               seen)
        got[gate] = captured(capsys, GATES[gate].run_smoke,
                             *(("cpu",) if gate == "port" else ()))
    rc, out, err = got["port"]
    if missing is None:
        assert got["port"] == got["jax"]
        assert (rc, out, err) == (0, [
            "collect_gate: OK — SLO_TRACE_SMOKE_OK page=burn-rate "
            "trace=stream-lifecycle"], [])
        assert seen[0][1:] == ["-m", "learning_at_home_tpu_torch.tools."
                               "collect_gate", "--smoke-worker", "--device",
                               "cpu"]
        return
    assert rc == 1 and not out
    assert err[0] == ("collect_gate: FAIL — client-path/averaging/"
                      "telemetry smoke:")
    if missing == "SMOKE_OK":
        # the JAX gate's test is a substring one, and every other marker
        # holds "SMOKE_OK": it passes a child whose client-path smoke
        # never printed; the port gate's marker lines are whole words
        assert got["jax"][0] == 0
    else:
        assert got["port"] == got["jax"]


@pytest.mark.parametrize("case", ["child fails", "times out"])
def test_run_smoke_failures_are_the_jax_gates(case, monkeypatch, capsys):
    reply = {"child fails": (3, "\n".join(CHILD[:5]) + "\n", "Traceback\n"),
             "times out": subprocess.TimeoutExpired(["child"], 1200)}[case]
    got = {}
    for gate in GATES:
        canned(monkeypatch, GATES[gate], [reply])
        got[gate] = captured(capsys, GATES[gate].run_smoke,
                             *(("cpu",) if gate == "port" else ()))
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"child fails": 3, "times out": 2}[case]


# ---- main: stage order, flags, the device ----

FLAGS = {
    (): ["lint", "verify", "schema", "placement", "orphan", "collect",
         "smoke"],
    ("--lint",): ["lint"],
    ("--verify",): ["lint", "verify"],
    ("--schema",): ["lint", "verify", "schema"],
    ("--placement",): ["lint", "verify", "schema", "placement"],
    ("--no-smoke",): ["lint", "verify", "schema", "placement", "orphan",
                      "collect"],
}


def _record_stages(monkeypatch, fail: str = None) -> dict:
    """Replace every stage of both gates by a recorder (``fail`` returns
    9); the JAX gate's inline collection is its canned ``pytest``."""
    calls = {"jax": [], "port": []}
    names = {"lint_stage": "lint", "verify_stage": "verify",
             "schema_stage": "schema", "placement_stage": "placement",
             "orphan_guard": "orphan", "run_smoke": "smoke",
             "collection_stage": "collect"}
    for gate, module in GATES.items():
        for attr, name in names.items():
            if hasattr(module, attr):
                def stage(*a, gate=gate, name=name):
                    calls[gate].append(name)
                    return 9 if name == fail else 0
                monkeypatch.setattr(module, attr, stage)

    def jax_collect(cmd, **kwargs):
        calls["jax"].append("collect")
        return subprocess.CompletedProcess(
            cmd, 9 if fail == "collect" else 0, "1 test collected\n", "")

    monkeypatch.setattr(jax_gate, "subprocess", types.SimpleNamespace(
        run=jax_collect, TimeoutExpired=subprocess.TimeoutExpired))
    return calls


@pytest.mark.parametrize("flags", list(FLAGS), ids=lambda f: " ".join(f)
                         or "all")
def test_main_runs_the_jax_gates_stages_in_order(flags, monkeypatch, capsys):
    calls = _record_stages(monkeypatch)
    rcs = {gate: _run_main(gate, list(flags), monkeypatch, capsys)[0]
           for gate in GATES}
    assert rcs == {"jax": 0, "port": 0}
    assert calls["port"] == calls["jax"] == FLAGS[flags]


@pytest.mark.parametrize("fail", FLAGS[()])
def test_a_failing_stage_ends_main_with_its_code(fail, monkeypatch, capsys):
    calls = _record_stages(monkeypatch, fail)
    rcs = {gate: _run_main(gate, [], monkeypatch, capsys)[0]
           for gate in GATES}
    assert rcs == {"jax": 9, "port": 9}
    assert calls["port"] == calls["jax"] == FLAGS[()][
        :FLAGS[()].index(fail) + 1]


def test_without_a_card_the_gate_refuses_and_says_why(monkeypatch, capsys):
    calls = _record_stages(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = captured(capsys, port_gate.main, ["--lint"])
    assert (rc, out, calls["port"]) == (port_gate.NO_DEVICE_RC, [], [])
    assert err == ["collect_gate: no CUDA device is available: pass "
                   "--device cpu to run the gate on the CPU"]


def test_the_cli_without_a_card_refuses_and_says_why():
    r = subprocess.run(
        [sys.executable, "-m", "learning_at_home_tpu_torch.tools."
         "collect_gate", "--lint"], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == port_gate.NO_DEVICE_RC and not r.stdout
    assert "no CUDA device is available" in r.stderr
