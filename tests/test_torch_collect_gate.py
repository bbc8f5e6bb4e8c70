"""The port's pre-test gate (``learning_at_home_tpu_torch/tools/
collect_gate.py``) against the JAX repo's ``tools/collect_gate.py``, on
the CPU: stages 0-0.8 (lint, verify, schema, placement).

Each stage function of both gates runs on the same seeded failure, and
their exit codes and verdict lines must be equal: the lint stage over a
tree holding one known finding of ``tests/lint_corpus/``; the verify and
schema stages with their tool's subprocess replaced by one canned
``CompletedProcess`` (a failure, a timeout and a pass), patched in each
gate module alone; the placement stage on a fixture whose plan has no
moves, on two runs whose bytes differ and on a plan that does not lower
the cost.  Then the real stages: the port gate's lint run over the port
and its placement stage, which prints the JAX gate's lines byte for
byte (3 moves, 215.375 -> 47.415; 2 moves, 70.0 -> 0.0).
"""

import importlib
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from learning_at_home_tpu_torch.tools import collect_gate as port_gate
from torch_gate_harness import canned, captured

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jax_gate = importlib.import_module("tools.collect_gate")
GATES = {"jax": jax_gate, "port": port_gate}
PKG = {"jax": "learning_at_home_tpu", "port": "learning_at_home_tpu_torch"}


def verdict(gate: str, stage: str, capsys, seconds: float = 120.0):
    """Run one stage of one gate; (exit code, stdout lines, stderr
    lines)."""
    fn = getattr(GATES[gate], stage)
    args = ("cpu",) if gate == "port" and stage == "schema_stage" else ()
    return captured(capsys, fn, *args, seconds=seconds)


@pytest.fixture(scope="module", autouse=True)
def _one_coverage_report_a_package():
    """Each schema module's ``coverage_report`` computed once per package
    and kept for the module's other schema-stage runs (an AST pass over
    the whole package, seconds a call)."""
    from learning_at_home_tpu.analysis import schema as jax_schema
    from learning_at_home_tpu_torch.analysis import schema as port_schema

    patch = pytest.MonkeyPatch()
    for module in (jax_schema, port_schema):
        report, memo = module.coverage_report, {}

        def kept(paths, doc_ops, report=report, memo=memo):
            key = tuple(paths)
            if key not in memo:
                memo[key] = report(paths, doc_ops)
            return memo[key]

        patch.setattr(module, "coverage_report", kept)
    yield
    patch.undo()


# ---- stage 0: lint ----


def test_real_lint_stage_over_the_port_is_clean():
    """``--lint --device cpu`` through the CLI: the port lints clean."""
    r = subprocess.run(
        [sys.executable, "-m", "learning_at_home_tpu_torch.tools."
         "collect_gate", "--lint", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and not r.stderr, r.stderr
    assert re.fullmatch(r"collect_gate: lint OK — 0 findings, \d+ baselined",
                        r.stdout.strip()), r.stdout


@pytest.mark.parametrize("snippet", ["r1_bad.py", "r6_bad.py"])
def test_lint_stage_fails_on_a_corpus_finding_as_the_jax_gate(
        snippet, tmp_path, monkeypatch, capsys):
    got = {}
    monkeypatch.setattr(sys, "path", list(sys.path))  # the JAX stage's insert
    for gate in GATES:
        root = tmp_path / gate
        (root / PKG[gate]).mkdir(parents=True)
        shutil.copy(os.path.join(REPO, "tests", "lint_corpus", snippet),
                    root / PKG[gate] / snippet)
        monkeypatch.setattr(GATES[gate], "REPO", str(root))
        rc, out, err = verdict(gate, "lint_stage", capsys)
        # the findings name the tree linted: compare them without it
        got[gate] = (rc, out, [line.replace(str(root), "<tree>").replace(
            PKG["port"], PKG["jax"]) for line in err])
    assert got["port"] == got["jax"]
    rc, out, err = got["port"]
    assert rc == 5 and not out
    assert err[0].startswith("collect_gate: FAIL — lint findings")
    assert any(f"<tree>/{PKG['jax']}/{snippet}" in line for line in err[1:])


# ---- stages 0.5 and 0.7: verify and schema, their tool canned ----

CANNED = {
    "fails": [(1, "lah-verify: FOUND stale-prefill\n"
                  "lah-verify: 1 violation(s) across 17 invariant(s)\n",
               "Traceback: the explorer's report\n")],
    "times out": [subprocess.TimeoutExpired(["tool"], 120)],
    "passes": [(0, "frames\nlah-tool: OK — the last line\n", "")],
}


@pytest.mark.parametrize("case", list(CANNED))
@pytest.mark.parametrize("stage", ["verify_stage", "schema_stage"])
def test_tool_stage_verdicts_are_the_jax_gates(stage, case, monkeypatch,
                                               capsys):
    got = {}
    for gate in GATES:
        canned(monkeypatch, GATES[gate], CANNED[case])
        got[gate] = verdict(gate, stage, capsys)
    assert got["port"] == got["jax"]
    rc, out, err = got["port"]
    want_rc = {"verify_stage": 6, "schema_stage": 7}[stage]
    if case == "passes":
        assert rc == 0 and out[-1].endswith("lah-tool: OK — the last line")
        if stage == "schema_stage":
            assert "19 documented ops covered" in out[-1]
    elif case == "fails":
        assert rc == want_rc and err[0].startswith("collect_gate: FAIL — ")
        assert "lah-verify: 1 violation(s) across 17 invariant(s)" in err
    else:
        assert rc == want_rc and err == [
            f"collect_gate: {'lah_verify' if stage == 'verify_stage' else 'lah_fuzz'}"
            " timed out"]


def test_tool_stages_run_the_port_tools(monkeypatch, capsys):
    """The commands the port gate's verify and schema stages start: the
    port's tools as modules, the fuzz hosts on the gate's device."""
    seen = []

    def run(cmd, **kwargs):
        seen.append((cmd[1:], kwargs["env"].get("LAH_SANITIZE")))
        return subprocess.CompletedProcess(cmd, 0, "ok\n", "")

    monkeypatch.setattr(port_gate, "subprocess", types.SimpleNamespace(
        run=run, TimeoutExpired=subprocess.TimeoutExpired))
    assert port_gate.verify_stage() == 0
    assert port_gate.schema_stage("cuda:1") == 0
    assert seen == [
        (["-m", "learning_at_home_tpu_torch.tools.lah_verify", "--smoke"],
         os.environ.get("LAH_SANITIZE", "1")),
        (["-m", "learning_at_home_tpu_torch.tools.lah_fuzz", "--smoke",
          "--device", "cuda:1"], os.environ.get("LAH_SANITIZE", "1")),
    ]


# ---- stage 0.8: placement ----


def test_real_placement_stage_prints_the_jax_gates_lines(capsys):
    got = {gate: verdict(gate, "placement_stage", capsys) for gate in GATES}
    assert got["port"] == got["jax"]
    assert got["port"] == (0, [
        "collect_gate: placement OK (skewed) — byte-identical plan, 3 "
        "move(s), cost 215.375 -> 47.415",
        "collect_gate: placement OK (capacity-locked swap) — byte-identical "
        "plan, 2 move(s), cost 70.0 -> 0.0"], [])


NO_MOVES = {"experts": {"a.0": "10.0.0.1:31330", "a.1": "10.0.0.1:31330"},
            "coact": {"a.0|a.1": 500}, "bytes_per_dispatch": 1.5e6}
PLAN = '{"cost_after":1.0,"cost_before":2.0,"moves":[["a.0","x"]],"seed":0}\n'


@pytest.mark.parametrize("case", [
    "no moves", "bytes differ", "no gain", "non-JSON", "tool fails",
    "times out"])
def test_placement_failures_are_the_jax_gates(case, monkeypatch, capsys):
    got = {}
    for gate in GATES:
        if case == "no moves":
            monkeypatch.setattr(GATES[gate], "_PLACEMENT_FIXTURE", NO_MOVES)
        else:
            canned(monkeypatch, GATES[gate], {
                "bytes differ": [(0, PLAN, ""), (0, PLAN + " ", "")],
                "no gain": [(0, PLAN.replace("2.0", "1.0"), "")] * 2,
                "non-JSON": [(0, "plan:\n", "")] * 2,
                "tool fails": [(2, "", "usage: lah_rebalance\n")],
                "times out": [subprocess.TimeoutExpired(["tool"], 60)],
            }[case])
        got[gate] = verdict(gate, "placement_stage", capsys)
    assert got["port"] == got["jax"]
    rc, out, err = got["port"]
    assert rc == 8 and not out
    assert {
        "no moves": "collect_gate: FAIL — solver found no moves on the "
                    "skewed fixture (must consolidate the split clusters)",
        "bytes differ": "collect_gate: FAIL — placement plans (skewed) for "
                        "one (snapshot, seed) differ between runs:",
        "no gain": "collect_gate: FAIL — plan (skewed) does not improve "
                   "cost (1.0 -> 1.0)",
        "non-JSON": "collect_gate: FAIL — --plan (skewed) printed non-JSON:",
        "tool fails": "collect_gate: FAIL — lah_rebalance --plan (skewed):",
        "times out": "collect_gate: lah_rebalance --plan (skewed) timed out",
    }[case] == err[0]
