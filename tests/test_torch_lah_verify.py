"""The port's lah-verify (``learning_at_home_tpu_torch/analysis/verify.py``,
``tools/lah_verify.py``) against the JAX package's, on the CPU.

The explorer drives the port's real ``gateway/scheduler.py``,
``models/kv_pages.py`` (CPU pages) and ``server/lifecycle.py`` on the
port's virtual clock, with the port's sanitizer as the lock observer.
For each seed the report is the JAX explorer's world by world: schedules
run, schedules pruned (footprint pruning is on: the tests arm the
sanitizer), violations; both seeded scheduler races are re-found with the
JAX explorer's first failing op trace.  Then the sanitizer's quiesce and
KV audits trip as the JAX package's do (``tests/test_lah_verify.py``),
and the CLI keeps the JAX exit codes.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from learning_at_home_tpu.analysis import verify as jax_verify
from learning_at_home_tpu_torch.analysis import verify
from learning_at_home_tpu_torch.utils import sanitizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_invariants_are_the_jax_packages():
    rows = verify.collect_invariants()
    assert len(rows) == 17
    assert [(n, d) for n, d, _ in rows] == [
        (n, d) for n, d, _ in jax_verify.collect_invariants()]
    assert {m for _, _, m in rows} == {
        "learning_at_home_tpu_torch.gateway.scheduler",
        "learning_at_home_tpu_torch.models.kv_pages",
        "learning_at_home_tpu_torch.server.lifecycle"}


# at seed 1 (the default budget, pruning on) both explorers find the same
# mutual-preemption livelock in the merged tree's gateway world
VIOLATED = {0: [], 1: [("gateway", "preemption_livelock", 29)]}


@pytest.mark.parametrize("seed", [0, 1])
def test_run_all_report_is_the_jax_explorers(seed):
    got = verify.run_all(seed=seed)
    assert got == jax_verify.run_all(seed=seed)
    assert got["invariants_checked"] == 17
    assert [(v["world"], v["invariant"], v["schedule_index"])
            for v in got["violations"]] == VIOLATED[seed]
    assert [w["world"] for w in got["worlds"]] == [
        "gateway", "gateway", "gateway", "gateway-spec", "lifecycle",
        "migration", "handoff-receiver"]
    assert sum(w["schedules_pruned"] for w in got["worlds"]) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_races_are_refound_with_the_jax_traces(seed):
    got = verify.seeded_bug_validation(seed=seed)
    assert got == jax_verify.seeded_bug_validation(seed=seed)
    assert got["ok"] and got["deterministic"]
    assert got["stale_prefill_found"] and got["mutual_preemption_found"]


@pytest.mark.parametrize("bug", ["stale-prefill", "mutual-preemption"])
def test_first_failing_interleaving_is_the_jax_explorers(bug):
    got = verify.explore_gateway(max_schedules=200, seeded_bug=bug, seed=3)
    want = jax_verify.explore_gateway(max_schedules=200, seeded_bug=bug,
                                      seed=3)
    def first(r):  # stream ids are random hex: compare them masked
        v = r.violations[0]
        return (v.invariant, re.sub(r"s\d+-[0-9a-f]+", "s*", v.detail),
                v.trace, v.schedule_index)

    assert got.violations and want.violations
    assert first(got) == first(want)
    assert len(got.violations) == len(want.violations)


def test_virtual_clock_restored_after_exploration():
    from learning_at_home_tpu_torch.gateway import scheduler as sched_mod

    before = sched_mod._monotonic
    verify.explore_gateway(max_schedules=2)
    assert sched_mod._monotonic is before


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "learning_at_home_tpu_torch.tools.lah_verify",
         *args], capture_output=True, text=True, timeout=120, cwd=REPO)


def test_cli_smoke_json_and_exit_codes():
    r = _cli("--smoke", "--json")
    assert r.returncode == 0, r.stdout + r.stderr
    report = json.loads(r.stdout)
    assert report["clean"] and report["seeded_bugs"]["ok"]
    listing = _cli("--list-invariants")
    assert listing.returncode == 0
    assert "lah-verify: 17 machine-checked invariant(s)" in listing.stdout
    assert _cli("--no-such-flag").returncode == 2


# ---- quiesce-point and KV audits (as tests/test_lah_verify.py) ----


def test_quiesce_point_reports_registered_leaks():
    assert sanitizer.enabled()
    leaks_to_report = ["widget left open"]
    sanitizer.register_quiesce_audit(
        "test.quiesce.demo", lambda: list(leaks_to_report))
    try:
        with sanitizer.expect_violations("test.quiesce.demo") as seen:
            found = sanitizer.quiesce_point("test.quiesce.")
        assert found == ["test.quiesce.demo: widget left open"]
        assert [v["kind"] for v in seen] == ["quiesce"]
        leaks_to_report.clear()
        assert sanitizer.quiesce_point("test.quiesce.") == []
    finally:
        sanitizer.unregister_quiesce_audit("test.quiesce.demo")


def test_quiesce_point_audit_exception_is_a_finding():
    def broken():
        raise RuntimeError("audit infra died")

    sanitizer.register_quiesce_audit("test.quiesce.broken", broken)
    try:
        with sanitizer.expect_violations("test.quiesce.broken") as seen:
            found = sanitizer.quiesce_point("test.quiesce.broken")
        assert found and "audit raised RuntimeError" in found[0]
        assert seen
    finally:
        sanitizer.unregister_quiesce_audit("test.quiesce.broken")


def _scheduler(dec):
    from learning_at_home_tpu_torch.gateway.scheduler import SlotScheduler

    return SlotScheduler(dec, idle_wait_s=0.0, stream_ttl_s=1000.0,
                         prefill_chunk_tokens=2)


def test_scheduler_quiesce_audit_trips_on_leaked_slot():
    dec = verify._FakePagedDecoder()
    sched = _scheduler(dec)
    dec.begin_prefill(0, [1, 2, 3], stream_id="ghost")
    with sanitizer.expect_violations("gateway.scheduler.") as seen:
        found = sanitizer.quiesce_point(sched._quiesce_site)
    assert found, "leaked slot not reported at the quiesce point"
    assert any("quiesce_baseline" in v["detail"] for v in seen)
    dec.evict(0)
    assert sanitizer.quiesce_point(sched._quiesce_site) == []


def test_scheduler_quiesce_audit_silent_while_busy():
    dec = verify._FakePagedDecoder()
    sched = _scheduler(dec)
    sched.submit([1, 2, 3], 2)  # pending, never scheduled
    assert sanitizer.quiesce_point(sched._quiesce_site) == []


def test_kv_audit_trips_on_seeded_refcount_corruption():
    dec = verify._FakePagedDecoder()
    assert dec.kv.audit() == []
    dec.kv.refcount[1] = 5  # nobody maps page 1
    leaks = dec.kv.audit()
    assert leaks and any("refcount" in leak for leak in leaks)
    jdec = jax_verify._FakePagedDecoder()
    jdec.kv.refcount[1] = 5
    assert leaks == jdec.kv.audit()


def test_the_sim_builds_verifys_fake_decoder():
    """One ``_FakePagedDecoder`` in the port, as in the JAX package: the
    macro-sim's gateways build verify's (``sim/serving.py``)."""
    import inspect

    from learning_at_home_tpu_torch.sim import serving

    assert not hasattr(serving, "_FakePagedDecoder")
    assert "from learning_at_home_tpu_torch.analysis.verify import" in \
        inspect.getsource(serving.SimGateway.__init__)
    dec = verify._FakePagedDecoder()
    assert dec.kv.k_pools[0].device.type == "cpu"
