"""The port gate's smokes that build a swarm, for real on the CPU
(``--device cpu``): replication (a replica installed by
``Server.add_replica``, then the primary killed: the hedge rescues the
dispatch), lifecycle (a drain mid-dispatch, the experts migrated
bitwise) and the SLO trace (a gateway driven to PAGE, one traced stream
end to end).  Each runs alone in a process of its own (its timeout is
the test's) and must exit 0 and print the JAX smoke's marker line and
numbers line.

The whole gate, ``python -m learning_at_home_tpu_torch.tools.collect_gate
--device cpu``, is the one ``slow`` test: all twelve smokes take ~3.5
min on an 8-core CPU (the churn harness ~80 s, the DHT and macro sims
~45 s) besides the stages, and its overlap A/B asserts a wall-clock win
that a loaded tier-1 worker makes unsteady.
"""

import os
import re
import subprocess
import sys

import pytest

from test_torch_collect_gate_smokes import passed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_replication_smoke():
    out = passed("replication_smoke")
    m = re.fullmatch(r"replication: replica_set=2 hedge_wins=(\d+) "
                     r"fires=(\d+) dropped=0 \(replica on cpu\)", out[-2])
    assert m and int(m.group(1)) >= 1, out


def test_lifecycle_smoke():
    out = passed("lifecycle_smoke")
    assert out[-2] == ("lifecycle: drained=2 experts migrated bitwise, "
                       "failed_dispatches=0 dropped=0 (experts on cpu)")


def test_slo_trace_smoke():
    out = passed("slo_trace_smoke")
    assert re.fullmatch(
        r"slo_trace: \d+ streams all past the 1 µs objective, "
        r"fast_burn=\d+, artifact=flight_slo_page_gateway_ttft_\S+\.json, "
        r"\d+ spans on trace [0-9a-f]+ \(decoder on cpu, experts on cpu\)",
        out[-2]), out


@pytest.mark.slow
def test_the_whole_gate_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "learning_at_home_tpu_torch.tools."
         "collect_gate", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert out[0].startswith("collect_gate: lint OK — 0 findings")
    assert out[1].startswith("collect_gate: verify OK — lah-verify: 0 "
                             "violation(s)")
    assert out[2].startswith("collect_gate: schema OK — 19 documented ops "
                             "covered; lah-fuzz: OK")
    assert out[3:5] == [
        "collect_gate: placement OK (skewed) — byte-identical plan, 3 "
        "move(s), cost 215.375 -> 47.415",
        "collect_gate: placement OK (capacity-locked swap) — byte-identical "
        "plan, 2 move(s), cost 70.0 -> 0.0"]
    assert re.fullmatch(r"collect_gate: OK — \d+ tests collected in .*s",
                        out[5]), out
    # run_smoke printed this after finding all twelve markers
    assert out[6:] == ["collect_gate: OK — SLO_TRACE_SMOKE_OK "
                       "page=burn-rate trace=stream-lifecycle"]
