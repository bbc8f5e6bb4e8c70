"""The port gate's cheap smokes for real on the CPU (``--device cpu``),
held against the JAX gate's: client path, averaging, codec and
telemetry (replication, lifecycle and the SLO trace are in
``test_torch_collect_gate_swarm.py``).

Each smoke runs alone in a process of its own (its timeout is the
test's) and must exit 0 and print the JAX smoke's marker line; the codec
smoke's wire reductions are fixed by the wire format, so the port's
``bytes /4.00`` and ``/3.87`` must be the JAX smoke's, run beside it.
"""

import importlib
import inspect
import os
import re
import subprocess
import sys

from learning_at_home_tpu_torch.tools import collect_gate as port_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jax_gate = importlib.import_module("tools.collect_gate")
JAX_MARKER_LINES = dict(
    (line.split()[0], line) for line in re.findall(
        r'print\(\s*"([A-Z_]+_OK [^"]*)"', inspect.getsource(jax_gate)))
MARKERS = {fn.__name__: marker for marker, fn in port_gate.SMOKES}


def run_alone(smoke: str, timeout: float = 150.0, gate: str = "port"):
    """One smoke function of one gate in a process of its own: (exit code,
    stdout lines, stderr)."""
    if gate == "port":
        code = ("import sys\nfrom learning_at_home_tpu_torch.tools import "
                f"collect_gate as g\nsys.exit(g.{smoke}('cpu'))\n")
        env = dict(os.environ)
    else:
        code = (f"import sys\nsys.path.insert(0, {REPO!r})\nfrom tools "
                f"import collect_gate as g\nsys.exit(g.{smoke}())\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return r.returncode, r.stdout.splitlines(), r.stderr


def passed(smoke: str, timeout: float = 150.0) -> list:
    """The port smoke's stdout lines after asserting it passed and printed
    the JAX smoke's marker line as its last."""
    rc, out, err = run_alone(smoke, timeout)
    assert rc == 0, "\n".join(out) + err[-3000:]
    assert out[-1] == JAX_MARKER_LINES[MARKERS[smoke]], out
    return out


def test_client_path_smoke():
    out = passed("client_path_smoke")
    assert out == ["client path: expert on cpu", "SMOKE_OK protocols=v1,v2"]


def test_averaging_smoke():
    out = passed("averaging_smoke")
    assert out == ["averaging: averaged tree on cpu", "AVG_SMOKE_OK rounds=1"]


def _codec_lines(out: list) -> dict:
    """codec -> (bytes reduction text, gradient cosine)."""
    got = {}
    for line in out:
        m = re.fullmatch(r"codec (\w+): bytes /([0-9.]+), grad_cosine "
                         r"([0-9.]+)", line)
        if m:
            got[m.group(1)] = (m.group(2), float(m.group(3)))
    return got


def test_codec_smoke_reduces_the_wire_as_the_jax_smoke():
    out = passed("codec_smoke")
    rc, jax_out, jax_err = run_alone("codec_smoke", gate="jax")
    assert rc == 0, jax_err[-3000:]
    port, jax = _codec_lines(out), _codec_lines(jax_out)
    assert sorted(port) == sorted(jax) == ["blockq8", "u8"]
    assert {c: r for c, (r, _) in port.items()} == {
        c: r for c, (r, _) in jax.items()} == {"u8": "4.00",
                                               "blockq8": "3.87"}
    assert all(cos >= 0.99 for _, cos in [*port.values(), *jax.values()])
    assert "codec: experts on cpu" in out


def test_telemetry_smoke():
    out = passed("telemetry_smoke")
    assert out == ["telemetry: expert on cpu",
                   "TELEMETRY_SMOKE_OK lah_top=dht-discovered"]
