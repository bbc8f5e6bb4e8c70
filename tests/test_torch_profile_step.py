"""The port's ``experiments/profile_step.py`` against the JAX script, on
the CPU, and ``utils/profiling.device_trace``.

- ``--device cpu --batch 2 --no-stack`` with ``--optimizer fused``, and
  with ``--remat-policy dots --optimizer adafactor``: both take the JAX
  script's CPU branch (8 experts, f32 compute and params, 1 + 3 steps).
  The JAX script runs both cases in turn in ONE process of its own
  (``JAX_PLATFORMS=cpu``; its faulthandler deadline would end this one),
  pinned to JAX_CORES cores with XLA's intra-op threads capped, while
  the port runs here on PORT_THREADS threads: the file then loads a
  host about as much as a few ordinary test files, and so does not slow
  the timing tests that run beside it.  Its stderr ``variant:`` line must
  equal the port's character for character, its JSON line's keys the
  port's, and its loss the port's within LOSS_ATOL: both round to 4
  decimals (5e-5 each), and the two f32 inits draw the same values from
  one key, so what is left is summation order over 4 steps.  The port's
  run takes the JAX script's own draw of its params (saved by the JAX
  process, ``convert.params_from_jax``) in place of its key-stream
  draw, which ``test_torch_init_parity.py::
  test_pod_trunk_every_leaf_is_jax_draw`` holds within 2 f32 ulp of it:
  the port's threefry on a CPU takes minutes over the 88 M params,
  XLA's seconds.
- The refusal as arithmetic against an 80 GB card: 0.75 of it admits the
  bench recipe (bf16 params, batch 176) and refuses ``--no-remat --batch
  4096`` with exit code 2 before any model is built.
- ``device_trace`` writes a Chrome trace holding a small CPU matmul.
"""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from learning_at_home_tpu_torch.convert import params_from_jax
from learning_at_home_tpu_torch.experiments import profile_step
from learning_at_home_tpu_torch.models import transformer
from learning_at_home_tpu_torch.utils import sizing
from learning_at_home_tpu_torch.utils.profiling import device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "experiments", "profile_step.py")
# both scripts arm a faulthandler exit at --deadline: past the whole
# test run's, so that a loaded host slows a run without ending it
DEADLINE = ["--deadline", "1500"]
CASES = {
    "fused": ["--batch", "2", "--no-stack", "--optimizer", "fused",
              *DEADLINE],
    "dots-adafactor": ["--batch", "2", "--no-stack", "--remat-policy",
                       "dots", "--optimizer", "adafactor", *DEADLINE],
}
LOSS_ATOL = 2e-4
JAX_TIMEOUT_S = 1200
JAX_CORES = 2
PORT_THREADS = 2
CARD_BYTES = 80e9

# The JAX process: pins itself (before XLA makes its thread pools; a
# preexec_fn would run Python between fork and exec in this threaded
# process), saves the script's first draw of its params as a pickle of
# numpy arrays, runs each case's script with its own argv and streams,
# and prints {case: {"out": ..., "err": ...}}.
JAX_CHILD = """
import contextlib, io, json, os, pickle, runpy, sys
cores, script, draw_path, cases = json.loads(sys.argv[1])
os.sched_setaffinity(0, cores)
import jax
import numpy as np
from learning_at_home_tpu.models.transformer import DMoETransformerLM
init_params = DMoETransformerLM.init_params
def init_and_save(self, rng):
    params = init_params(self, rng)
    leaves = jax.tree_util.tree_leaves(params)
    traced = any(isinstance(l, jax.core.Tracer) for l in leaves)
    if not traced and not os.path.exists(draw_path):  # not eval_shape's
        with open(draw_path + ".tmp", "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
        os.replace(draw_path + ".tmp", draw_path)
    return params
DMoETransformerLM.init_params = init_and_save
class Captured(io.StringIO):
    def fileno(self):  # faulthandler's deadline writes to the real fd
        return sys.__stderr__.fileno()
runs = {}
for name, argv in cases.items():
    out, err = io.StringIO(), Captured()
    sys.argv = [script, *argv]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        runpy.run_path(script, run_name="__main__")
    runs[name] = {"out": out.getvalue(), "err": err.getvalue()}
print(json.dumps(runs))
"""


class JaxRuns:
    """The JAX process of both cases; its draw and its outputs."""

    def __init__(self, tmp_dir):
        self.draw_path = os.path.join(tmp_dir, "jax_draw.pkl")
        cores = sorted(os.sched_getaffinity(0))[:JAX_CORES]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        spec = json.dumps([cores, JAX_SCRIPT, self.draw_path, CASES])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_CHILD, spec], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._runs = self._draw = None

    def draw(self):
        """The JAX script's params for key 0, as numpy (both cases share
        their shapes: the per-layer tuple, f32, 8 experts)."""
        deadline = time.monotonic() + JAX_TIMEOUT_S
        while self._draw is None:
            if os.path.exists(self.draw_path):
                with open(self.draw_path, "rb") as f:
                    self._draw = pickle.load(f)
            elif self.proc.poll() is not None:
                self.runs()  # the process ended without a draw: its error
                raise AssertionError("the JAX process saved no draw")
            else:
                assert time.monotonic() < deadline, "no JAX draw"
                time.sleep(0.2)
        return self._draw

    def runs(self) -> dict:
        if self._runs is None:
            out, err = self.proc.communicate(timeout=JAX_TIMEOUT_S)
            assert self.proc.returncode == 0, err[-3000:]
            self._runs = json.loads(out.strip().splitlines()[-1])
        return self._runs

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = JaxRuns(str(tmp_path_factory.mktemp("profile_step_jax")))
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        yield runs
    finally:
        torch.set_num_threads(threads)
        runs.close()


def variant_line(stderr: str) -> str:
    lines = [line for line in stderr.splitlines()
             if line.startswith("variant:")]
    assert len(lines) == 1, stderr[-2000:]
    return lines[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_run_matches_the_jax_script(jax_runs, monkeypatch, capsys,
                                        case):
    draw = jax_runs.draw()

    def init_params(model, rng):
        assert int(rng[-1]) == 0  # PRNGKey(0)
        # a copy: the step updates its params in place
        tree = pickle.loads(pickle.dumps(draw))
        return params_from_jax(tree, model.cfg, device="cpu")

    monkeypatch.setattr(transformer.DMoETransformerLM, "init_params",
                        init_params)
    capsys.readouterr()
    got = profile_step.main([*CASES[case], "--device", "cpu"])
    out, err = capsys.readouterr()
    port_json = json.loads(out.strip().splitlines()[-1])
    assert {k: got[k] for k in port_json} == port_json

    jax_run = jax_runs.runs()[case]
    jax_json = json.loads(jax_run["out"].strip().splitlines()[-1])
    assert variant_line(err) == variant_line(jax_run["err"])
    assert sorted(port_json) == sorted(jax_json)
    for key in ("batch", "scan_layers", "remat", "remat_policy",
                "optimizer"):
        assert port_json[key] == jax_json[key], key
    assert abs(port_json["loss"] - jax_json["loss"]) <= LOSS_ATOL, \
        (port_json["loss"], jax_json["loss"])


def bench_recipe(batch: int, remat: bool = True):
    cfg = sizing.flagship_config(param_dtype=torch.bfloat16, remat=remat,
                                 scan_layers=False, stack_layers=False)
    return sizing.estimated_peak_bytes(
        cfg, profile_step.make_optimizer("fused"), batch)


def test_refusal_arithmetic_against_an_80gb_card(capsys):
    need = bench_recipe(176)
    assert need <= 0.75 * CARD_BYTES
    profile_step.check_budget(need, CARD_BYTES)  # admitted: returns
    need = bench_recipe(4096, remat=False)
    assert need > 0.75 * CARD_BYTES
    with pytest.raises(SystemExit) as exit_info:
        profile_step.check_budget(need, CARD_BYTES)
    assert exit_info.value.code == 2
    assert capsys.readouterr().err.startswith(
        f"REFUSED: estimated peak {need / 1e9:.1f} GB > budget 60.0 GB")


class Built(Exception):
    """Raised where the model would be built (params allocated)."""


def refuse_to_build(*args, **kwargs):
    raise Built


@pytest.mark.parametrize("argv,refused", [
    (["--no-remat", "--batch", "4096"], True),
    (["--no-stack", "--optimizer", "fused", "--batch", "176"], False),
])
def test_refusal_comes_before_any_allocation(monkeypatch, capsys, argv,
                                             refused):
    """On a card of 80 GB (its memory patched in; the device is never
    touched before the model is built) a refused variant exits 2 before
    the model exists; an admitted one prints its variant line and goes
    on to build it."""
    monkeypatch.setattr(sizing, "card_hbm_bytes", lambda device: CARD_BYTES)
    monkeypatch.setattr(transformer, "DMoETransformerLM", refuse_to_build)
    capsys.readouterr()
    if refused:
        with pytest.raises(SystemExit) as exit_info:
            profile_step.main([*argv, "--device", "cuda"])
        assert exit_info.value.code == 2
    else:
        with pytest.raises(Built):
            profile_step.main([*argv, "--device", "cuda"])
    err = capsys.readouterr().err
    assert err.startswith("REFUSED: ") == refused
    assert ("variant: " in err) == (not refused)


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.main(["--batch", "2"])


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with device_trace(str(tmp_path / "trace")) as path:
        b = a @ a
    assert b.shape == (64, 64)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in name for name in names), sorted(names)[:20]
