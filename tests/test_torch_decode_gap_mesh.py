"""``decode_gap_eval`` on the expert mesh against the JAX script, on the
CPU.

The twin runs on 2 spawned ``gloo`` CPU ranks (``parallel/launch``, every
wait bounded), each calling ``main(argv)`` in its process group, which
lays out the JAX script's mesh ``{"expert": 2}``; the JAX script runs in
this process with ``jax.devices`` cut to 2, so it builds the same mesh.
Both train the expert-choice model (and the token-choice control) from
one key on the same batches (3 adamw steps, f32), each rank on its rows,
and evaluate it under the training routing and under the token-choice
decode fallback (``decode_model()`` on the mesh).  The report's keys are
the JAX script's; its numbers agree to the 4 decimals both print: 1e-4
absolute, one unit of that rounding (the f32 sums differ in order only).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from learning_at_home_tpu_torch.parallel.launch import RankGroup

ROUNDING = 1e-4
ARGV = ["--steps", "3", "--eval-batches", "2", "--batch-size", "4",
        "--seq-len", "16", "--d-model", "32", "--n-layers", "1",
        "--num-experts", "8"]

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def ranks():
    torch.set_num_threads(1)
    group = RankGroup(2, timeout_s=180.0, wait=False)
    yield group
    group.close()


def test_decode_gap_on_two_expert_ranks_matches_the_jax_script(
        ranks, monkeypatch, capsys):
    from test_torch_experiments import jax_script

    module = jax_script("decode_gap_eval")
    devices = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    monkeypatch.setattr(sys, "argv", ["decode_gap_eval.py", *ARGV])
    capsys.readouterr()
    module.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    outs = ranks.run(R.decode_gap_main, ARGV + ["--device", "cpu"])
    got = outs[0]
    assert all(o == got for o in outs)
    assert set(got) == set(want)
    assert "control_topk_eval_ce" in got
    for key, value in want.items():
        if isinstance(value, float):
            np.testing.assert_allclose(got[key], value, rtol=0,
                                       atol=ROUNDING, err_msg=key)
        else:
            assert got[key] == value, key


def test_batch_that_does_not_divide_the_mesh_is_refused(ranks):
    errs = ranks.run(R.raises, "decode_gap_main",
                     ARGV[:4] + ["--batch-size", "3", "--device", "cpu"])
    assert all(e is not None and e[0] == "SystemExit" and
               e[1] == "--batch-size 3 must divide across the 2 token "
                       "shards of the expert mesh" for e in errs)
