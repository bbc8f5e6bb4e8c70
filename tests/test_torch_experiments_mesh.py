"""The port's ``train_lm --mode pod`` on a mesh of 4 ranks against the
JAX script on its virtual mesh.

The twin runs on 4 spawned ``gloo`` CPU ranks (``parallel/launch``, every
wait bounded), each calling ``main(argv)`` in its process group, which
lays out the JAX script's mesh ``{"data": 2, "expert": 2}``; the JAX
script runs in this process with ``jax.devices`` cut to 4, so it builds
the same mesh.  Both f32 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from learning_at_home_tpu_torch.parallel.launch import RankGroup

STEPS_RTOL = 1e-4

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def ranks():
    torch.set_num_threads(1)
    group = RankGroup(4, timeout_s=180.0, wait=False)
    yield lambda n: group
    group.close()


POD = ["--mode", "pod", "--d-model", "32", "--n-layers", "1",
       "--num-experts", "8", "--seq-len", "16", "--batch-size", "4",
       "--steps", "3", "--log-every", "1", "--optimizer", "adafactor",
       "--lr", "1e-3"]


def test_train_lm_pod_on_four_ranks_matches_the_jax_script(
        ranks, monkeypatch, capsys):
    """The twin on 4 gloo ranks (mesh {"data": 2, "expert": 2}) against
    the JAX script with ``jax.devices`` cut to 4 (the same mesh): every
    step's loss within the JAX line's rounding (4 decimals) plus 1e-4
    relative; the batch-divisibility error."""
    import json
    import sys

    from test_torch_experiments import jax_script

    module = jax_script("train_lm")
    devices = jax.devices()[:4]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *POD])
    capsys.readouterr()
    module.main()
    want = [json.loads(l)["loss"] for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    outs = ranks(4).run(R.train_lm_main, POD + ["--device", "cpu"])
    got = outs[0]["losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL, atol=5e-5)
    assert all(o["losses"] == got for o in outs)
    errs = ranks(4).run(R.raises, "train_lm_main",
                        POD[:-6] + ["--batch-size", "6", "--device", "cpu"])
    assert all(e is not None and "must be divisible" in e[1] for e in errs)
