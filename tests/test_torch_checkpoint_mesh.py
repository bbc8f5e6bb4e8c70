"""Sharded train-state checkpoints on a mesh of ranks: the counterpart of
``tests/test_checkpoint.py``'s orbax round trip, on spawned ``gloo`` CPU
ranks (``parallel/launch``, every wait bounded).

- Round trip: 4 ranks on ``{"data": 2, "expert": 2}`` save after one step
  (each rank its slices, a replicated slice once); a fresh model drawn
  from another key restores every slice bit for bit, and the next step's
  loss equals the uninterrupted one's (the same computation on the same
  bits).
- Another mesh: the step restored onto ``{"expert": 4}`` and onto no mesh
  (whole leaves) gives the same global leaves, bit for bit; a step saved
  by one process restores onto the mesh.
- Crash: a rank that dies before the barrier leaves its step without the
  marker, invisible to ``list_steps`` and never reused by ``next_step``.
- Resume against JAX: ``train_lm --mode pod --checkpoint-dir ...
  --resume`` on 4 ranks, 2 + 2 steps, against the JAX script (orbax) on
  its 4-device virtual mesh: the resumed loss lines within
  ``STEPS_RTOL`` = 1e-4 (``test_torch_experiments_mesh.py``'s bar) plus
  the JAX line's rounding; the port's resumed losses equal its
  uninterrupted run's bit for bit; ``generate_lm --checkpoint-dir`` on
  one device decodes the JAX script's greedy completion from each
  package's 4-way checkpoint.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from learning_at_home_tpu_torch.parallel.launch import RankGroup
from learning_at_home_tpu_torch.utils.checkpoint import (
    TrainCheckpointer,
    latest_step,
    list_steps,
    next_step,
    restore_pytree,
    save_pytree,
)

STEPS_RTOL = 1e-4
JAX_ROUNDING = 5e-5  # the JAX script prints losses to 4 decimals
KW = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4, seq_len=16,
          num_experts=8, k=2, dtype=torch.float32)
SAVED_ON = {"data": 2, "expert": 2}

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def ranks():
    torch.set_num_threads(1)
    group = RankGroup(4, timeout_s=180.0, wait=False)
    yield group
    group.close()


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 64, (8, 16)).astype(np.int32),
            rs.randint(0, 64, (8, 16)).astype(np.int32))


def _by_path(tree, prefix=""):
    """{path: leaf} of a tree of dicts and tuples (a tuple's items, named
    or not, by index): comparable across container types and key
    orders."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_by_path(val, f"{prefix}{key}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, val in enumerate(tree):
            out.update(_by_path(val, f"{prefix}{i}/"))
        return out
    return {prefix: np.asarray(tree)}


def _global(outs, axes):
    """Each item's {path: global leaf} from the ranks' slices."""
    out = {}
    for name, spec in (("params", "param_specs"),
                       ("opt_state", "state_specs")):
        leaves = R.assemble([o[name] for o in outs], outs[0][spec], axes)
        paths = list(_by_path(outs[0][name]))
        out[name] = dict(zip(paths, leaves))
    return out


def _assert_same(got, want, what):
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), (what, name)
        for path, b in want[name].items():
            a = got[name][path]
            assert a.dtype == b.dtype and a.shape == b.shape, \
                (what, name, path)
            assert a.tobytes() == b.tobytes(), (what, name, path)


@pytest.fixture(scope="module")
def saved(ranks, tmp_path_factory):
    """(root, the ranks' round-trip results, the saved global leaves) of
    an adafactor run (factored statistics kept whole on every rank)."""
    root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    ids, tgt = _batch()
    outs = ranks.run(R.ckpt_round_trip, root, SAVED_ON, KW, "adafactor",
                     ids, tgt)
    return root, outs, _global(outs, SAVED_ON)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_round_trip_on_data_2_expert_2(ranks, saved, tmp_path, opt_name):
    if opt_name == "adafactor":
        root, outs, _ = saved
    else:
        root = str(tmp_path / "ckpt")
        ids, tgt = _batch()
        outs = ranks.run(R.ckpt_round_trip, root, SAVED_ON, KW, opt_name,
                         ids, tgt)
    assert latest_step(root) == 1
    for rank, out in enumerate(outs):
        assert out["step"] == 1
        assert out["same"] and all(out["same"]), rank
        assert out["loss_resumed"] == out["loss_orig"], rank
    item = os.path.join(root, "step_000000001", "params")
    assert sorted(os.listdir(item)) == [
        "shard_00000", "shard_00001", "shard_00002", "shard_00003",
        "tree.json"]
    with open(os.path.join(item, "tree.json")) as f:
        paths = json.load(f)["paths"]

    def written(rank):
        files = os.listdir(os.path.join(item, f"shard_{rank:05d}"))
        return {paths[int(name[:-4])] for name in files}

    # a replicated leaf is written once: by rank 0, not by its replicas
    for name in ("embed", "layers/moe/gate"):
        assert name in written(0) and name not in written(1)
    # the expert stacks: one slice per expert rank, none per data rank
    for name in ("w1", "b1", "w2", "b2"):
        assert f"layers/moe/{name}" in written(0)
        assert f"layers/moe/{name}" in written(1)
    assert not written(2)  # rank 2 = data 1, expert 0: a replica of 0's
    with open(os.path.join(root, "step_000000001", "params",
                           "tree.json")) as f:
        meta = json.load(f)
    assert meta["mesh"] == SAVED_ON
    w1 = meta["paths"].index("layers/moe/w1")
    assert meta["specs"][w1][:2] == [None, "expert"]
    assert meta["shapes"][w1][1] == KW["num_experts"]


def test_restore_onto_another_mesh_and_onto_one_process(ranks, saved,
                                                        tmp_path):
    root, _, want = saved
    outs = ranks.run(R.ckpt_restore, root, {"expert": 4}, KW, "adafactor")
    assert all(o["step"] == 1 for o in outs)
    _assert_same(_global(outs, {"expert": 4}), want, "expert 4")
    whole = {name: _by_path(restore_pytree(root, 1, name))
             for name in ("params", "opt_state")}
    _assert_same(whole, want, "no mesh")
    # a step one process wrote (whole leaves) restores onto the mesh
    one = str(tmp_path / "one")
    for name in ("params", "opt_state"):
        save_pytree(one, 3, name, restore_pytree(root, 1, name))
    from learning_at_home_tpu_torch.utils.checkpoint import mark_step_complete

    mark_step_complete(one, 3)
    outs = ranks.run(R.ckpt_restore, one, SAVED_ON, KW, "adafactor")
    assert all(o["step"] == 3 for o in outs)
    _assert_same(_global(outs, SAVED_ON), want, "whole onto the mesh")


def test_a_rank_dying_before_the_marker_leaves_the_step_invisible(tmp_path):
    root = str(tmp_path / "crash")
    with RankGroup(2, timeout_s=60.0) as group:
        with pytest.raises(RuntimeError, match="rank 1"):
            group.run(R.ckpt_dies_before_the_marker, root, {"expert": 2},
                      KW, 1)
    step_dir = os.path.join(root, "step_000000001")
    assert os.path.isdir(step_dir)
    assert not os.path.exists(os.path.join(step_dir, ".complete"))
    assert list_steps(root) == [] and latest_step(root) is None
    assert list_steps(root, only_complete=False) == [1]
    assert next_step(root) == 2
    assert TrainCheckpointer(root).restore_latest({}, {}) is None


POD = ["--mode", "pod", "--d-model", "32", "--n-layers", "1",
       "--num-experts", "8", "--seq-len", "16", "--batch-size", "4",
       "--log-every", "1", "--optimizer", "adafactor", "--lr", "1e-3"]


def test_train_lm_resume_on_four_ranks_matches_the_jax_script(
        ranks, monkeypatch, capsys, tmp_path):
    from test_torch_experiments import jax_script

    module = jax_script("train_lm")
    devices = jax.devices()[:4]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    jdir = str(tmp_path / "jax")
    want = []
    for argv in (["--steps", "2"], ["--steps", "4", "--resume"]):
        monkeypatch.setattr(sys, "argv", ["train_lm.py", *POD, *argv,
                                          "--checkpoint-dir", jdir])
        capsys.readouterr()
        module.main()
        text = capsys.readouterr().out
        want.append([json.loads(l)["loss"] for l in text.splitlines()
                     if l.startswith("{")])
    assert "# resumed from step 2" in text
    tdir = str(tmp_path / "port")
    first = ranks.run(R.train_lm_main, POD + ["--steps", "2", "--device",
                                              "cpu", "--checkpoint-dir",
                                              tdir])
    assert list_steps(tdir) == [2]
    resumed = ranks.run(R.train_lm_main, POD + [
        "--steps", "4", "--resume", "--device", "cpu",
        "--checkpoint-dir", tdir])
    assert list_steps(tdir) == [2, 4]
    straight = ranks.run(R.train_lm_main, POD + ["--steps", "4", "--device",
                                                 "cpu"])
    got = [first[0]["losses"], resumed[0]["losses"]]
    assert [len(g) for g in got] == [len(w) for w in want] == [2, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=STEPS_RTOL, atol=JAX_ROUNDING)
    assert all(o["losses"] == got[1] for o in resumed)
    assert got[0] + got[1] == straight[0]["losses"]

    # generate_lm decodes from each package's 4-way checkpoint on one
    # device: the same greedy completion
    gen = ["--seq-len", "16", "--d-model", "32", "--n-layers", "1",
           "--num-experts", "8", "--prompt", "the ", "--max-new-tokens", "6"]
    jgen = jax_script("generate_lm")
    monkeypatch.setattr(sys, "argv", ["generate_lm.py", *gen,
                                      "--checkpoint-dir", jdir])
    capsys.readouterr()
    jgen.main()
    want_text = capsys.readouterr().out.strip().splitlines()[-1]
    from learning_at_home_tpu_torch.experiments import generate_lm

    out = generate_lm.main(gen + ["--checkpoint-dir", tdir, "--device",
                                  "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want_text
    assert out["tokens"].shape == (1, 4 + 6)
