"""The port's checkpoints (``utils/checkpoint.py``, no orbax) and the
server's save/restore: the JAX package's layout (``step_XXXXXXXXX/<name>``
directories, the ``.complete`` marker written last) and semantics
(``list_steps``/``latest_step``/``next_step``, ``prune_old_steps``,
``CheckpointManager`` with its restart counter), with numpy arrays by
tree path on disk and no pickle.  Values restore bit for bit."""

import json
import os
from collections import OrderedDict

import ml_dtypes
import numpy as np
import pytest
import torch

from learning_at_home_tpu.utils import checkpoint as jax_checkpoint
from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch.utils import checkpoint as ckpt
from learning_at_home_tpu_torch.server.server import Server
from learning_at_home_tpu_torch.utils.nested import nested_flatten


def _tree(rng):
    return {
        "params": {"Dense_0": {"kernel": rng.standard_normal((3, 4))
                               .astype(np.float32),
                               "bias": np.zeros(4, np.float32)}},
        "opt_state": (optim.ScaleByAdamState(
            count=np.int32(3), mu={"a": np.ones(2, np.float32)},
            nu={"a": np.full(2, 0.5, np.float32)}), optim.EmptyState()),
        "update_count": 3,
        "bf": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
        "od": OrderedDict([("z", np.arange(3)), ("a", np.arange(2))]),
        "none": None,
    }


def test_save_restore_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    root = str(tmp_path)
    path = ckpt.save_pytree(root, 1, "e.0", tree)
    assert path == os.path.join(root, "step_000000001", "e.0")
    assert sorted(os.listdir(path)) == ["arrays.npz", "tree.json"]
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as z:
        assert "params/Dense_0/kernel" in z.files
        assert "opt_state/0/count" in z.files
    # with a template: the containers' own types, ints back as ints
    back = ckpt.restore_pytree(root, 1, "e.0", like=tree)
    assert type(back["opt_state"][0]) is optim.ScaleByAdamState
    assert back["opt_state"][1] == optim.EmptyState()
    assert back["update_count"] == 3 and isinstance(back["update_count"], int)
    assert back["none"] is None
    assert list(back["od"]) == ["z", "a"]
    for a, b in zip(nested_flatten(back), nested_flatten(tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # without: plain containers from the schema
    plain = ckpt.restore_pytree(root, 1, "e.0")
    np.testing.assert_array_equal(plain["params"]["Dense_0"]["kernel"],
                                  tree["params"]["Dense_0"]["kernel"])
    assert plain["bf"].dtype == ml_dtypes.bfloat16
    with open(os.path.join(path, "tree.json")) as f:
        assert json.load(f)["dtypes"][0] == "bfloat16"


def test_restore_refuses_a_mismatched_template(tmp_path):
    ckpt.save_pytree(str(tmp_path), 1, "x", {"a": np.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_pytree(str(tmp_path), 1, "x",
                            like={"a": np.zeros(2), "b": np.zeros(1)})


def test_step_bookkeeping_matches_the_jax_package(tmp_path):
    """Same directory names, markers, listing, next step and pruning as
    the JAX package's module on the same history (incomplete steps
    included)."""
    roots = {m: str(tmp_path / m.__name__.split(".")[0]) for m in
             (ckpt, jax_checkpoint)}
    for mod, root in roots.items():
        for step in (1, 2, 3, 5):
            os.makedirs(os.path.join(root, f"step_{step:09d}", "item"))
            if step != 3:
                mod.mark_step_complete(root, step)
        os.makedirs(os.path.join(root, "step_000000007"))  # crashed save
    listings = {m: (m.list_steps(r), m.list_steps(r, only_complete=False),
                    m.latest_step(r), m.next_step(r))
                for m, r in roots.items()}
    assert listings[ckpt] == listings[jax_checkpoint]
    assert listings[ckpt] == ([1, 2, 5], [1, 2, 3, 5, 7], 5, 8)
    for mod, root in roots.items():
        mod.prune_old_steps(root, keep_last=2)
    assert sorted(os.listdir(roots[ckpt])) == \
        sorted(os.listdir(roots[jax_checkpoint])) == \
        ["step_000000002", "step_000000005", "step_000000007"]
    assert ckpt.list_steps(str(tmp_path / "missing")) == []
    assert ckpt.next_step(str(tmp_path / "missing")) == 1


def test_checkpoint_manager_saves_prunes_and_counts_restarts(tmp_path):
    root = str(tmp_path)
    mgr = ckpt.CheckpointManager(root, keep_last=2)

    def save(step):
        ckpt.save_pytree(root, step, "x", {"v": np.full(2, step)})
        ckpt.mark_step_complete(root, step)

    assert [mgr.save_now(save) for _ in range(4)] == [1, 2, 3, 4]
    assert ckpt.list_steps(root) == [3, 4] and mgr.saves == 4

    def broken(step):
        raise OSError("disk full")

    assert mgr.save_now(broken) is None and mgr.save_failures == 1
    assert mgr.latest_step() == 4 and mgr.next_step() == 5
    assert mgr.restart_count() == 0
    assert mgr.record_restart() == 1
    assert ckpt.CheckpointManager(root).record_restart() == 2
    mgr.start_periodic(save, every_s=0)  # a non-positive period: no thread
    assert mgr._thread is None
    mgr.stop()


def test_server_save_and_load_checkpoint(tmp_path):
    root = str(tmp_path)
    srv = Server.create(num_experts=2, hidden_dim=8, expert_prefix="c",
                        optimizer=optim.adam(1e-2), device="cpu",
                        start=False)
    rng = np.random.default_rng(1)
    for b in srv.experts.values():
        b.backward([rng.standard_normal((4, 8)).astype(np.float32)],
                   [rng.standard_normal((4, 8)).astype(np.float32)])
    snap = {u: b.state_dict() for u, b in srv.experts.items()}
    step = srv.save_checkpoint(root)
    assert step == 1 and ckpt.list_steps(root) == [1]
    assert sorted(os.listdir(os.path.join(root, "step_000000001"))) == \
        [".complete", "c.0", "c.1"]
    for b in srv.experts.values():  # move on, then come back
        b.backward([rng.standard_normal((4, 8)).astype(np.float32)],
                   [rng.standard_normal((4, 8)).astype(np.float32)])
    fresh = Server.create(num_experts=2, hidden_dim=8, expert_prefix="c",
                          optimizer=optim.adam(1e-2), device="cpu",
                          start=False, seed=99)
    assert fresh.load_checkpoint(root) == 1
    for uid, b in fresh.experts.items():
        assert b.update_count == 1
        got = b.state_dict()
        assert type(b.opt_state[0]) is optim.ScaleByAdamState
        assert b.opt_state[0].count.dtype == torch.int32
        for x, y in zip(nested_flatten(got), nested_flatten(snap[uid])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert srv.save_checkpoint(root) == 2
    empty = Server({})
    assert empty.save_checkpoint(root) == 3  # skipped: nothing to save
    assert ckpt.list_steps(root) == [1, 2]
    with pytest.raises(FileNotFoundError):
        fresh.load_checkpoint(str(tmp_path / "none"))
    for s in (srv, fresh, empty):
        s.shutdown()
