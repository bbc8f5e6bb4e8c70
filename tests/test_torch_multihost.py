"""The port's multi-process bring-up against the JAX package's.

The port of ``tests/test_multihost.py``: four real processes on localhost
join one ``torch.distributed`` job through ``initialize_multihost`` (TCP
rendezvous, ``gloo``, every wait bounded), lay themselves out on the JAX
worker's mesh ``{"data": 2, "expert": 2}``, pass their rows through
``host_local_array_to_global``, run one psum over the mesh and a
``ShardedMixtureOfExperts`` forward whose all-to-all crosses the process
boundary.  Every rank must report the same psum and the same global norm
of the MoE output, and that norm must be the JAX layer's on the same
mesh of virtual devices (f32, summation order only: 1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from learning_at_home_tpu.parallel import (
    ShardedMixtureOfExperts as JaxMoE,
    make_mesh as jax_make_mesh,
)
from learning_at_home_tpu_torch.parallel.launch import RankGroup

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_four_process_distributed_bringup():
    torch.set_num_threads(1)
    mesh = jax_make_mesh({"data": 2, "expert": 2}, devices=jax.devices()[:4])
    jmoe = JaxMoE(mesh, hidden_dim=4, num_experts=4, k=2, dtype=jnp.float32,
                  param_dtype=jnp.float32)
    params = jax.device_get(jmoe.init_params(jax.random.PRNGKey(0)))
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    jy, jaux = jax.jit(jmoe.__call__)(params, jnp.asarray(x))
    with RankGroup(4, timeout_s=120.0) as group:
        outs = group.run(R.multihost_bringup, params)
    assert [o[0] for o in outs] == [0, 1, 2, 3]
    assert all(o[1] == 4 for o in outs)
    expect = sum(8.0 * (i + 1) for i in range(4))  # 2x4 rows of (rank+1)
    assert all(abs(o[2] - expect) < 1e-5 for o in outs)
    norms = {o[3] for o in outs}
    assert len(norms) == 1, norms
    np.testing.assert_allclose(outs[0][3], float(jnp.linalg.norm(jy)),
                               rtol=1e-5)
    np.testing.assert_allclose(outs[0][4], float(jaux["aux_loss"]),
                               rtol=1e-5)


def test_a_rank_error_ends_the_call_with_its_traceback():
    """A rank that raises while its peers wait in a collective fails the
    call at once, naming the rank and its error, instead of leaving the
    caller to wait out the group's timeout; the group is closed."""
    import time

    group = RankGroup(2, timeout_s=120.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*rank one fails"):
        group.run(R.fail_on_rank_one)
    assert time.monotonic() - t0 < 60.0
    assert not group._procs  # killed with the group
