"""Multi-process bring-up for the pod tier on many cards.

The counterpart of ``learning_at_home_tpu/parallel/multihost.py``.  JAX
joins every process to one device set with ``jax.distributed.initialize``;
here every process is one rank of a ``torch.distributed`` job, one card
each (``nccl``) or sharing cards or the CPU (``gloo``), and
``parallel/mesh.make_mesh`` lays the ranks out on named axes.

Typical launch (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``MASTER_ADDR``/``MASTER_PORT``; elsewhere pass them)::

    initialize_multihost("10.0.0.1:9999", num_processes=8, process_id=i,
                         backend="nccl")
    mesh = make_mesh({"data": 2, "expert": 4})
    ids = host_local_array_to_global(ids_local, mesh, global_shape=(64, 256))
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from learning_at_home_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    shard_slices,
)

# how long a collective may wait for its peers before the job fails
DEFAULT_TIMEOUT_S = 600.0


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join this process to the job as rank ``process_id`` of
    ``num_processes``, rendezvousing over TCP at ``coordinator_address``
    (``host:port``; rank 0 listens there).  Call once per process before
    building a mesh.  ``backend`` is ``nccl`` (one rank per card) or
    ``gloo`` (the CPU, or ranks that share a card).  The rank's card is
    ``local_device_ids[0]`` when given, else ``LOCAL_RANK``'s."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if local_device_ids:
        os.environ["LOCAL_RANK"] = str(int(local_device_ids[0]))
    if backend == "nccl" or (local_device_ids and torch.cuda.is_available()):
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def host_local_array_to_global(local_batch, mesh: Mesh,
                               global_shape=None, spec=None) -> torch.Tensor:
    """This process's part of a batch laid out by ``spec`` (default
    :func:`batch_sharding`, the layout the train step expects), as the
    rank's local tensor.  JAX assembles one global array from every
    process's rows; here each rank keeps its own shard, so the call checks
    what JAX's assembly checks: given the batch's ``global_shape``, that
    the rows (and, with a ``seq`` axis, the columns) this process passes
    are exactly its shard's."""
    local = torch.as_tensor(local_batch)
    spec = batch_sharding(mesh) if spec is None else tuple(spec)
    if global_shape is not None:
        want = tuple(sl.stop - sl.start
                     for sl in shard_slices(global_shape, spec, mesh))
        if tuple(local.shape) != want:
            raise ValueError(
                f"a local batch of shape {tuple(local.shape)} is not rank "
                f"{mesh.rank}'s shard {want} of a global "
                f"{tuple(global_shape)} batch under {spec}")
    return local
