"""The swarm client of the port: ``RemoteExpert`` and
``RemoteMixtureOfExperts`` over the shared RPC loop, and the pipelined
swarm trainer (the JAX package's ``client/``)."""

from learning_at_home_tpu_torch.client.expert import RemoteExpert
from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.rpc import (
    client_loop,
    pool_registry,
    reset_client_rpc,
)
from learning_at_home_tpu_torch.client.trainer import PipelinedSwarmTrainer

__all__ = [
    "RemoteExpert",
    "RemoteMixtureOfExperts",
    "PipelinedSwarmTrainer",
    "client_loop",
    "pool_registry",
    "reset_client_rpc",
]
