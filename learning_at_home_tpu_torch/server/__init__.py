"""The swarm expert server of the port: experts, their batching, the
device runtime, the wire handler, the DHT heartbeat and the elastic
lifecycle: drain, handoff, migration and replicas (the JAX
package's ``server/``; ``python -m learning_at_home_tpu_torch.server`` is
its CLI)."""

from learning_at_home_tpu_torch.server.chaos import ChaosConfig, ChaosInjector
from learning_at_home_tpu_torch.server.expert_backend import ExpertBackend
from learning_at_home_tpu_torch.server.runtime import Runtime
from learning_at_home_tpu_torch.server.server import Server, background_server
from learning_at_home_tpu_torch.server.staging import StagingBuffers
from learning_at_home_tpu_torch.server.task_pool import (
    BatchJob,
    TaskPool,
    bucket_rows,
)

__all__ = [
    "ExpertBackend",
    "TaskPool",
    "BatchJob",
    "bucket_rows",
    "Runtime",
    "StagingBuffers",
    "ChaosConfig",
    "ChaosInjector",
    "Server",
    "background_server",
]
