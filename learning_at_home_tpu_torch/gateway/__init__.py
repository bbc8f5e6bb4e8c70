"""Serving gateway: continuous batching + cross-user expert-set
coalescing + admission control over the swarm dispatch path (the JAX
package's gateway, its wire and its exports, in torch).

See docs/PROTOCOL.md ("Gateway RPC family"), docs/CONCURRENCY.md (slot
table ownership) and README.md (serving quick-start).
"""

from learning_at_home_tpu_torch.gateway.admission import AdmissionController
from learning_at_home_tpu_torch.gateway.coalesce import ExpertCoalescer
from learning_at_home_tpu_torch.gateway.frontdoor import Gateway, GatewayClient
from learning_at_home_tpu_torch.gateway.scheduler import SlotScheduler, StreamState
from learning_at_home_tpu_torch.models.kv_pages import PagedKVCache, PagePressure

__all__ = [
    "AdmissionController",
    "ExpertCoalescer",
    "Gateway",
    "GatewayClient",
    "PagePressure",
    "PagedKVCache",
    "SlotScheduler",
    "StreamState",
]
