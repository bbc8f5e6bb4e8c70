"""Decentralized parameter averaging: DHT-matched, fault-tolerant group
all-reduce for the TRAINER-side (trunk + gating) state.

The port of ``learning_at_home_tpu/averaging/``: the same wire, DHT keys,
matchmaking and reduction, so torch and JAX trainers (and replica
servers) average in one group; the trees are the port's, flattened in
``jax.tree.flatten``'s leaf order (``partitioning.py``).

The reference pairs server-side async expert SGD with trainer-side
synchronization of the shared parameters (SURVEY.md §async); our
multi-trainer async-DP mode ran each trainer's trunk/gate state fully
independently — they silently diverged and only the experts learned
jointly.  This subsystem closes that gap with a
``DecentralizedAverager``-style group all-reduce over the existing stack:

- **matchmaking** rides the DHT: each trainer declares an
  ``averaging.<prefix>`` key with a TTL, peers rendezvous by key, the
  lowest peer id is the deterministic leader, and an epoch counter makes
  late joiners wait for the next round (`matchmaking.py`);
- **reduction** is a chunked butterfly all-reduce (reduce-scatter +
  all-gather: member *i* of a sorted group owns partition *i*, averages
  every member's slice of it once, and distributes the identical bytes
  back), with each partition chunk riding the protocol-v2 mux transport
  as pack-once `WireTensors` frames (`averager.py`, `handler.py`);
- **fault tolerance**: per-part timeouts with
  ``QUORUM_STRAGGLER_CANCEL``-marked cancels; a member dying mid-round
  degrades the group to the survivors (re-weighted mean over whoever
  actually contributed) — a round can end degraded, never hung;
- **integration**: :class:`AveragingSession` snapshots trunk+gate
  pytrees between local steps (delayed-update tolerant), applies the
  group mean atomically, and exposes ``averaging_stats()``
  (`session.py`; wired into ``client/trainer.py`` and
  ``experiments/train_lm.py --averaging``).

Topology-aware grouping (TA-MoE arXiv 2302.09915, MoETuner arXiv
2502.06643) motivates keeping matchmaking pluggable: group membership is
whatever the rendezvous key prefix scopes, so locality-tiered prefixes
(``averaging.trunk.<rack>``) shard reduce traffic without code changes.
"""

from learning_at_home_tpu_torch.averaging.averager import (
    AveragingConfig,
    AveragingFailed,
    DecentralizedAverager,
)
from learning_at_home_tpu_torch.averaging.session import AveragingSession

__all__ = [
    "AveragingConfig",
    "AveragingFailed",
    "AveragingSession",
    "DecentralizedAverager",
]
