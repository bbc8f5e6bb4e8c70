"""DHT rendezvous for averaging groups: declare, discover, elect.

Trainers that want to average under a shared scope declare themselves
under ONE DHT key — the group prefix (default ``averaging.trunk``) —
with their peer id as the subkey and their averaging endpoint as the
value, TTL'd like expert heartbeats (expiry IS the failure detector;
dht/__init__.py).  Matchmaking is then coordination-light:

- every peer reads the key and sees the alive peer set;
- the DETERMINISTIC LEADER is the lexicographically smallest peer id —
  no extra election traffic, any consistent view agrees;
- followers send ``avg_join`` to the leader; the leader freezes a group
  (sorted members, capped at ``max_group_size``) once every expected
  peer joined or the gather window lapses with at least
  ``min_group_size`` members, and stamps it with its per-leader
  monotonically increasing **epoch** — a peer that knocks while a round
  is in flight is told to wait for the next epoch (late-joiner
  semantics, tested).

Group scoping doubles as topology-aware scheduling (TA-MoE / MoETuner):
the rendezvous key IS the group boundary, so locality-tiered prefixes
shard the reduce traffic without any protocol change.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)

Endpoint = tuple[str, int]


def declare_peer(
    dht, prefix: str, peer_id: str, endpoint: Endpoint, ttl: float
) -> bool:
    """Heartbeat this peer's averaging endpoint under the group key."""
    return bool(
        dht.store_sync(
            prefix, [endpoint[0], int(endpoint[1])], ttl, subkey=peer_id
        )
    )


def discover_peers(dht, prefix: str) -> dict[str, Endpoint]:
    """Alive peers under the group key: {peer_id: (host, port)}.
    Malformed peer-supplied values are skipped, like expert records."""
    out: dict[str, Endpoint] = {}
    for subkey, (value, _expiration) in dht.get_sync(prefix).items():
        if not isinstance(subkey, str) or not subkey:
            continue
        try:
            host, port = value[0], int(value[1])
        except (TypeError, ValueError, IndexError):
            continue
        if isinstance(host, str):
            out[subkey] = (host, port)
    return out


def elect_leader(peer_ids) -> Optional[str]:
    """Deterministic leader: the smallest peer id in any consistent view."""
    return min(peer_ids) if peer_ids else None


def expected_members(
    peers: dict[str, Endpoint], max_group_size: int
) -> list[str]:
    """The sorted membership a leader gathers toward: smallest
    ``max_group_size`` ids (always includes the leader — it IS the
    minimum).  Peers beyond the cap are told to wait for a later epoch."""
    return sorted(peers)[:max_group_size]
